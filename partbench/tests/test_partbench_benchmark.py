"""BENCHMARK.json against the benchmark's contract, and every file it names."""
import json
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def one_line(text, most=200):
    return isinstance(text, str) and 1 <= len(text) <= most and "\n" not in text \
        and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "partbench/run.py"]
    assert BENCH["paths"] == ["partbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_the_check_fits_its_time_with_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert all(NAME.match(n) for n in names), names
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert one_line(config["source"]) and one_line(config["why"])
    assert config["file"].startswith("partbench/")
    body = json.loads((ROOT / config["file"]).read_text())
    assert body["name"] == config["name"]
    assert body["reduced"] == config["reduced"] == []
    assert body["assumed"]
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_workloads(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and one_line(cell["why"])
    assert NAME.match(cell["traffic"]) and NAME.match(cell["config"])
    assert (ROOT / "partbench" / "traffic" / f"{cell['traffic']}.json").is_file()
    limits = json.loads((ROOT / "partbench" / "cells" / f"{cell['name']}.json").read_text())
    assert limits["limits"]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert pairs.count((cell["config"], cell["traffic"])) == 1


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metrics(metric):
    keys = {"name", "unit", "better", "source"}
    if metric in BENCH["end_to_end"]:
        keys.add("bound")
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert one_line(metric["layer"])
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert set(metric) - {"workloads"} == keys
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for cell in metric.get("workloads", []):
        assert cell in {w["name"] for w in BENCH["workloads"]}
    assert (ROOT / "partbench" / "metrics" / f"{metric['name']}.py").is_file()


def test_setup_and_every_cell_covered():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for cell in BENCH["workloads"]:
        names = [m["name"] for m in BENCH["end_to_end"]
                 if cell["name"] in m.get("workloads", [cell["name"]])]
        assert "setup_s" in names and len(names) >= 2
        assert any(cell["name"] in m.get("workloads", [cell["name"]])
                   for m in BENCH["per_layer"])


def test_layers_are_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values()), by_layer
