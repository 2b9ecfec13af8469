"""The harness end to end on a tiny graph with the port's plain path: the
result line, the comparison that decides ``correct``, its control and the
faults it has to catch."""
import json
import re

import pytest
import torch

from partbench import control, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(cell, trace=False, **kw):
    return harness.execute(cell, 2**31 + 11, 0.5, trace, device="cpu", **kw)


@pytest.mark.parametrize("name", ["ok-k8.spinner", "ok-k8.restream"])
def test_result_line(tiny_cell, name, capsys):
    cell = tiny_cell(name)
    res = run(cell)
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end} - {"peak_device_gb"}
    for name_, m in res["metrics"].items():
        assert NAME.match(name_) and UNIT.match(m["unit"]) and m["value"] == m["value"]
    assert res["device"]["platform"] == "cpu" and res["device"]["count"] == 1
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)
    out = capsys.readouterr().out.strip().splitlines()
    assert all(json.loads(line) for line in out)


def test_traced_result_line(tiny_cell):
    cell = tiny_cell("ok-k8.spinner")
    res = run(cell, trace=True)
    assert res["correct"] is True
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device on the CPU: the readers of device numbers return nothing
    assert "device_idle.spinner" not in res["metrics"] and "k3_roofline" not in res["metrics"]
    assert res["metrics"]["supersteps_per_job.spinner"]["value"] > 0


def test_revolver_followed_exactly(tiny_cell):
    cell = tiny_cell("ok-k8.revolver", max_steps=6)
    res = run(cell)
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["step_labels"]["value"] == 0
    assert res["checks"]["step_probs"]["value"] <= 1e-6


@pytest.mark.parametrize("name,max_steps", [("ok-k8.revolver", 6), ("ok-k8.spinner", None),
                                            ("ok-k8.restream", None)])
def test_control_is_not_correct(tiny_cell, name, max_steps):
    """The reference at bfloat16 in the program's place fails a number."""
    cell = tiny_cell(name, max_steps=max_steps)
    res = run(cell, states_hook=harness.control_hook(cell, torch.bfloat16))
    assert res["correct"] is False
    assert res["checks"]["step_labels"]["value"] > res["checks"]["step_labels"]["limit"]


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
@pytest.mark.parametrize("name", ["ok-k8.spinner", "ok-k8.restream"])
def test_fault_is_not_correct(tiny_cell, name, fault):
    """A superstep that returns its state unchanged, leaves half of the
    vertices out, or alters an answer where it is made, and a start that
    leaves half of the vertices out: each run is not correct. (One card
    runs one process; there is no exchange between chips to leave out.)"""
    cell = tiny_cell(name)
    with control.planted(fault):
        res = run(cell)
    assert res["correct"] is False
    failed = {x for x, c in res["checks"].items() if c["value"] > c["limit"]}
    assert failed & ({"start_z"} if fault == "start" else {"step_labels"})


def test_fault_planted_in_revolver(tiny_cell):
    cell = tiny_cell("ok-k8.revolver", max_steps=6)
    with control.planted("half"):
        res = run(cell)
    assert res["correct"] is False
    assert res["checks"]["step_probs"]["value"] > res["checks"]["step_probs"]["limit"]


def test_control_readings_summary(tiny_cell):
    cell = tiny_cell("ok-k8.restream")
    rows = list(control.readings(cell, 5, 2, 1, device="cpu"))
    summary = control.summarize(rows)
    assert summary["program"]["step_labels"] == [0, 0]
    assert summary["control"]["step_labels"][0] > 0
    assert {f"fault:{name}" for name in control.FAULTS} <= set(summary)
    assert summary["fault:start"]["start_z"][0] > 6


def test_derive_is_stable_and_wide():
    assert harness.derive(2**33 + 1, "job", 3) == harness.derive(2**33 + 1, "job", 3)
    assert harness.derive(1, "job", 3) != harness.derive(1, "job", 4)
    assert 0 <= harness.derive(2**62, "graph") < 2**63
