"""Test set-up of the benchmark's own tests: the repository root and its
``src`` on the import path, the ``chip`` marker for tests that need an
NVIDIA GPU, and a tiny copy of a cell for CPU runs."""
import copy
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA GPU (CUDA); skipped where there is none")


@pytest.fixture
def cuda_device():
    """The first CUDA device, or a skip where there is none (decided here,
    never when the module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); this machine has none")
    return torch.device("cuda")


# a graph of the cells' family small enough for the port's plain path on a
# CPU: about 800 vertices, 16,000 slab entries
TINY_GRAPH = dict(n=800, m=8000, n_comm=4)


# files of mixes the tests run that BENCHMARK.json has no cell for yet
# (restream's rule settings and limits)
DATA = pathlib.Path(__file__).resolve().parent / "data"


def any_cell(name):
    """Cell ``<config>.<traffic>`` from its files under ``partbench/`` or,
    for a mix no cell of BENCHMARK.json runs yet, under `DATA`."""
    from partbench import harness

    config, traffic = name.split(".")
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.cell_from_files(name, config, traffic, bench, root=ROOT) \
        if (ROOT / "partbench" / "cells" / f"{name}.json").exists() else None
    if cell is None:
        cell = harness.Cell(
            name, harness.load_json(ROOT / "partbench" / "configs" / f"{config}.json"),
            harness.load_json(DATA / "traffic" / f"{traffic}.json"),
            harness.load_json(DATA / "cells" / f"{name}.json")["limits"],
            [m for m in bench["end_to_end"] if "workloads" not in m],
            [m for m in bench["per_layer"] if "workloads" not in m])
    return cell


@pytest.fixture
def cell_named():
    """`any_cell`, for tests that run a cell at its own size."""
    return any_cell


@pytest.fixture
def tiny_cell():
    """``tiny_cell(name, max_steps=None)``: the cell of that name with its
    graph shrunk to `TINY_GRAPH` (and, for Revolver's many small steps on
    the CPU, its jobs capped at ``max_steps`` supersteps)."""
    from partbench import harness

    def make(name, max_steps=None):
        cell = copy.deepcopy(any_cell(name))
        cell.config["graph"].update(TINY_GRAPH)
        if max_steps is not None:
            cell.traffic["rule"]["max_steps"] = max_steps
            # a job cut off after a few supersteps has not converged: it is
            # held to beating a random partition's locality, no more
            cell.limits["chance_ratio"] = 1.0
        return cell

    return make
