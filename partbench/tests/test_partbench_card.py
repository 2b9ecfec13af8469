"""On the card: a short run of each algorithm through K1, K2 and K3 at a
reduced size, held to the reference like a benchmark run.

    python -m pytest -q -m chip partbench/tests

runs these on a machine with an NVIDIA GPU; elsewhere they skip."""
import pytest

from partbench import harness


@pytest.mark.chip
@pytest.mark.parametrize("name", ["ok-k8.revolver", "ok-k8.spinner", "ok-k8.restream"])
def test_short_run_on_the_card(cuda_device, cell_named, name):
    cell = cell_named(name)
    cell.config["graph"].update(n=200_000, m=4_000_000, n_comm=390)
    res = harness.execute(cell, 2**32 + 5, 2.0, True, device="cuda")
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
