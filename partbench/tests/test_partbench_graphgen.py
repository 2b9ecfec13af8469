"""The benchmark's device graph generator against the port's host one."""
import numpy as np
import pytest
import torch

from partbench import graphgen
from repro_torch.graphs.csr import build_graph
from repro_torch.graphs.generators import dc_sbm

def degree_law_slope(deg: np.ndarray) -> float:
    """Slope of log(degree quantile q) against log(1 - q) over q in
    [0.5, 0.98]: about minus the degree exponent for theta ~ U^-a."""
    qs = np.array([0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 0.98])
    vals = np.quantile(deg.astype(np.float64), qs)
    return float(np.polyfit(np.log(1.0 - qs), np.log(np.maximum(vals, 1.0)), 1)[0])


def intra_share(col_idx: np.ndarray, row_ptr: np.ndarray, n: int, n_comm: int) -> float:
    """Share of directed edges whose ends lie in one community."""
    comm_size, _ = graphgen.community_layout(n, n_comm)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(row_ptr))
    return float(np.mean(src // comm_size == col_idx.astype(np.int64) // comm_size))


SPEC = dict(family="dc_sbm", n=30000, m=600000, n_comm=58, mixing=0.35,
            degree_exponent=0.5, theta_low=0.02, oversample=1.12)


@pytest.fixture(scope="module")
def pair():
    mine = graphgen.make_graph(SPEC, 123, "cpu")
    theirs = dc_sbm(SPEC["n"], SPEC["m"], n_comm=SPEC["n_comm"], mixing=SPEC["mixing"],
                    degree_exponent=SPEC["degree_exponent"], seed=5)
    return mine, theirs


def test_same_vertex_count(pair):
    mine, theirs = pair
    assert mine["n"] == theirs.n


def test_edge_count_within_one_percent(pair):
    mine, theirs = pair
    assert abs(mine["m"] - theirs.m) / theirs.m < 0.01
    assert abs(mine["adj_idx"].size - theirs.num_sym_edges) / theirs.num_sym_edges < 0.01


def test_intra_community_share_within_a_hundredth(pair):
    mine, theirs = pair
    a = intra_share(mine["col_idx"], mine["row_ptr"], mine["n"], SPEC["n_comm"])
    b = intra_share(theirs.col_idx, theirs.row_ptr, theirs.n, SPEC["n_comm"])
    assert abs(a - b) < 0.01


def test_same_degree_law(pair):
    mine, theirs = pair
    a, b = degree_law_slope(mine["deg_out"]), degree_law_slope(theirs.deg_out)
    assert abs(a - b) < 0.05


@pytest.mark.parametrize("n,draws,seed", [(500, 5000, 0), (64, 3000, 1), (2000, 200, 2)])
def test_csr_bit_equal_to_build_graph(n, draws, seed):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, draws), rng.integers(0, n, draws)
    mine = graphgen.csr_arrays(torch.from_numpy(src), torch.from_numpy(dst), n)
    theirs = build_graph(src, dst, n)
    assert mine["m"] == theirs.m
    for field in ("row_ptr", "col_idx", "adj_ptr", "adj_idx", "adj_w", "deg_out"):
        got, want = mine[field].numpy(), getattr(theirs, field)
        assert got.dtype == want.dtype, field
        assert np.array_equal(got, want), field


def test_same_seed_same_graph():
    a = graphgen.make_graph(dict(SPEC, n=2000, m=20000, n_comm=4), 2**40 + 7, "cpu")
    b = graphgen.make_graph(dict(SPEC, n=2000, m=20000, n_comm=4), 2**40 + 7, "cpu")
    assert all(np.array_equal(a[f], b[f]) for f in ("row_ptr", "col_idx", "adj_w"))


def test_degree_stats_by_hand():
    s = graphgen.degree_stats(np.array([1, 1, 2, 4], dtype=np.int32))
    assert (s["mean"], s["mode"], s["max"]) == (2.0, 1, 4)
    assert s["skewness"] == pytest.approx(1.0 / np.sqrt(1.5))


def test_edge_count_off_its_tolerance_is_refused():
    spec = dict(SPEC, n=3000, m=60000, n_comm=6)
    g = graphgen.make_graph(dict(spec, m_tolerance=0.1), 7, "cpu")
    assert abs(g["m"] - spec["m"]) <= 0.1 * spec["m"]
    with pytest.raises(ValueError, match="oversample"):
        graphgen.make_graph(dict(spec, m_tolerance=0.001), 7, "cpu")
