"""The port's multilevel V-cycle against `repro.core.multilevel` on the CPU:
the level stack and budgets, the device layout of a contracted level (whose
weights grow past 2), a coarse-level superstep with `repro`'s replayed
draws, the V-cycle end to end in distribution over seeds, and `repro`'s
argument errors."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import run_partitioner as jax_run_partitioner
from repro.core import multilevel as jax_multilevel
from repro.core.device_graph import prepare_device_graph as jax_prepare
from repro.core.revolver import (
    RevolverConfig as JaxConfig,
    revolver_init as jax_init,
    revolver_superstep as jax_superstep,
)
from repro.graphs.datasets import load_dataset as jax_load_dataset
from repro.graphs.generators import rmat as jax_rmat

from repro_torch.core import multilevel, run_partitioner
from repro_torch.core.convert import revolver_state_from_numpy
from repro_torch.core.device_graph import prepare_device_graph
from repro_torch.core.revolver import RevolverConfig, revolver_superstep
from repro_torch.graphs import load_dataset
from repro_torch.graphs.generators import rmat
from test_torch_superstep import replayed_draws

DEVICE_FIELDS = ("n", "n_pad", "m", "n_blocks", "block_v", "e_max", "dir_src", "dir_dst",
                 "blk_dst", "blk_row", "blk_w", "deg_out", "inv_wsum", "vmask")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These runs are many small CPU ops: torch's intra-op threads buy
    little here and contend with the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_graph(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("graph,coarse_n", [("rmat", 256), ("rmat", 64), ("wiki", 512),
                                            ("wiki", 4096)])
def test_level_stack_matches_reference(graph, coarse_n):
    if graph == "rmat":
        g, g_ref = rmat(2048, 16384, seed=0), jax_rmat(2048, 16384, seed=0)
    else:
        g, g_ref = (load_dataset("WIKI", scale=0.002), jax_load_dataset("WIKI", scale=0.002))
    graphs, cmaps = multilevel.build_level_stack(g, coarse_n)
    graphs_ref, cmaps_ref = jax_multilevel.build_level_stack(g_ref, coarse_n)
    assert len(graphs) == len(graphs_ref) and len(cmaps) == len(cmaps_ref)
    for a, b in zip(graphs, graphs_ref):
        assert_same_graph(a, b)
    for a, b in zip(cmaps, cmaps_ref):
        np.testing.assert_array_equal(a, b)
    if coarse_n < g.n:
        assert len(graphs) > 1 and graphs[-1].adj_w.max() > 2   # contracted weights


@pytest.mark.parametrize("max_steps,n_levels,decay,patience", [
    (290, 4, 0.12, 5), (290, 1, 0.12, 5), (40, 6, 0.5, 3), (15, 3, 0.12, 5), (100, 2, 1.0, 5)])
def test_level_budgets_match_reference(max_steps, n_levels, decay, patience):
    assert (multilevel.level_budgets(max_steps, n_levels, decay, patience)
            == jax_multilevel.level_budgets(max_steps, n_levels, decay, patience))


@pytest.fixture(scope="module")
def coarse_level():
    """The third level of WIKI 0.002's stack (weights up to past 2), from
    `repro`'s own coarsening."""
    g = jax_load_dataset("WIKI", scale=0.002)
    graphs, _ = jax_multilevel.build_level_stack(g, 512)
    return graphs[2]


def test_contracted_level_layout_matches_reference(coarse_level):
    dg = prepare_device_graph(coarse_level, n_blocks=8, device="cpu")
    want = jax.device_get(jax_prepare(coarse_level, n_blocks=8)._asdict())
    for f in DEVICE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(dg, f)), want[f], err_msg=f)
    assert float(dg.blk_w.max()) > 2


@pytest.mark.parametrize("weight_mode", ["self_lambda", "neighbor_lambda"])
def test_coarse_level_superstep_matches_reference(coarse_level, weight_mode):
    """3 supersteps on the contracted level from one state with `repro`'s
    replayed draws: labels, lambda and loads bit-equal (the score within
    1e-6, as tests/test_torch_superstep.py holds it)."""
    k, steps = 8, 3
    dg_ref = jax_prepare(coarse_level, n_blocks=8)
    dg = prepare_device_graph(coarse_level, n_blocks=8, device="cpu")
    cfg, cfg_t = JaxConfig(k=k, weight_mode=weight_mode), RevolverConfig(k=k, weight_mode=weight_mode)
    st = jax_init(dg_ref, cfg, jax.random.PRNGKey(3))
    st_t = revolver_state_from_numpy(jax.device_get(st._asdict()), "cpu", seed=0)
    draws = replayed_draws(st.key, steps, dg.n_blocks, dg.block_v, k)
    labels0 = st_t.labels.clone()
    for step in range(steps):
        st = jax_superstep(dg_ref, cfg, st)
        st_t = revolver_superstep(dg, cfg_t, st_t, draws=draws)
        want = jax.device_get(st._asdict())
        for name in ("labels", "lam", "loads"):
            np.testing.assert_array_equal(getattr(st_t, name).numpy(), want[name],
                                          err_msg=f"{name} after superstep {step}")
        np.testing.assert_allclose(float(st_t.score), float(want["score"]), rtol=1e-6)
    assert (st_t.labels != labels0).any()


@pytest.mark.parametrize("algo", ["revolver", "spinner"])
def test_vcycle_quality_matches_reference(algo):
    """WIKI 0.002, k=8, seeds 0-2: mean local edges >= 0.97x `repro`'s
    V-cycle mean, every max normalized load <= 1.30."""
    g, g_ref = load_dataset("WIKI", scale=0.002), jax_load_dataset("WIKI", scale=0.002)
    ours = [run_partitioner(algo, g, 8, seed=s, mode="vcycle", device="cpu",
                            track_history=False) for s in range(3)]
    ref = [jax_run_partitioner(algo, g_ref, 8, seed=s, mode="vcycle", track_history=False)
           for s in range(3)]
    le = np.mean([r.local_edges for r in ours])
    le_ref = np.mean([r.local_edges for r in ref])
    assert le >= 0.97 * le_ref, (le, le_ref)
    assert all(r.max_norm_load <= 1.30 for r in ours), [r.max_norm_load for r in ours]
    levels, _ = jax_multilevel.build_level_stack(g_ref, multilevel.DEFAULT_COARSE_N)
    budgets = jax_multilevel.level_budgets(290, len(levels), multilevel.DEFAULT_LEVEL_DECAY, 5)
    for r in ours:
        assert r.labels.shape == (g.n,)
        assert r.vcycle["level_n_vertices"] == [x.n for x in levels]
        assert r.vcycle["level_n_blocks"] == [
            jax_prepare(x, n_blocks=8).n_blocks for x in levels]
        assert r.vcycle["budgets"] == budgets
        assert r.vcycle["steps_per_level"][0] == r.steps
        assert all(1 <= s <= b for s, b in zip(r.vcycle["steps_per_level"], budgets))


def test_vcycle_runs_every_warm_startable_rule_and_degenerates_to_flat():
    g = rmat(512, 4096, seed=0)
    for algo in ("revolver", "spinner", "restream"):
        res = run_partitioner(algo, g, 4, seed=0, mode="vcycle", coarse_n=64,
                              max_steps=20, device="cpu", track_history=False)
        assert res.labels.shape == (g.n,) and len(res.vcycle["budgets"]) > 1
    flat = run_partitioner("revolver", g, 4, seed=0, max_steps=20, device="cpu")
    one = run_partitioner("revolver", g, 4, seed=0, mode="vcycle", coarse_n=512,
                          max_steps=20, device="cpu")
    assert one.vcycle["level_n_vertices"] == [g.n]
    np.testing.assert_array_equal(one.labels, flat.labels)


@pytest.mark.parametrize("case", [
    ("revolver", dict(mode="between")),
    ("revolver", dict(coarse_n=64)),
    ("revolver", dict(level_decay=0.5)),
    ("hash", dict(mode="vcycle")),
    ("revolver", dict(mode="vcycle", guard="raise")),
    ("revolver", dict(mode="vcycle", checkpoint_dir="ckpt")),
    ("revolver", dict(mode="vcycle", init_labels=np.zeros(128, dtype=np.int32))),
    ("revolver", dict(mode="vcycle", coarse_n=2)),
    ("revolver", dict(mode="vcycle", coarse_n=32, level_decay=0.0)),
    ("revolver", dict(mode="vcycle", coarse_n=32, vcycle_sharpen=1.0)),
], ids=lambda c: c[0] + "-" + "-".join(f"{k}={v}" for k, v in c[1].items()
                                        if k != "init_labels")[:40])
def test_vcycle_argument_errors_match_reference(case):
    algo, kwargs = case
    g, g_ref = rmat(128, 1024, seed=0), jax_rmat(128, 1024, seed=0)
    with pytest.raises((ValueError, TypeError)) as want:
        jax_run_partitioner(algo, g_ref, 4, **kwargs)
    with pytest.raises(want.type):
        run_partitioner(algo, g, 4, device="cpu", **kwargs)


def test_vcycle_rejects_a_layout_and_replayed_draws():
    g = rmat(128, 1024, seed=0)
    dg = prepare_device_graph(g, device="cpu")
    for kwargs in (dict(dg=dg), dict(draws=lambda step, blk: None)):
        with pytest.raises(ValueError, match="mode='vcycle'"):
            run_partitioner("revolver", g, 4, mode="vcycle", device="cpu", **kwargs)


def test_vcycle_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_partitioner("revolver", rmat(2048, 16384, seed=0), 4, mode="vcycle")
