"""The port's Spinner, restream and static rules against `repro`'s on the
CPU: superstep parity with replayed draws, the registry round trip of
tests/test_registry.py on the sequential schedule, the static baselines,
end-to-end quality, and the CLI.

Superstep parity: both packages start from the same state (`repro`'s
carried across with `repro_torch.core.convert`) and the port replays
`repro`'s own threefry draws through the ``draws=`` hook. Spinner splits
``key, k_mig = split(key)`` once per superstep and draws
``uniform(k_mig, (n_pad,))``; restream does the same once per block with a
``(block_v,)`` uniform. Labels, loads, restream's spent budgets and ranks
must then agree bit for bit after every superstep, the score to an f32
rounding (the two sum it in other orders).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import run_partitioner as jax_run_partitioner
from repro.core.device_graph import prepare_device_graph as jax_prepare
from repro.core.restream import (
    RestreamConfig as JaxRestreamConfig,
    restream_init as jax_restream_init,
    restream_init_from_labels as jax_restream_warm,
    restream_superstep as jax_restream_superstep,
)
from repro.core.spinner import (
    SpinnerConfig as JaxSpinnerConfig,
    spinner_init as jax_spinner_init,
    spinner_init_from_labels as jax_spinner_warm,
    spinner_superstep as jax_spinner_superstep,
)
from repro.core.static_partitioners import hash_partition as jax_hash, range_partition as jax_range
from repro.graphs import load_dataset as jax_load_dataset
from repro.graphs.generators import dc_sbm as jax_dc_sbm, edge_split, ring_of_cliques

from repro_torch.core import engine
from repro_torch.core import registry as registry_module
from repro_torch.core.convert import (
    device_graph_from_numpy,
    restream_state_from_numpy,
    spinner_state_from_numpy,
)
from repro_torch.core.device_graph import prepare_device_graph
from repro_torch.core.metrics import partition_loads
from repro_torch.core.registry import (
    StaticAlgorithm,
    available_algorithms,
    get_algorithm,
    register,
    superstep_algorithms,
    warm_startable_algorithms,
)
from repro_torch.core.restream import (
    RestreamConfig,
    restream_init,
    restream_superstep,
)
from repro_torch.core.revolver import make_generator
from repro_torch.core.runner import run_partitioner
from repro_torch.core.spinner import SpinnerConfig, spinner_superstep
from repro_torch.core.static_partitioners import hash_partition, range_partition
from repro_torch.graphs import load_dataset
from repro_torch.graphs.csr import build_graph
from repro_torch.launch import partition as cli

# the golden-worker graph (tests/golden_worker.py:31-37)
GRAPH = dict(n=1024, m=8192, n_comm=16, mixing=0.25, degree_exponent=0.5, seed=3)
K, N_BLOCKS, STEPS, SEED = 4, 8, 6, 7


@pytest.fixture(scope="module")
def golden():
    """`repro`'s layout of the golden-worker graph and the port's copy."""
    dg = jax_prepare(jax_dc_sbm(**GRAPH), n_blocks=N_BLOCKS)
    return dg, device_graph_from_numpy(jax.device_get(dg._asdict()), "cpu")


def assert_same(ours, want: dict, names, step):
    for name in names:
        np.testing.assert_array_equal(getattr(ours, name).numpy(), want[name],
                                      err_msg=f"{name} differs after superstep {step}")
    np.testing.assert_allclose(float(ours.score), float(want["score"]), rtol=1e-6)
    assert ours.step == int(want["step"])


def test_spinner_superstep_parity_with_replayed_draws(golden):
    dg, dg_t = golden
    cfg, cfg_t = JaxSpinnerConfig(k=K), SpinnerConfig(k=K)
    st = jax_spinner_init(dg, cfg, jax.random.PRNGKey(SEED))
    st_t = spinner_state_from_numpy(jax.device_get(st._asdict()), "cpu", seed=0)
    key, uniform = st.key, []
    for _ in range(STEPS):
        key, k_mig = jax.random.split(key)
        uniform.append(np.array(jax.random.uniform(k_mig, (dg.n_pad,))))
    labels0 = st_t.labels.clone()
    for step in range(STEPS):
        st = jax_spinner_superstep(dg, cfg, st)
        st_t = spinner_superstep(dg_t, cfg_t, st_t, draws=lambda s: uniform[s])
        assert_same(st_t, jax.device_get(st._asdict()), ("labels", "loads"), step)
    assert (st_t.labels != labels0).any()


@pytest.mark.parametrize("ramp,budget", [(8, 32), (3, 32), (3, 2)])
def test_restream_superstep_parity_with_replayed_draws(golden, ramp, budget):
    """Ramp 8 divides exactly; ramp 3 tests the f32 gate threshold; budget 2
    freezes vertices within the 6 supersteps."""
    dg, dg_t = golden
    kw = dict(k=K, priority_ramp=ramp, restream_budget=budget)
    cfg, cfg_t = JaxRestreamConfig(**kw), RestreamConfig(**kw)
    st = jax_restream_init(dg, cfg, jax.random.PRNGKey(SEED))
    st_t = restream_state_from_numpy(jax.device_get(st._asdict()), "cpu", seed=0)
    key = st.key
    uniform = np.empty((STEPS, dg.n_blocks, dg.block_v), np.float32)
    for s in range(STEPS):
        for b in range(dg.n_blocks):
            key, k_mig = jax.random.split(key)
            uniform[s, b] = np.asarray(jax.random.uniform(k_mig, (dg.block_v,)))
    labels0 = st_t.labels.clone()
    for step in range(STEPS):
        st = jax_restream_superstep(dg, cfg, st)
        st_t = restream_superstep(dg_t, cfg_t, st_t,
                                  draws=lambda s, b: uniform[s, b])
        assert_same(st_t, jax.device_get(st._asdict()),
                    ("labels", "loads", "used", "rank"), step)
    assert (st_t.labels != labels0).any()
    if budget == 2:
        assert int(st_t.used.max()) == 2


def test_unlock_threshold_matches_reference():
    """The gate threshold, bit for bit, against `repro`'s expression
    (restream.py:169) as jit compiles it, for every step of ramps 1-16."""
    import jax.numpy as jnp

    from repro_torch.core.restream import _unlock

    for ramp in range(1, 17):
        f = jax.jit(lambda s, ramp=ramp: 1.0 - (s.astype(jnp.float32) + 1.0) / ramp)
        for step in range(ramp + 1):
            want = np.float32(f(jnp.int32(step)))
            assert np.float32(_unlock(step, ramp)).view(np.int32) == want.view(np.int32), \
                (ramp, step)


def test_init_matches_reference(golden):
    """The port's own restream init computes `repro`'s degree ranks; warm
    starts splice the carried labels and recompute the loads as `repro`
    does."""
    dg, dg_t = golden
    rank = np.asarray(jax_restream_init(dg, JaxRestreamConfig(k=K),
                                        jax.random.PRNGKey(0)).rank)
    ours = restream_init(dg_t, RestreamConfig(k=K), make_generator(0, "cpu"))
    np.testing.assert_array_equal(ours.rank.numpy(), rank)
    assert ours.used.shape == (dg.n_blocks, dg.block_v) and not ours.used.any()
    carried = np.random.default_rng(5).integers(0, K, dg.n).astype(np.int32)
    for name, jax_warm, jcfg in (("spinner", jax_spinner_warm, JaxSpinnerConfig(k=K)),
                                 ("restream", jax_restream_warm, JaxRestreamConfig(k=K))):
        algo = get_algorithm(name)
        got = algo.init_from_labels(dg_t, algo.config_cls(k=K),
                                    make_generator(0, "cpu"), carried)
        want = jax_warm(dg, jcfg, jax.random.PRNGKey(0), carried)
        for field in ("labels", "loads"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)),
                                          err_msg=f"{name} {field}")


# ---------------------------------------------------------------------------
# the registry round trip of tests/test_registry.py, sequential schedule
# ---------------------------------------------------------------------------
RK, RSTEPS = 4, 3


@pytest.fixture(scope="module")
def cliques():
    g = ring_of_cliques(8, 12)
    return build_graph(*edge_split(g), g.n)


def test_builtins_registered():
    assert set(available_algorithms()) == {"revolver", "spinner", "restream",
                                           "hash", "range"}
    assert set(superstep_algorithms()) == {"revolver", "spinner", "restream"}
    assert set(warm_startable_algorithms()) == {"revolver", "spinner", "restream"}
    assert isinstance(get_algorithm("hash"), StaticAlgorithm)
    assert isinstance(get_algorithm("range"), StaticAlgorithm)
    with pytest.raises(ValueError, match="restream"):
        get_algorithm("metis")


@pytest.mark.parametrize("name", ["revolver", "spinner", "restream"])
@pytest.mark.parametrize("warm", [False, True])
def test_supersteps_preserve_invariants(cliques, name, warm):
    algo = get_algorithm(name)
    cfg = algo.config_cls(k=RK)
    dg = prepare_device_graph(cliques, n_blocks=4, device="cpu")
    gen = make_generator(0, "cpu")
    if warm:
        carried = np.arange(cliques.n, dtype=np.int32) % RK
        state = algo.init_from_labels(dg, cfg, gen, carried)
        np.testing.assert_array_equal(state.labels[: cliques.n].numpy(), carried)
    else:
        state = algo.init(dg, cfg, gen)
    for _ in range(RSTEPS):
        state = engine.superstep(algo, dg, cfg, state)
        lab = state.labels.numpy()
        assert lab.min() >= 0 and lab.max() < RK
        # the engine's load accounting stays exact
        np.testing.assert_array_equal(
            state.loads.numpy(), partition_loads(state.labels, dg.deg_out, RK).numpy())
    assert state.step == RSTEPS
    assert np.isfinite(float(state.score))


@pytest.mark.parametrize("name", ["revolver", "spinner", "restream"])
def test_run_partitioner_by_name(cliques, name):
    r = run_partitioner(name, cliques, RK, max_steps=RSTEPS, patience=10_000,
                        device="cpu")
    assert r.steps == RSTEPS
    assert 0.0 <= r.local_edges <= 1.0
    assert len(r.history["score"]) == RSTEPS


@pytest.mark.parametrize("name", ["hash", "range"])
def test_static_baselines_match_reference(cliques, name):
    """Labels equal `repro`'s closed forms, here and through
    run_partitioner (no supersteps, metrics as `repro` computes them)."""
    ours = {"hash": hash_partition, "range": range_partition}[name]
    ref = {"hash": jax_hash, "range": jax_range}[name]
    for n, k in ((96, 4), (1001, 7), (3_000_000, 8)):
        np.testing.assert_array_equal(ours(n, k, device="cpu").numpy(), np.asarray(ref(n, k)))
    g = load_dataset("WIKI", scale=0.0005)
    r = run_partitioner(name, g, RK, device="cpu")
    want = jax_run_partitioner(name, jax_load_dataset("WIKI", scale=0.0005), RK)
    assert r.steps == 0 and r.converged
    np.testing.assert_array_equal(r.labels, want.labels)
    assert r.local_edges == pytest.approx(want.local_edges, abs=1e-6)
    assert r.max_norm_load == pytest.approx(want.max_norm_load, rel=1e-6)
    assert run_partitioner(name, cliques, RK, device="cpu").labels.shape == (cliques.n,)


@pytest.mark.parametrize("name", ["hash", "range"])
def test_static_baselines_default_to_cuda(monkeypatch, name):
    """Without a device the closed forms go to the card, and raise on a
    host without CUDA, as every entry point of the port does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ours = {"hash": hash_partition, "range": range_partition}[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ours(96, 4)
    assert ours(96, 4, device="cpu").device.type == "cpu"


def test_static_and_stateless_arguments_raise(cliques):
    with pytest.raises(TypeError, match="no supersteps"):
        run_partitioner("hash", cliques, RK, device="cpu", chunk_schedule="sharded")
    with pytest.raises(TypeError, match="no supersteps"):
        run_partitioner("range", cliques, RK, device="cpu", epsilon=0.1)
    with pytest.raises(TypeError, match="stateless"):
        run_partitioner("hash", cliques, RK, device="cpu",
                        init_labels=np.zeros(cliques.n, np.int32))
    for name in ("spinner", "restream"):
        with pytest.raises(TypeError, match="no LA state"):
            run_partitioner(name, cliques, RK, device="cpu",
                            init_labels=np.zeros(cliques.n, np.int32),
                            init_probs=np.full((cliques.n, RK), 0.25, np.float32))
        with pytest.raises(TypeError, match="no LA state"):
            run_partitioner(name, cliques, RK, device="cpu", init_sharpen=0.5)
        res = run_partitioner(name, cliques, RK, device="cpu", max_steps=2,
                              init_labels=np.arange(cliques.n) % RK, keep_probs=True)
        assert res.steps == 2 and res.probs is None


def test_restream_priority_gates_early_steps(cliques):
    """With a long ramp, the first superstep may only move the top degree
    quantile; the frozen tail keeps its initial labels."""
    dg = prepare_device_graph(cliques, n_blocks=4, device="cpu")
    algo = get_algorithm("restream")
    cfg = algo.config_cls(k=RK, priority_ramp=1000)
    state = algo.init(dg, cfg, make_generator(0, "cpu"))
    before = state.labels.clone().numpy()
    rank = state.rank.numpy()
    state = engine.superstep(algo, dg, cfg, state)
    locked = rank < 1.0 - 1.0 / 1000
    np.testing.assert_array_equal(before[locked], state.labels.numpy()[locked])


def test_restream_ramp_one_and_beats_hash(cliques):
    r = run_partitioner("restream", cliques, RK, max_steps=10, patience=10_000,
                        priority_ramp=1, track_history=False, device="cpu")
    assert 0.0 <= r.local_edges <= 1.0
    rh = run_partitioner("hash", cliques, RK, device="cpu")
    rr = run_partitioner("restream", cliques, RK, max_steps=60, seed=0,
                         track_history=False, device="cpu")
    assert rr.local_edges > rh.local_edges + 0.1


def test_config_validation():
    with pytest.raises(ValueError, match="priority_ramp"):
        RestreamConfig(k=4, priority_ramp=0)
    with pytest.raises(ValueError, match="restream_budget"):
        RestreamConfig(k=4, restream_budget=-1)
    for cls in (RestreamConfig, SpinnerConfig):
        with pytest.raises(ValueError, match="chunk_schedule"):
            cls(k=4, chunk_schedule="bsp")
        with pytest.raises(ValueError, match="capacity_mode"):
            cls(k=4, capacity_mode="bogus")
        # the sharded schedules and hub replication are ported: hubs on one
        # halo shard equal the sequential hub oracle
        assert cls(k=4, chunk_schedule="sharded").chunk_schedule == "sharded"
        kw = dict(device="cpu", max_steps=3, hub_replication=True, hub_quantile=0.9)
        algo, g = cls.__name__[:-6].lower(), load_dataset("WIKI", scale=0.0005)
        np.testing.assert_array_equal(
            run_partitioner(algo, g, 4, chunk_schedule="halo", **kw).labels,
            run_partitioner(algo, g, 4, **kw).labels)


def test_register_out_of_tree_shard_rule(cliques):
    """A rule module's whole integration surface: register an Algorithm and
    it runs by name through the engine and the convergence loop."""
    spinner = get_algorithm("spinner")

    @dataclasses.dataclass(frozen=True)
    class LazyConfig:
        k: int
        epsilon: float = 0.05
        max_steps: int = 10
        patience: int = 5
        theta: float = 0.001
        capacity_mode: str = "spinner"

    def lazy_rule(cfg, ctx, local, loads, cap, gen):
        # never migrates; scores zero — the minimal legal shard rule
        assert ctx.local_rows().shape == (ctx.blocks * ctx.blk_row.shape[1],)
        return engine.ShardUpdate(vert={"labels": local["labels"]},
                                  loads_delta=torch.zeros_like(loads),
                                  score=torch.zeros(()))

    algo = register(engine.Algorithm(
        name="_test_lazy", config_cls=LazyConfig, state_cls=spinner.state_cls,
        kind="shard", init=spinner.init, shard_rule=lazy_rule))
    try:
        assert get_algorithm("_test_lazy") is algo
        r = run_partitioner("_test_lazy", cliques, RK, max_steps=3,
                            patience=10_000, track_history=False, device="cpu")
        assert r.steps == 3
    finally:
        # the registry is process-global
        registry_module._REGISTRY.pop("_test_lazy", None)


def test_algorithm_declaration_validated():
    spinner = get_algorithm("spinner")
    base = dict(name="x", config_cls=spinner.config_cls,
                state_cls=spinner.state_cls, init=spinner.init)
    with pytest.raises(ValueError, match="kind"):
        engine.Algorithm(kind="bsp", shard_rule=lambda *a: None, **base)
    with pytest.raises(ValueError, match="rule"):
        engine.Algorithm(kind="shard", chunk_rule=lambda *a: None, **base)
    with pytest.raises(ValueError, match="rule"):
        engine.Algorithm(kind="chunk", shard_rule=lambda *a: None, **base)


def test_shard_context_local_rows(cliques):
    dg = prepare_device_graph(cliques, n_blocks=4, device="cpu")
    ctx = engine.ShardContext(
        n_pad=dg.n_pad, local_n=dg.n_pad, block_v=dg.block_v,
        blocks=dg.n_blocks, v0=0, blk_dst=dg.blk_dst, blk_row=dg.blk_row,
        blk_w=dg.blk_w, blk_row_ptr=dg.blk_row_ptr, blk_spans=dg.blk_spans,
        deg=dg.deg_out, inv_wsum=dg.inv_wsum, vmask=dg.vmask, step=0, repl={})
    rows = ctx.local_rows().reshape(dg.n_blocks, -1)
    np.testing.assert_array_equal(
        rows.numpy(), dg.blk_row.numpy() + np.arange(dg.n_blocks)[:, None] * dg.block_v)
    x = torch.arange(3)
    assert ctx.gather(x) is x and ctx.psum(x) is x


@pytest.mark.parametrize("name", ["spinner", "restream"])
def test_end_to_end_quality_matches_reference(name):
    """WIKI at scale 0.002, k=8, seeds 0-2, compared in distribution (torch's
    generator cannot replay threefry) by the repo's own gates: mean local
    edges >= 0.97x the reference mean, every max normalized load <= 1.30."""
    g = load_dataset("WIKI", scale=0.002)
    g_ref = jax_load_dataset("WIKI", scale=0.002)
    ours = [run_partitioner(name, g, 8, seed=s, device="cpu", track_history=False)
            for s in range(3)]
    ref = [jax_run_partitioner(name, g_ref, 8, seed=s, track_history=False)
           for s in range(3)]
    le = np.mean([r.local_edges for r in ours])
    le_ref = np.mean([r.local_edges for r in ref])
    assert le >= 0.97 * le_ref, (le, le_ref)
    assert all(r.max_norm_load <= 1.30 for r in ours), [r.max_norm_load for r in ours]
    assert all(r.labels.shape == (g.n,) and 0 < r.steps < 290 for r in ours)


def test_cli_runs_the_named_algorithms(capsys, tmp_path):
    out = tmp_path / "labels.npz"
    cli.main(["--device", "cpu", "--dataset", "WIKI", "--scale", "0.0005",
              "--k", "4", "--max-steps", "10", "--algo", "spinner",
              "--algo", "hash", "--json", "--labels-out", str(out)])
    rows = json.loads(capsys.readouterr().out)
    assert [r["algo"] for r in rows] == ["spinner", "hash"]
    assert rows[1]["steps"] == 0 and 0 < rows[0]["steps"] <= 10
    n = load_dataset("WIKI", scale=0.0005).n
    assert {a: v.shape for a, v in np.load(out).items()} == {"spinner": (n,), "hash": (n,)}
