"""The port's stream over a mesh against `repro`'s on the CPU.

`repro` runs live on the same inputs in a subprocess pinned to 4 forced
host devices (``--xla_force_host_platform_device_count``, fixed when JAX's
backend starts): this module run as a program (`_worker`), the harness of
tests/test_torch_hubs.py. It streams WIKI 0.002 in 5 deltas into
`repro`'s ``IncrementalDeviceGraph(mesh=...)`` and saves, after every
delta, the host slabs, the block permutation and the ``as_sharded`` plan
of each layout case; at one delta of some cases it saves a starting state,
every superstep's state and the draws `repro` made; it runs `repro`'s
4-shard halo stream with hubs over seeds 0-2, the first traced.

The port streams the same deltas into its own layout on
``BlocksMesh(["cpu"] * 4)``: the layouts and plans are bit-equal after
every delta; supersteps on them from `repro`'s state with its draws
replayed give bit-equal labels, lambda and loads (Spinner's and restream's
own fields too; the score within rtol 1e-6); its counters and recompile
causes carry `repro`'s names. Then the port's counterparts of `repro`'s
in-process stream tests (tests/test_halo.py, tests/test_sharded.py,
tests/test_faults.py), and the carried state's vertex order under a
permutation.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.core import engine  # noqa: E402
from repro_torch.core.device_graph import (  # noqa: E402
    block_vertex_perms,
    prepare_device_graph,
    shard_device_graph,
)
from repro_torch.core.halo import HubConfig  # noqa: E402
from repro_torch.core.registry import get_algorithm  # noqa: E402
from repro_torch.core.runner import AsyncStaleness  # noqa: E402
from repro_torch.graphs import load_dataset  # noqa: E402
from repro_torch.graphs.generators import dc_sbm, edge_split  # noqa: E402
from repro_torch.launch.mesh import BlocksMesh  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.streaming import (  # noqa: E402
    IncrementalDeviceGraph,
    StreamConfig,
    StreamRunner,
    stream_from_graph,
)
from repro_torch.streaming import delta_graph as delta_mod  # noqa: E402
from test_torch_hubs import _CONVERT, _FIELDS  # noqa: E402

CPU = torch.device("cpu")
K, STEPS, S, NB, QUANTILE = 8, 3, 4, 16, 0.9
SCALE, DELTAS = 0.002, 5
PERM = np.random.default_rng(3).permutation(NB)
# the reference's end-to-end stream (tests/test_streaming.py), on 4 shards
E2E_CFG = dict(k=8, n_blocks=NB, refine_max_steps=15, refine_patience=3, sync_every=2,
               warm_sharpen=0.5)
E2E_KW = dict(chunk_schedule="halo", halo_threshold=2.0, hub_replication=True,
              hub_quantile=QUANTILE)

# (name, assignment, granularity, hubs, threshold): every layout case
# streams the 5 deltas; threshold 2.0 pins the halo plan on, the last case
# keeps the default (it falls back: the hub floors stay as they are)
CASES = [
    ("contiguous-block", "contiguous", "block", False, 2.0),
    ("contiguous-vertex-hubs", "contiguous", "vertex", True, 2.0),
    ("perm-vertex", "perm", "vertex", False, 2.0),
    ("perm-block-hubs", "perm", "block", True, 2.0),
    ("locality-vertex-hubs", "locality", "vertex", True, 2.0),
    ("locality-auto-default", "locality", "auto", True, None),
]
# (name, algo, case, delta, schedule, staleness): STEPS supersteps from
# `repro`'s init (seed 0) on the case's layout after that delta
LEGS = [
    ("revolver-halo-block", "revolver", "contiguous-block", 4, "halo", 0),
    ("revolver-halo-vertex", "revolver", "perm-vertex", 2, "halo", 0),
    ("revolver-halo-hubs", "revolver", "locality-vertex-hubs", 4, "halo", 0),
    ("revolver-async-s1", "revolver", "contiguous-vertex-hubs", 3, "async", 1),
    ("spinner-halo-hubs", "spinner", "perm-block-hubs", 4, "halo", 0),
    ("restream-halo-vertex", "restream", "contiguous-vertex-hubs", 1, "halo", 0),
]
SPEC_FIELDS = ("b_max", "h_max", "coverage", "fallback", "granularity", "boundary_rows",
               "blk_dst_halo", "send_ids", "n_hubs", "hub_pad", "hub_ids", "hub_owner",
               "hub_local", "hub_deg", "he_max", "hub_src", "hub_slot", "hub_w",
               "vmask_nonhub", "interior_split")
LAYOUT_FIELDS = ("deg_out", "inv_wsum", "vmask", "dir_src", "dir_dst")


def _assignment(name):
    return PERM if name == "perm" else name


def _hubs(config_cls, on):
    return config_cls(quantile=QUANTILE) if on else None


def _threshold_kw(threshold):
    return {} if threshold is None else {"halo_threshold": threshold}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small CPU ops: torch's intra-op threads buy little here and
    contend with the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# the JAX side: this module run as a program under 4 forced host devices
# --------------------------------------------------------------------------
def _jax_draws(algo, key, n_shards, bps, bv, n_pad) -> dict:
    """The draws `repro`'s halo superstep takes from ``key``."""
    out = {}
    if algo == "spinner":
        _, k_mig = jax.random.split(key)
        out["u"] = np.asarray(jax.random.uniform(k_mig, (n_pad,)))
        return out
    for s in range(n_shards):
        ks = key if s == 0 else jax.random.fold_in(key, s)
        for i in range(bps):
            b = s * bps + i
            if algo == "revolver":
                ks, k_act, k_mig = jax.random.split(ks, 3)
                out[f"{b}/g"] = np.asarray(jax.random.gumbel(k_act, (bv, K)))
            else:
                ks, k_mig = jax.random.split(ks)
            out[f"{b}/u"] = np.asarray(jax.random.uniform(k_mig, (bv,)))
    return out


def _jax_leg(sdg, algo, schedule, staleness) -> dict:
    from repro.core import engine as jengine
    from repro.core.registry import get_algorithm as jget

    alg = jget(algo)
    cfg = alg.config_cls(k=K, chunk_schedule=schedule,
                         **({"staleness_bound": staleness} if schedule == "async" else {}))
    state = jengine.place_state(alg, alg.init(sdg, cfg, jax.random.PRNGKey(0)), sdg)
    out = {}

    def snap(st, tag):
        for f, v in st._asdict().items():
            if f not in ("key", "step"):
                out[f"{tag}/{f}"] = np.asarray(jax.device_get(v))

    snap(state, "init")
    bps = sdg.n_blocks // S
    cache = None
    for step in range(STEPS):
        for name, d in _jax_draws(algo, state.key, S, bps, sdg.block_v, sdg.n_pad).items():
            out[f"draws/{step}/{name}"] = d
        if schedule == "async":
            # the StreamRunner's policy: refresh when the bound expires
            if cache is None or step % (staleness + 1) == 0:
                cache = None
            state, cache = jengine.async_superstep(alg, sdg, cfg, state, cache=cache)
        else:
            state = jengine.superstep(alg, sdg, cfg, state)
        snap(state, f"step{step}")
    return out


def _jax_layouts(out_dir: str) -> None:
    from repro.core import halo as jhalo
    from repro.graphs import load_dataset as jload
    from repro.launch.mesh import make_blocks_mesh as jmesh
    from repro.streaming import IncrementalDeviceGraph as JIdg
    from repro.streaming import stream_from_graph as jstream

    g = jload("WIKI", scale=SCALE, seed=0)
    for name, assign, gran, hubs, threshold in CASES:
        idg = JIdg(g.n, n_blocks=NB, mesh=jmesh(S), assignment=_assignment(assign))
        out = {}
        for d, delta in enumerate(jstream(g, DELTAS, seed=0)):
            _, info = idg.apply(delta)
            sdg = idg.as_sharded(halo=True, halo_granularity=gran, hubs=_hubs(jhalo.HubConfig, hubs),
                                 **_threshold_kw(threshold))
            pre = f"{d}/"
            out[pre + "info"] = np.array([info.dirty_blocks, info.repadded, idg.e_max])
            for f in ("_blk_dst", "_blk_row", "_blk_w"):
                out[pre + f] = getattr(idg, f).copy()    # rewritten in place later
            out[pre + "block_perm"] = np.asarray(
                idg.block_perm if idg.block_perm is not None else np.arange(idg.n_blocks))
            out[pre + "floors"] = np.array([idg.b_max_floor, idg.h_max_floor,
                                            idg.hub_pad_floor, idg._he_max_floor])
            for f in LAYOUT_FIELDS:
                out[pre + f] = np.array(getattr(sdg.dg, f))
            for f in SPEC_FIELDS:
                v = getattr(sdg.halo, f)
                out[pre + "spec/" + f] = np.asarray(-1 if v is None else v)
            for leg in LEGS:
                if leg[2] == name and leg[3] == d:
                    np.savez(os.path.join(out_dir, leg[0] + ".npz"),
                             **_jax_leg(sdg, leg[1], leg[4], leg[5]))
        np.savez(os.path.join(out_dir, name + ".npz"), **out)


class _JaxNotingTracer:
    """`repro`'s tracer, keeping every pre-registered recompile cause."""

    def __new__(cls):
        from repro.obs import Tracer as JTracer

        class Noting(JTracer):
            def __init__(self):
                super().__init__()
                self.noted = []

            def note_recompile_cause(self, cause):
                self.noted.append(cause)
                super().note_recompile_cause(cause)

        return Noting()


def _jax_e2e(out_dir: str) -> None:
    """`repro`'s 4-shard halo stream with hubs over seeds 0-2; seed 0
    traced (its counter names and the causes it notes)."""
    from repro.graphs import load_dataset as jload
    from repro.launch.mesh import make_blocks_mesh as jmesh
    from repro.streaming import StreamConfig as JConfig
    from repro.streaming import StreamRunner as JRunner
    from repro.streaming import stream_from_graph as jstream

    g = jload("WIKI", scale=SCALE, seed=0)
    out = {"runs": []}
    for seed in range(3):
        tracer = _JaxNotingTracer() if seed == 0 else None
        r = JRunner(g.n, JConfig(**E2E_CFG), seed=seed, mesh=jmesh(S), trace=tracer, **E2E_KW)
        r.run(jstream(g, DELTAS, seed=0))
        out["runs"].append({"local_edges": r.reports[-1].local_edges,
                            "max_norm_load": r.reports[-1].max_norm_load,
                            "steps": r.total_steps})
        if tracer is not None:
            doc = tracer.to_dict()
            out["counters"] = sorted({e["name"] for e in doc["traceEvents"]
                                      if e["ph"] == "C"} - {"recompiles"})
            out["causes"] = tracer.noted
            out["hub_count"] = [v for _, v in tracer.series["hub_count"]]
    with open(os.path.join(out_dir, "e2e.json"), "w") as f:
        json.dump(out, f)


def _worker(out_dir: str) -> int:
    assert jax.device_count() >= S, f"needs {S} host devices, has {jax.device_count()}"
    _jax_layouts(out_dir)
    _jax_e2e(out_dir)
    return 0


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_stream_sharded")
    env = dict(os.environ)
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_force_host_platform_device_count")]
    env["XLA_FLAGS"] = " ".join(flags + [f"--xla_force_host_platform_device_count={S}"])
    env["JAX_PLATFORMS"] = "cpu"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.path.join(root, "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return out


def _load(jax_runs, name) -> dict:
    with np.load(os.path.join(jax_runs, name + ".npz")) as z:
        return dict(z)


@pytest.fixture(scope="module")
def wiki():
    g = load_dataset("WIKI", scale=SCALE, seed=0)
    return g, list(stream_from_graph(g, DELTAS, seed=0))


def _mesh(n=S):
    return BlocksMesh([CPU] * n)


def _stream_case(g, deltas, case, upto=None):
    """The port's incremental layout of ``case``, yielding (delta, info,
    sharded layout) after every delta up to ``upto``."""
    _, assign, gran, hubs, threshold = case
    idg = IncrementalDeviceGraph(g.n, n_blocks=NB, mesh=_mesh(), assignment=_assignment(assign))
    for d, delta in enumerate(deltas[:None if upto is None else upto + 1]):
        _, info = idg.apply(delta)
        sdg = idg.as_sharded(halo=True, halo_granularity=gran, hubs=_hubs(HubConfig, hubs),
                             **_threshold_kw(threshold))
        yield idg, d, info, sdg


# --------------------------------------------------------------------------
# the streamed layouts and plans against `repro`'s
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_streamed_layout_and_plan_match_repro_after_every_delta(jax_runs, wiki, case):
    g, deltas = wiki
    want = _load(jax_runs, case[0])
    hub_sets = []
    for idg, d, info, sdg in _stream_case(g, deltas, case):
        pre = f"{d}/"
        assert [info.dirty_blocks, info.repadded, idg.e_max] == want[pre + "info"].tolist()
        for f in ("_blk_dst", "_blk_row", "_blk_w"):
            np.testing.assert_array_equal(getattr(idg, f), want[pre + f], err_msg=f"{f} {d}")
        perm = idg.block_perm if idg.block_perm is not None else np.arange(idg.n_blocks)
        np.testing.assert_array_equal(perm, want[pre + "block_perm"])
        o2s, s2o = block_vertex_perms(perm, idg.block_v)
        if idg.block_perm is not None:
            np.testing.assert_array_equal(idg.o2s, o2s)
            np.testing.assert_array_equal(idg.s2o, s2o)
            assert torch.equal(sdg.o2s_t, torch.from_numpy(o2s.astype(np.int64)))
        assert [idg.b_max_floor, idg.h_max_floor, idg.hub_pad_floor,
                idg.he_max_floor] == want[pre + "floors"].tolist()
        for f in LAYOUT_FIELDS:
            np.testing.assert_array_equal(getattr(sdg, f).numpy(), want[pre + f],
                                          err_msg=f"{f} {d}")
        for f in SPEC_FIELDS:
            v = getattr(sdg.halo, f)
            np.testing.assert_array_equal(np.asarray(-1 if v is None else v),
                                          want[pre + "spec/" + f], err_msg=f"{f} {d}")
        # the resident slabs: each shard's rows equal the host's storage rows
        for s, sh in enumerate(sdg.shards):
            rows = slice(s * sdg.blocks_per_shard, (s + 1) * sdg.blocks_per_shard)
            np.testing.assert_array_equal(sh.blk_dst.numpy(), idg._blk_dst[rows])
        hub_sets.append(set(sdg.halo.hub_ids))
    assert all(a <= b for a, b in zip(hub_sets, hub_sets[1:]))
    if case[3] and case[4] is not None:
        assert hub_sets[-1]


def _draws(algo, want, step):
    if algo == "spinner":
        return lambda st: want[f"draws/{st}/u"]
    if algo == "revolver":
        return lambda st, b: (want[f"draws/{st}/{b}/g"], want[f"draws/{st}/{b}/u"])
    return lambda st, b: want[f"draws/{st}/{b}/u"]


@pytest.mark.parametrize("leg", LEGS, ids=[leg[0] for leg in LEGS])
def test_supersteps_on_the_streamed_layout_match_repro(jax_runs, wiki, leg):
    """From `repro`'s state at seed 0 on the layout after the leg's delta,
    STEPS supersteps with its draws replayed: every state field bit-equal
    after each (probabilities within K2's tolerance, as
    tests/test_torch_hubs.py holds them), the score within rtol 1e-6. The
    async leg runs the stream's staleness policy at bound 1."""
    name, algo, case_name, delta, schedule, staleness = leg
    want = _load(jax_runs, name)
    case = next(c for c in CASES if c[0] == case_name)
    g, deltas = wiki
    *_, sdg = list(_stream_case(g, deltas, case, upto=delta))[-1]
    alg = get_algorithm(algo)
    cfg = alg.config_cls(k=K, chunk_schedule=schedule,
                         **({"staleness_bound": staleness} if schedule == "async" else {}))
    init = {f[5:]: v for f, v in want.items() if f.startswith("init/")}
    state = engine.place_state(alg, _CONVERT[algo](dict(init, step=0), "cpu", seed=0), sdg)
    draws = _draws(algo, want, 0)
    policy = AsyncStaleness(alg, cfg, draws=draws) if schedule == "async" else None
    for step in range(STEPS):
        if policy is not None:
            state = policy.step(sdg, state)
        else:
            state = engine.superstep(alg, sdg, cfg, state, draws=draws)
        for f in _FIELDS[algo]:
            got, ref = getattr(state, f).numpy(), want[f"step{step}/{f}"]
            if f == "probs":
                np.testing.assert_allclose(got, ref, atol=5e-6, rtol=5e-5,
                                           err_msg=f"{name} step {step}")
            else:
                np.testing.assert_array_equal(got, ref, err_msg=f"{f}: {name} step {step}")
        np.testing.assert_allclose(float(state.score), float(want[f"step{step}/score"]),
                                   rtol=1e-6)
    if policy is not None:
        assert policy.last_refresh == 2      # steps 0 and 2 refreshed, 1 reused


# --------------------------------------------------------------------------
# the stream end to end, its counters and causes, against `repro`'s
# --------------------------------------------------------------------------
class _NotingTracer(Tracer):
    def __init__(self):
        super().__init__()
        self.noted = []

    def note_recompile_cause(self, cause):
        self.noted.append(cause)
        super().note_recompile_cause(cause)


def test_halo_hub_stream_quality_and_names_match_repro(jax_runs, wiki):
    """4-shard halo with hubs over seeds 0-2: mean local_edges >= 0.97x
    `repro`'s mean, max_norm_load <= 1.30; seed 0 traced carries `repro`'s
    counter names, the causes it notes and its hub counts."""
    with open(os.path.join(jax_runs, "e2e.json")) as f:
        want = json.load(f)
    g, deltas = wiki
    runs, tracer = [], _NotingTracer()
    for seed in range(3):
        r = StreamRunner(g.n, StreamConfig(**E2E_CFG), seed=seed, device="cpu", mesh=_mesh(),
                         trace=tracer if seed == 0 else None, **E2E_KW)
        r.run(deltas)
        runs.append(r)
    le = np.mean([r.reports[-1].local_edges for r in runs])
    le_ref = np.mean([x["local_edges"] for x in want["runs"]])
    assert le >= 0.97 * le_ref, (le, le_ref)
    assert all(r.reports[-1].max_norm_load <= 1.30 for r in runs)
    doc = tracer.to_dict()
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "C"} - {"recompiles"}
    assert sorted(names) == want["counters"]
    assert tracer.noted == want["causes"]
    assert [v for _, v in tracer.series["hub_count"]] == want["hub_count"]
    assert [run["schedule"] for run in tracer.meta["runs"]] == ["halo"] * DELTAS
    assert all(rep.upload_bytes > 0 and rep.plan_s > 0 for rep in runs[0].reports)


# --------------------------------------------------------------------------
# `repro`'s in-process stream tests (tests/test_halo.py, tests/test_sharded.py,
# tests/test_faults.py), for the port
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def sbm_graph():
    return dc_sbm(1024, 8192, n_comm=16, mixing=0.25, degree_exponent=0.5, seed=3)


SMALL = dict(k=4, n_blocks=8, refine_max_steps=4, refine_patience=10_000, sync_every=2)


@pytest.mark.parametrize("schedule", ["halo", "sharded"])
def test_one_shard_stream_matches_sequential(sbm_graph, schedule):
    cfg = StreamConfig(**SMALL)
    r_seq = StreamRunner(sbm_graph.n, cfg, seed=0, device="cpu")
    r_one = StreamRunner(sbm_graph.n, cfg, seed=0, device="cpu", chunk_schedule=schedule,
                         mesh=_mesh(1))
    for delta in stream_from_graph(sbm_graph, 3, seed=0):
        a, b = r_seq.ingest(delta), r_one.ingest(delta)
        assert (a.steps, a.local_edges, a.max_norm_load) == (b.steps, b.local_edges,
                                                             b.max_norm_load)
    np.testing.assert_array_equal(r_seq.labels, r_one.labels)
    np.testing.assert_array_equal(r_seq.probs, r_one.probs)


def _host_metrics(g, labels, k):
    src, dst = edge_split(g)
    le = float(np.mean(labels[src] == labels[dst]))
    loads = np.bincount(labels, weights=g.deg_out, minlength=k)
    return le, float(loads.max() / (g.m / k))


def test_permuted_stream_carries_state_in_original_order(sbm_graph):
    """Under a permutation of order 8 (not an involution) on 4 shards the
    carried labels are in original vertex order: the host metrics of the
    carried labels on the original graph equal the reported ones; a delta
    refined 0 supersteps carries labels and probabilities through its warm
    start unchanged; and quality tracks the unpermuted stream (`repro`'s
    check)."""
    cfg = StreamConfig(**SMALL)
    perm = np.roll(np.arange(8), 3)
    r_ref = StreamRunner(sbm_graph.n, cfg, seed=0, device="cpu")
    r_perm = StreamRunner(sbm_graph.n, cfg, seed=0, device="cpu", chunk_schedule="halo",
                          mesh=_mesh(), assignment=perm)
    deltas = list(stream_from_graph(sbm_graph, 3, seed=0))
    for delta in deltas:
        last_ref, last = r_ref.ingest(delta), r_perm.ingest(delta)
    assert r_perm.idg.block_perm is not None
    g = r_perm.idg.graph
    le, ml = _host_metrics(g, r_perm.labels, cfg.k)
    assert le == pytest.approx(last.local_edges, abs=1e-6)
    assert ml == pytest.approx(last.max_norm_load, rel=1e-6)
    assert last.local_edges == pytest.approx(last_ref.local_edges, abs=0.08)
    labels, probs = r_perm.labels.copy(), r_perm.probs.copy()
    rep = r_perm.ingest(deltas[-1], max_steps=0)
    assert rep.steps == 0
    np.testing.assert_array_equal(r_perm.labels, labels)
    np.testing.assert_array_equal(r_perm.probs, probs)


def test_stream_locality_requires_mesh_and_is_decided_once(sbm_graph, monkeypatch):
    with pytest.raises(ValueError, match="mesh"):
        IncrementalDeviceGraph(64, assignment="locality", device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        IncrementalDeviceGraph(64, assignment=np.arange(8), device="cpu")
    calls = []
    order = delta_mod.locality_block_order
    monkeypatch.setattr(delta_mod, "locality_block_order",
                        lambda *a: calls.append(1) or order(*a))
    idg = IncrementalDeviceGraph(sbm_graph.n, n_blocks=8, mesh=_mesh(), assignment="locality")
    assert not idg.perm_decided
    for delta in stream_from_graph(sbm_graph, 3, seed=0):
        idg.apply(delta)
        assert idg.perm_decided
    assert len(calls) == 1


def test_stream_floors_and_hub_set_are_monotonic(sbm_graph):
    idg = IncrementalDeviceGraph(sbm_graph.n, n_blocks=8, mesh=_mesh())
    prev = (0, 0, 0, 0)
    prev_ids = set()
    for delta in stream_from_graph(sbm_graph, 4, seed=0):
        idg.apply(delta)
        sdg = idg.as_sharded(halo=True, halo_threshold=2.0, halo_granularity="vertex",
                             hubs=HubConfig(quantile=0.95))
        spec = sdg.halo
        now = (spec.b_max, spec.h_max, spec.hub_pad, spec.he_max)
        assert all(a >= b for a, b in zip(now, prev))
        assert (spec.h_max, spec.hub_pad) == (idg.h_max_floor, idg.hub_pad_floor)
        assert prev_ids <= set(spec.hub_ids)
        prev, prev_ids = now, set(spec.hub_ids)
    assert prev_ids


def test_streamed_permuted_layout_matches_static(sbm_graph):
    """Streaming a whole graph as one delta under an explicit permutation
    reproduces `shard_device_graph`'s permuted layout field for field (the
    slabs up to their padded width)."""
    g = sbm_graph
    perm = np.roll(np.arange(8), 3)
    mesh = _mesh()
    idg = IncrementalDeviceGraph(g.n, n_blocks=8, mesh=mesh, assignment=perm)
    (delta,) = stream_from_graph(g, 1, seed=0)
    idg.apply(delta)
    streamed = idg.as_sharded()
    static = shard_device_graph(prepare_device_graph(g, n_blocks=8, device="cpu"), mesh,
                                assignment=perm)
    assert (streamed.block_v, streamed.n_blocks) == (static.block_v, static.n_blocks)
    assert streamed.block_perm == static.block_perm
    for f in LAYOUT_FIELDS:
        assert torch.equal(getattr(streamed, f), getattr(static, f)), f
    for b in range(static.n_blocks):
        cnt = int(static.blk_row_ptr[b, -1])
        for f in ("blk_dst", "blk_row", "blk_w", "blk_row_ptr"):
            got, ref = getattr(streamed, f)[b], getattr(static, f)[b]
            n = cnt if f != "blk_row_ptr" else ref.shape[0]
            assert torch.equal(got[:n], ref[:n]), (f, b)
    assert torch.equal(streamed.o2s_t, static.o2s_t)


def test_stream_resume_bit_identical_under_halo_hubs_and_a_permutation(wiki, tmp_path):
    """`repro`'s stream resume (tests/test_faults.py), under halo with hubs
    on 4 shards and an explicit permutation: a runner checkpointed every
    delta, dropped after delta 2 and resumed in a new one ends bit-equal to
    the uninterrupted stream, its floors, hub set and permutation restored."""
    g, deltas = wiki
    kw = dict(seed=5, device="cpu", mesh=_mesh(), assignment=PERM, **E2E_KW)
    cfg = StreamConfig(k=K, n_blocks=NB, refine_max_steps=8, sync_every=2)
    ref = StreamRunner(g.n, cfg, **kw)
    floors = []
    for delta in deltas:
        ref.ingest(delta)
        i = ref.idg
        floors.append((i.b_max_floor, i.h_max_floor, i.hub_pad_floor, i.he_max_floor,
                       i.hub_ids))
    r1 = StreamRunner(g.n, cfg, checkpoint_dir=str(tmp_path), **kw)
    for delta in deltas[:3]:
        r1.ingest(delta)
    r1.finish()
    r2 = StreamRunner(g.n, cfg, checkpoint_dir=str(tmp_path), resume=True, **kw)
    i = r2.idg
    assert r2.delta_base == 3
    assert (i.b_max_floor, i.h_max_floor, i.hub_pad_floor, i.he_max_floor,
            i.hub_ids) == floors[2]
    assert floors[2][4] and i.perm_decided
    np.testing.assert_array_equal(i.block_perm, PERM)
    reports = r2.run(deltas)
    r2.finish()
    assert [r.delta_idx for r in reports] == [3, 4]
    np.testing.assert_array_equal(ref.labels, r2.labels)
    np.testing.assert_array_equal(ref.probs, r2.probs)
    assert ref.total_steps == r2.total_steps


def test_stream_async_runs_with_a_stale_tail(sbm_graph):
    """Async at staleness 0 is bit-equal to halo on the same stream; at
    staleness 1 it reuses a tail every other superstep, counted across the
    stream, and refreshes at each delta's first superstep (a new layout)."""
    cfg = StreamConfig(**dict(SMALL, refine_max_steps=3))
    kw = dict(seed=0, device="cpu", mesh=_mesh(), halo_threshold=2.0,
              halo_granularity="vertex")
    runs, tracer = {}, Tracer()
    for name, extra in (("halo", dict(chunk_schedule="halo")),
                        ("async0", dict(chunk_schedule="async")),
                        ("async1", dict(chunk_schedule="async", staleness_bound=1,
                                        trace=tracer))):
        r = StreamRunner(sbm_graph.n, cfg, **kw, **extra)
        r.run(stream_from_graph(sbm_graph, 3, seed=0))
        runs[name] = r
    np.testing.assert_array_equal(runs["halo"].labels, runs["async0"].labels)
    np.testing.assert_array_equal(runs["halo"].probs, runs["async0"].probs)
    stale = runs["async1"]
    assert stale._async.g == stale.total_steps == 9
    # 3 supersteps a delta: g 0-2, 3-5, 6-8; g 3 refreshes for its new layout
    assert [v for _, v in tracer.series["halo_staleness"]] == [0, 1, 0, 0, 0, 1, 0, 1, 0]
    assert [r["schedule"] for r in tracer.meta["runs"]] == ["async"] * 3
    assert not np.array_equal(stale.labels, runs["halo"].labels)


def test_replicated_shard_slabs_stay_views_and_dirty_rows_move(sbm_graph):
    """On a mesh that repeats one device the shard slabs are views of the
    home layout's; a delta touching one block moves that block's slab row
    and the per-vertex arrays, not the other rows."""
    idg = IncrementalDeviceGraph(sbm_graph.n, n_blocks=8, mesh=_mesh(),
                                 assignment=np.roll(np.arange(8), 3))
    for delta in stream_from_graph(sbm_graph, 2, seed=0):
        idg.apply(delta)
    full = idg.upload_bytes
    sdg = idg.as_sharded()
    home = sdg.dg.blk_dst
    for s, sh in enumerate(sdg.shards):
        assert sh.blk_dst.untyped_storage().data_ptr() == home.untyped_storage().data_ptr()
    src, dst = edge_split(sbm_graph)
    bv = idg.block_v
    e = np.flatnonzero((src // bv == 2) & (dst // bv == 2))[0]
    empty = np.empty(0, np.int32)
    before = idg._blk_dst.copy()
    _, info = idg.apply(delta_mod.EdgeDelta(empty, empty, src[e:e + 1], dst[e:e + 1]))
    assert info.dirty_blocks == 1 and not info.repadded
    row = int(idg._pos[2])
    changed = np.flatnonzero((idg._blk_dst != before).any(axis=1))
    assert changed.tolist() == [row]
    slab_row = idg.e_max * 12 + (bv + 1) * 4
    assert slab_row < idg.upload_bytes < full


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1]))
