"""The port's streaming subsystem against `repro.streaming` on the CPU:
the stream front door, the host-side incremental graph, the incremental
device layout (its row pointer and span plan after every delta), supersteps
on that layout with `repro`'s replayed draws, and the `StreamRunner` end to
end, in distribution over seeds (torch's generator cannot replay JAX's
threefry streams)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core.revolver import (
    RevolverConfig as JaxConfig,
    revolver_init as jax_init,
    revolver_superstep as jax_superstep,
)
from repro.graphs.datasets import load_dataset as jax_load_dataset
from repro.graphs.generators import dc_sbm as jax_dc_sbm
from repro import streaming as jax_streaming

from repro_torch.core.convert import revolver_state_from_numpy
from repro_torch.core.device_graph import device_graph_from_numpy
from repro_torch.core.revolver import RevolverConfig, revolver_superstep
from repro_torch.graphs import load_dataset
from repro_torch.graphs.generators import edge_split
from repro_torch import streaming as torch_streaming
from repro_torch.streaming import (
    EdgeDelta,
    IncrementalDeviceGraph,
    IncrementalGraph,
    StreamConfig,
    StreamRunner,
    stream_from_graph,
)
from test_torch_superstep import replayed_draws

# the reference's streaming test graph (tests/test_streaming.py)
SBM = dict(n=512, m=4096, n_comm=8, mixing=0.3, degree_exponent=0.5, seed=1)
# the reference's end-to-end stream (tests/test_streaming.py)
E2E_CFG = dict(k=8, refine_max_steps=15, refine_patience=3, sync_every=2, warm_sharpen=0.5)
LAYOUT_FIELDS = ("blk_dst", "blk_row", "blk_w", "deg_out", "inv_wsum", "vmask",
                 "dir_src", "dir_dst")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These runs are many small CPU ops: torch's intra-op threads buy
    little here and contend with the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sbm():
    return jax_dc_sbm(**SBM)


def to_jax(delta: EdgeDelta):
    return jax_streaming.EdgeDelta(*delta)


def assert_same_delta(got, want):
    for f in EdgeDelta._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def mixed_stream(g, seed: int = 0):
    """Deltas with inserts, duplicates, self loops, deletions of present and
    absent edges, and edges deleted then re-added within one delta: a bulk
    load of half the edges, a growth delta, a deletion delta, the rest of
    the edges (re-pads)."""
    rng = np.random.default_rng(seed)
    src, dst = edge_split(g)
    perm = rng.permutation(g.m)
    src, dst = src[perm], dst[perm]
    half = g.m // 2
    cat = np.concatenate
    dup = rng.choice(half, 200, replace=False)
    loops = rng.integers(0, g.n, 40).astype(np.int32)
    gone = rng.choice(half, 300, replace=False)
    absent_src = rng.integers(0, g.n, 60).astype(np.int32)
    absent_dst = rng.integers(0, g.n, 60).astype(np.int32)
    grow = slice(half, half + 900)
    return [
        EdgeDelta.inserts(src[:half], dst[:half]),
        EdgeDelta.inserts(cat([src[grow], src[dup], loops]), cat([dst[grow], dst[dup], loops])),
        EdgeDelta(add_src=cat([src[gone[:80]], src[half + 900:half + 1000]]),
                  add_dst=cat([dst[gone[:80]], dst[half + 900:half + 1000]]),
                  del_src=cat([src[gone], absent_src]), del_dst=cat([dst[gone], absent_dst])),
        EdgeDelta.inserts(src[half + 1000:], dst[half + 1000:]),
    ]


# --------------------------------------------------------------------------
# the stream front door
# --------------------------------------------------------------------------
def buffer_script(module):
    """A push/pop sequence whose second window is cut at a deletion of an
    edge inserted earlier in it, with a deletion riding along and a
    re-insert after the cut."""
    buf = module.StreamBuffer(delta_size=6, n=16)
    buf.push(np.arange(3), np.arange(3) + 1)
    buf.push(9, 10, delete=True)
    buf.push(np.arange(4, 9), np.arange(4, 9) + 2)
    out = [buf.pop_delta()]
    buf.push(np.array([11, 12]), np.array([13, 14]))
    buf.push(np.array([11]), np.array([13]), delete=True)   # inserted in this window
    buf.push(11, 13)
    buf.push(np.arange(5), np.arange(5) + 7)
    out.append(buf.pop_delta())
    while (d := buf.flush()) is not None:
        out.append(d)
    return out


def test_stream_buffer_emits_reference_deltas():
    got, want = buffer_script(torch_streaming), buffer_script(jax_streaming)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert_same_delta(a, b)
    # the second window was cut before the deletion of (11, 13), which
    # leads the third, with the re-insert after it
    assert got[1].n_add == 4 and got[1].n_del == 0
    assert got[2].n_del == 1 and got[2].n_add == 6


@pytest.mark.parametrize("order,n_deltas", [("timestamp", 5), ("arrival", 3), ("timestamp", 1)])
def test_stream_from_graph_matches_reference(sbm, order, n_deltas):
    got = list(stream_from_graph(sbm, n_deltas, order=order, seed=4))
    want = list(jax_streaming.stream_from_graph(sbm, n_deltas, order=order, seed=4))
    assert len(got) == len(want) == n_deltas
    for a, b in zip(got, want):
        assert_same_delta(a, b)


def test_stream_buffer_validation_matches_reference():
    for module in (jax_streaming, torch_streaming):
        with pytest.raises(ValueError):
            module.StreamBuffer(delta_size=0)
        buf = module.StreamBuffer(delta_size=4, n=8)
        for bad in ((np.arange(3), np.arange(4)), ([0.5], [1.0]), ([-1], [2]), ([3], [8])):
            with pytest.raises(ValueError):
                buf.push(*bad)


# --------------------------------------------------------------------------
# the host graph and the device layout
# --------------------------------------------------------------------------
def test_incremental_graph_matches_reference_after_every_delta(sbm):
    ours, ref = IncrementalGraph(sbm.n), jax_streaming.IncrementalGraph(sbm.n)
    for delta in mixed_stream(sbm):
        a, b = ours.apply(delta), ref.apply(to_jax(delta))
        for f in dataclasses.fields(b):
            np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name),
                                          err_msg=f.name)
        for f in ("dir_keys", "sym_keys", "sym_w"):
            x, y = getattr(ours, f), getattr(ref, f)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y, err_msg=f)
    with pytest.raises(ValueError, match="delta 4"):
        ours.apply(EdgeDelta.inserts(np.array([0], np.int32), np.array([sbm.n], np.int32)))


def layouts(g, deltas, n_blocks=4):
    """(port DeviceGraph, repro DeviceGraph as numpy, port info, repro info)
    after every delta."""
    ours = IncrementalDeviceGraph(g.n, n_blocks=n_blocks, device="cpu")
    ref = jax_streaming.IncrementalDeviceGraph(g.n, n_blocks=n_blocks)
    for delta in deltas:
        dg, info = ours.apply(delta)
        dg_ref, info_ref = ref.apply(to_jax(delta))
        yield ours, dg, jax.device_get(dg_ref._asdict()), dg_ref, info, info_ref


def test_incremental_device_graph_matches_reference_after_every_delta(sbm):
    """Slabs, e_max, dirty blocks, re-pads, the per-vertex arrays and the
    flat edges equal `repro`'s after every delta; the row pointer and the
    span plan equal what a fresh layout derives from those arrays (a plan
    left from an earlier delta would not)."""
    repads = 0
    for _, dg, want, _, info, info_ref in layouts(sbm, mixed_stream(sbm)):
        assert (dg.e_max, dg.n_pad, dg.m, dg.n_blocks, dg.block_v) == (
            want["e_max"], want["n_pad"], want["m"], want["n_blocks"], want["block_v"])
        assert (info.dirty_blocks, info.repadded) == (info_ref.dirty_blocks, info_ref.repadded)
        for f in LAYOUT_FIELDS:
            np.testing.assert_array_equal(getattr(dg, f).numpy(), want[f], err_msg=f)
        fresh = device_graph_from_numpy(want, "cpu")
        assert torch.equal(dg.blk_row_ptr, fresh.blk_row_ptr)
        assert torch.equal(dg.blk_spans.spans, fresh.blk_spans.spans)
        assert torch.equal(dg.blk_spans.hubs, fresh.blk_spans.hubs)
        repads += info.repadded
    assert repads == 2      # the bulk load and the last delta


def test_a_delta_in_one_block_rewrites_only_that_block(sbm):
    idg = IncrementalDeviceGraph(sbm.n, n_blocks=4, device="cpu")
    for delta in stream_from_graph(sbm, 2, seed=0):
        dg, _ = idg.apply(delta)
    before = {f: getattr(dg, f).clone() for f in ("blk_dst", "blk_row", "blk_w", "blk_row_ptr")}
    plan_before = dg.blk_spans.spans.clone()
    # delete one edge with both ends in block 2
    src, dst = edge_split(sbm)
    lo, hi = 2 * dg.block_v, 3 * dg.block_v
    e = np.flatnonzero((src >= lo) & (src < hi) & (dst >= lo) & (dst < hi))[0]
    dg2, info = idg.apply(EdgeDelta(np.empty(0, np.int32), np.empty(0, np.int32),
                                    src[e:e + 1], dst[e:e + 1]))
    assert info.deleted == 1 and info.dirty_blocks == 1 and not info.repadded
    assert dg2.blk_dst.data_ptr() == dg.blk_dst.data_ptr()     # resident slabs
    others = [0, 1, 3]
    for f, t in before.items():
        assert torch.equal(getattr(dg2, f)[others], t[others]), f
        assert not torch.equal(getattr(dg2, f)[2], t[2]), f
    assert torch.equal(dg2.blk_spans.spans[others], plan_before[others])


@pytest.mark.parametrize("weight_mode", ["self_lambda", "neighbor_lambda"])
def test_supersteps_on_the_incremental_layout_match_reference(sbm, weight_mode):
    """After the deletion delta and after a re-pad (the last delta), 3
    supersteps from one state with `repro`'s replayed draws: labels,
    lambda and loads bit-equal, the score within 1e-6 (the port sums it in
    f64, as tests/test_torch_superstep.py holds it)."""
    k, steps = 4, 3
    checked = []
    for idx, (_, dg, want, dg_ref, info, _) in enumerate(layouts(sbm, mixed_stream(sbm))):
        if idx not in (2, 3):
            continue
        assert info.deleted > 0 if idx == 2 else info.repadded
        cfg = JaxConfig(k=k, weight_mode=weight_mode)
        st = jax_init(dg_ref, cfg, jax.random.PRNGKey(idx))
        st_t = revolver_state_from_numpy(jax.device_get(st._asdict()), "cpu", seed=0)
        cfg_t = RevolverConfig(k=k, weight_mode=weight_mode)
        draws = replayed_draws(st.key, steps, dg.n_blocks, dg.block_v, k)
        labels0 = st_t.labels.clone()
        for step in range(steps):
            st = jax_superstep(dg_ref, cfg, st)
            st_t = revolver_superstep(dg, cfg_t, st_t, draws=draws)
            got = jax.device_get(st._asdict())
            for name in ("labels", "lam", "loads"):
                np.testing.assert_array_equal(getattr(st_t, name).numpy(), got[name],
                                              err_msg=f"{name} after delta {idx} step {step}")
            np.testing.assert_allclose(float(st_t.score), float(got["score"]), rtol=1e-6)
        assert (st_t.labels != labels0).any()
        checked.append(idx)
    assert checked == [2, 3]


@pytest.fixture(scope="module")
def one_shard_meshes():
    """A 1-shard mesh of each package (`repro` runs in-process on one host
    device)."""
    from repro.launch.mesh import make_blocks_mesh as jax_mesh
    from repro_torch.launch.mesh import BlocksMesh

    return jax_mesh(1), BlocksMesh(["cpu"])


def test_as_sharded_halo_matches_reference(sbm, one_shard_meshes):
    """`IncrementalDeviceGraph(mesh=...).as_sharded(halo=True)` after every
    delta of the mixed stream: the host slabs and the halo plan equal
    `repro`'s."""
    jmesh, mesh = one_shard_meshes
    ours = IncrementalDeviceGraph(sbm.n, n_blocks=4, mesh=mesh)
    ref = jax_streaming.IncrementalDeviceGraph(sbm.n, n_blocks=4, mesh=jmesh)
    for delta in mixed_stream(sbm):
        ours.apply(delta)
        ref.apply(to_jax(delta))
        a, b = ours.as_sharded(halo=True), ref.as_sharded(halo=True)
        for f in ("_blk_dst", "_blk_row", "_blk_w"):
            np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f), err_msg=f)
        for f in ("b_max", "h_max", "coverage", "fallback", "granularity", "blk_dst_halo"):
            np.testing.assert_array_equal(getattr(a.halo, f), getattr(b.halo, f), err_msg=f)
        assert (a.n_shards, a.blocks_per_shard) == (b.n_shards, b.blocks_per_shard)


# --------------------------------------------------------------------------
# StreamRunner
# --------------------------------------------------------------------------
# --------------------------------------------------------------------------
# StreamRunner
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def wiki_streams():
    """The reference's end-to-end stream (WIKI 0.002, 5 deltas), run by
    `repro` over seeds 0-2 and by the port over seeds 0-2 and seed 0 again."""
    g_ref = jax_load_dataset("WIKI", scale=0.002, seed=0)
    g = load_dataset("WIKI", scale=0.002, seed=0)
    ref, ours = [], []
    for seed in range(3):
        r = jax_streaming.StreamRunner(g_ref.n, jax_streaming.StreamConfig(**E2E_CFG), seed=seed)
        r.run(jax_streaming.stream_from_graph(g_ref, 5, seed=0))
        ref.append(r)
    for seed in (0, 1, 2, 0):
        r = StreamRunner(g.n, StreamConfig(**E2E_CFG), seed=seed, device="cpu")
        r.run(stream_from_graph(g, 5, seed=0))
        ours.append(r)
    return g, ref, ours


def test_stream_runner_quality_matches_reference(wiki_streams):
    g, ref, ours = wiki_streams
    le = np.mean([r.reports[-1].local_edges for r in ours[:3]])
    le_ref = np.mean([r.reports[-1].local_edges for r in ref])
    assert le >= 0.97 * le_ref, (le, le_ref)
    assert all(r.reports[-1].max_norm_load <= 1.30 for r in ours)
    steps = np.mean([r.total_steps for r in ours[:3]])
    steps_ref = np.mean([r.total_steps for r in ref])
    assert 0.5 * steps_ref <= steps <= 1.5 * steps_ref, (steps, steps_ref)
    for r in ours:
        assert [x.m for x in r.reports] == [x.m for x in ref[0].reports]
        assert r.reports[-1].m == g.m and r.labels.shape == (g.n,)


def test_stream_runner_same_seed_gives_equal_reports(wiki_streams):
    _, _, ours = wiki_streams
    a, b = ours[0], ours[3]

    def key(rep):
        return {f: v for f, v in dataclasses.asdict(rep).items() if f not in ("wall_s", "merge_s")}
    assert [key(x) for x in a.reports] == [key(x) for x in b.reports]
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.probs, b.probs)
    assert [key(x) for x in a.reports] != [key(x) for x in ours[1].reports]


@pytest.mark.parametrize("algo,restream", [("spinner", False), ("restream", False),
                                           ("revolver", True)])
def test_other_rules_and_restream_mode_run(sbm, algo, restream):
    cfg = StreamConfig(k=4, n_blocks=4, refine_max_steps=6, refine_patience=2,
                       restream=restream)
    runner = StreamRunner(sbm.n, cfg, algo=algo, seed=0, device="cpu")
    reports = runner.run(mixed_stream(sbm))
    assert reports[-1].m == runner.idg.inc.m and reports[2].deleted > 0
    assert all(0.0 <= r.local_edges <= 1.0 and r.steps >= 1 for r in reports)
    if restream:
        # each warm delta replays 4 chunks of 2 supersteps before refining
        assert all(r.steps > 8 for r in reports[1:])
    assert runner.labels.shape == (sbm.n,) and runner.labels.max() < 4


def test_stream_runner_argument_errors_match_reference(sbm):
    for module, kw in ((jax_streaming, {}), (torch_streaming, {"device": "cpu"})):
        Runner, Config = module.StreamRunner, module.StreamConfig
        with pytest.raises(ValueError, match="runs no supersteps"):
            Runner(sbm.n, Config(k=4), algo="hash", **kw)
        with pytest.raises(ValueError, match="LA probabilities"):
            Runner(sbm.n, Config(k=4, restream=True), algo="spinner", **kw)
        with pytest.raises(ValueError, match="LA state"):
            Runner(sbm.n, Config(k=4, warm_sharpen=0.5), algo="restream", **kw)
        with pytest.raises(TypeError):
            Runner(sbm.n, Config(k=4), capacty_mode="x", **kw)
    # the "off" value of each schedule option runs
    assert StreamRunner(sbm.n, StreamConfig(k=4), device="cpu", trace=None, checkpoint_dir=None,
                        mesh=None, chunk_schedule="sequential").deltas_ingested == 0


# the options that raised NotImplementedError until the stream's sharded
# layouts were ported; each on a 1-shard mesh of each package ("MESH")
SHARDED_OPTIONS = {
    "mesh": dict(chunk_schedule="sharded", mesh="MESH"),
    "assignment": dict(chunk_schedule="sharded", mesh="MESH", assignment="locality"),
    "chunk_schedule": dict(chunk_schedule="halo"),
    "halo_granularity": dict(chunk_schedule="halo", mesh="MESH", halo_granularity="vertex"),
    "hub_replication": dict(chunk_schedule="halo", mesh="MESH", halo_threshold=2.0,
                            hub_replication=True, hub_quantile=0.9),
}


@pytest.mark.parametrize("option", list(SHARDED_OPTIONS))
def test_sharded_stream_options_run_and_match_reference(sbm, one_shard_meshes, option):
    """Each option runs the mixed stream in both packages: the merges
    (m, added, deleted, dirty blocks, re-pads), the final host slabs, the
    block permutation and the halo floors equal `repro`'s; labels come back
    in range for every vertex."""
    jmesh, mesh = one_shard_meshes
    cfg = dict(k=4, n_blocks=4, refine_max_steps=6, refine_patience=2)
    kw = SHARDED_OPTIONS[option]
    ours = StreamRunner(sbm.n, StreamConfig(**cfg), seed=0, device="cpu",
                        **{k: (mesh if v == "MESH" else v) for k, v in kw.items()})
    ref = jax_streaming.StreamRunner(sbm.n, jax_streaming.StreamConfig(**cfg), seed=0,
                                     **{k: (jmesh if v == "MESH" else v) for k, v in kw.items()})
    got = ours.run(mixed_stream(sbm))
    want = ref.run([to_jax(d) for d in mixed_stream(sbm)])

    def merges(reports):
        return [(r.m, r.added, r.deleted, r.dirty_blocks, r.repadded) for r in reports]
    assert merges(got) == merges(want)
    a, b = ours.idg, ref.idg
    for f in ("_blk_dst", "_blk_row", "_blk_w"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.block_perm is None) == (b.block_perm is None)
    assert (a.b_max_floor, a.h_max_floor, a.hub_pad_floor, a.hub_ids) == (
        b.b_max_floor, b.h_max_floor, b.hub_pad_floor, b.hub_ids)
    assert ours.labels.shape == (sbm.n,) and 0 <= ours.labels.min() and ours.labels.max() < 4
    assert all(0.0 <= r.local_edges <= 1.0 and r.steps >= 1 for r in got)


@pytest.mark.parametrize("bad,match", [
    (dict(mesh="MESH"), "mesh is only meaningful"),
    (dict(assignment="locality"), "assignment is only meaningful"),
    (dict(chunk_schedule="halo", halo_granularity="blocks"), "halo_granularity="),
    (dict(halo_granularity="vertex"), "halo_granularity is only meaningful"),
    (dict(hub_quantile=0.9), "need hub_replication=True"),
    (dict(chunk_schedule="sharded", hub_replication=True), "rides the halo exchange plan"),
    (dict(chunk_schedule="sharded", mesh="MESH", assignment="elsewhere"), "unknown assignment"),
], ids=["mesh", "assignment", "granularity-name", "granularity-schedule", "hub-knobs",
        "hubs-sharded", "assignment-name"])
def test_sharded_stream_argument_errors_match_reference(sbm, one_shard_meshes, bad, match):
    jmesh, mesh = one_shard_meshes
    for module, kw, m in ((jax_streaming, {}, jmesh), (torch_streaming, {"device": "cpu"}, mesh)):
        with pytest.raises(ValueError, match=match):
            module.StreamRunner(sbm.n, module.StreamConfig(k=4), **kw,
                                **{k: (m if v == "MESH" else v) for k, v in bad.items()})


@pytest.mark.parametrize("option", ["trace", "checkpoint_dir", "resume", "checkpoint_every"])
def test_stream_crash_safety_and_tracing_options_run(sbm, option, tmp_path):
    """The options that raised until tracing and stream checkpoints were
    ported now run and leave the stream as the plain runner's."""
    from repro_torch.obs import Tracer

    cfg = StreamConfig(k=4, n_blocks=4, refine_max_steps=6, refine_patience=2)
    kwargs = {"trace": dict(trace=Tracer()),
              "checkpoint_dir": dict(checkpoint_dir=str(tmp_path)),
              "resume": dict(checkpoint_dir=str(tmp_path), resume=True),
              "checkpoint_every": dict(checkpoint_dir=str(tmp_path), checkpoint_every=2)}[option]
    plain = StreamRunner(sbm.n, cfg, seed=0, device="cpu")
    plain.run(mixed_stream(sbm))
    runner = StreamRunner(sbm.n, cfg, seed=0, device="cpu", **kwargs)
    runner.run(mixed_stream(sbm))
    runner.finish()
    np.testing.assert_array_equal(runner.labels, plain.labels)
    np.testing.assert_array_equal(runner.probs, plain.probs)
    assert runner.total_steps == plain.total_steps
    saved = sorted(p.name for p in tmp_path.iterdir())
    n = len(plain.reports)
    if option == "trace":
        assert kwargs["trace"].summary()["spans"]["delta"]["count"] == n
    elif option == "checkpoint_every":
        assert saved == [f"step_{d:08d}" for d in range(2, n + 1, 2)][-2:]
    else:
        assert saved == [f"step_{d:08d}" for d in (n - 1, n)]
        assert runner.delta_base == 0       # resume with nothing on disk: fresh


def test_stream_runner_defaults_to_cuda(sbm, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamRunner(sbm.n, StreamConfig(k=4))
