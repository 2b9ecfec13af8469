"""The port's core math against `repro`'s on the same numpy inputs: LP
scoring, the LA updates, the metrics, capacity and the device layout."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import device_graph as jdg
from repro.core import la as jla
from repro.core import lp as jlp
from repro.core import metrics as jmetrics
from repro.graphs import load_dataset

from repro_torch.core import device_graph as tdg
from repro_torch.core import la as tla
from repro_torch.core import lp as tlp
from repro_torch.core import metrics as tmetrics
from repro_torch.core.convert import device_graph_from_numpy
from repro_torch.graphs.blocking import slab_row_ptr, slab_span_plan

# LA updates: k sequential passes in f32 whose final renormalization sum may
# be reduced in another order — the tolerance tests/test_kernels.py:134
# holds the Pallas kernel to
LA_TOL = dict(atol=5e-6, rtol=5e-5)


def t(a):
    return torch.from_numpy(np.array(a))


def n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_edge_histogram_matches_reference():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 50, 3000).astype(np.int32)
    slots = rng.integers(0, 6, 3000).astype(np.int32)
    vals = rng.integers(0, 3, 3000).astype(np.float32)
    got = tlp.edge_histogram(t(rows), t(slots), t(vals), 50, 6)
    want = jlp.edge_histogram_jnp(jnp.asarray(rows), jnp.asarray(slots),
                                  jnp.asarray(vals), 50, 6)
    np.testing.assert_array_equal(n(got), n(want))


@pytest.mark.parametrize("loads", [
    [10.0, 20.0, 30.0, 40.0],     # all under capacity
    [10.0, 120.0, 30.0, 5.0],     # one over capacity: footnote-1 shift
    [110.0, 110.0, 110.0, 110.0],  # all equal and over: uniform fallback
])
def test_normalized_penalty_and_scores_match_reference(loads):
    loads = np.array(loads, np.float32)
    cap = np.float32(100.0)
    np.testing.assert_array_equal(
        n(tlp.normalized_penalty(t(loads), torch.tensor(cap))),
        n(jlp.normalized_penalty(jnp.asarray(loads), jnp.asarray(cap))))
    rng = np.random.default_rng(1)
    hist = rng.integers(0, 5, (32, 4)).astype(np.float32)
    inv_wsum = (1.0 / rng.integers(1, 9, 32)).astype(np.float32)
    np.testing.assert_array_equal(
        n(tlp.revolver_scores(t(hist), t(inv_wsum), t(loads), torch.tensor(cap))),
        n(jlp.revolver_scores(jnp.asarray(hist), jnp.asarray(inv_wsum),
                              jnp.asarray(loads), jnp.asarray(cap))))
    np.testing.assert_array_equal(
        n(tlp.tau_term(t(hist), t(inv_wsum))),
        n(jlp.tau_term(jnp.asarray(hist), jnp.asarray(inv_wsum))))


def _la_inputs(v=64, k=6, seed=2):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.ones(k), v).astype(np.float32)
    w_raw = rng.integers(0, 6, (v, k)).astype(np.float32)
    return p, w_raw


def test_split_weights_and_signals_matches_reference():
    _, w_raw = _la_inputs()
    got = tla.split_weights_and_signals(t(w_raw))
    want = jla.split_weights_and_signals(jnp.asarray(w_raw))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(n(a), n(b))


@pytest.mark.parametrize("pass_order", ["penalty_first", "ascending"])
def test_weighted_la_update_matches_reference(pass_order):
    p, w_raw = _la_inputs()
    w, r = (np.array(a) for a in jla.split_weights_and_signals(jnp.asarray(w_raw)))
    got = tla.weighted_la_update(t(p), t(w), t(r), 1.0, 0.1, pass_order=pass_order)
    want = jla.weighted_la_update(jnp.asarray(p), jnp.asarray(w), jnp.asarray(r),
                                  1.0, 0.1, pass_order=pass_order)
    np.testing.assert_allclose(n(got), n(want), **LA_TOL)


def test_classic_la_update_matches_reference():
    p, _ = _la_inputs()
    rng = np.random.default_rng(3)
    action = rng.integers(0, p.shape[1], p.shape[0]).astype(np.int32)
    penalty = rng.integers(0, 2, p.shape[0]).astype(np.float32)
    got = tla.classic_la_update(t(p), t(action), t(penalty), 0.5, 0.1)
    want = jla.classic_la_update(jnp.asarray(p), jnp.asarray(action),
                                 jnp.asarray(penalty), 0.5, 0.1)
    np.testing.assert_allclose(n(got), n(want), **LA_TOL)


def test_metrics_match_reference():
    g = load_dataset("WIKI", scale=0.0005)
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 5, g.n).astype(np.int32)
    src = np.repeat(np.arange(g.n, dtype=np.int32), np.diff(g.row_ptr))
    deg = g.deg_out.astype(np.float32)
    np.testing.assert_array_equal(
        n(tmetrics.partition_loads(t(labels), t(deg), 5)),
        n(jmetrics.partition_loads(jnp.asarray(labels), jnp.asarray(deg), 5)))
    for fn in ("local_edges", "edge_cuts"):
        np.testing.assert_allclose(
            float(getattr(tmetrics, fn)(t(labels), t(src), t(g.col_idx))),
            float(getattr(jmetrics, fn)(jnp.asarray(labels), jnp.asarray(src),
                                        jnp.asarray(g.col_idx))), rtol=1e-6)
    np.testing.assert_allclose(
        float(tmetrics.max_normalized_load(t(labels), t(deg), 5)),
        float(jmetrics.max_normalized_load(jnp.asarray(labels), jnp.asarray(deg), 5)),
        rtol=1e-6)


@pytest.mark.parametrize("mode", ["spinner", "paper"])
def test_capacity_matches_reference(mode):
    assert tdg.capacity(28510, 8, 0.05, mode) == jdg.capacity(28510, 8, 0.05, mode)
    cap = tdg.capacity_device(28510, 8, 0.05, mode, torch.device("cpu"))
    assert cap.dtype == torch.float32 and cap.shape == ()
    assert float(cap) == float(jdg.capacity_device(28510, 8, 0.05, mode))
    with pytest.raises(ValueError, match="capacity mode"):
        tdg.capacity(10, 2, 0.05, "bogus")


@pytest.mark.parametrize("n_blocks", [1, 8])
def test_prepare_device_graph_matches_reference(n_blocks):
    g = load_dataset("WIKI", scale=0.0005)
    got = tdg.prepare_device_graph(g, n_blocks=n_blocks, device="cpu")
    want = jax.device_get(jdg.prepare_device_graph(g, n_blocks=n_blocks)._asdict())
    ours = {f.name for f in dataclasses.fields(got)}
    # the flat symmetrized adjacency has no reader in either package
    assert set(want) - ours == {"edge_src", "edge_dst", "edge_w"}
    for name in ours - {"blk_row_ptr", "blk_spans"}:
        mine, value = getattr(got, name), want[name]
        if isinstance(mine, torch.Tensor):
            np.testing.assert_array_equal(mine.numpy(), value, err_msg=name)
            assert mine.numpy().dtype == value.dtype, name
        else:
            assert mine == value, name
    np.testing.assert_array_equal(
        got.blk_row_ptr.numpy(),
        slab_row_ptr(want["blk_row"], want["blk_w"], want["block_v"]))
    spans, hubs = slab_span_plan(got.blk_row_ptr.numpy(), got.blk_spans.span_edges,
                                 got.blk_spans.row_cap)
    np.testing.assert_array_equal(got.blk_spans.spans.numpy(), spans)
    np.testing.assert_array_equal(got.blk_spans.hubs.numpy(), hubs)
    # the carry-across path builds the same layout from repro's arrays
    carried = device_graph_from_numpy(want, "cpu")
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(carried, f.name)
        if isinstance(a, tdg.SpanPlan):
            assert torch.equal(a.spans, b.spans) and torch.equal(a.hubs, b.hubs)
            assert (a.span_edges, a.row_cap) == (b.span_edges, b.row_cap)
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def test_prepare_device_graph_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = load_dataset("WIKI", scale=0.0005)
    with pytest.raises(RuntimeError, match="cuda"):
        tdg.prepare_device_graph(g)
