"""The arithmetic of the port's redesigned CUDA kernels, emulated in PyTorch
on the CPU (the kernels themselves run only on the card, where
``chip_smoke.py`` holds each against its plain version):

  * K1 (edge phase): the layout-time span plan (`slab_span_plan`) and the
    kernel's work split over it: int32 sums per (row, label) within a span,
    rows written by their span, hub rows cut into pieces whose partial sums
    a second pass adds in piece order. Bit-equal to
    `fused_edge_phase_plain` in both weight modes.
  * K3 (edge histogram): the same span split with one int32 sum per (row,
    slot), the slot read from a slot slab or gathered as labels[dst];
    bit-equal to `edge_histogram_plain`, and the gather form equal to
    `repro`'s Pallas kernel in interpret mode on labels[dst].
  * K2 (LA update): the passes with each slot's factors computed once a row
    and a pass applied by a select, bit-equal to `la_update_plain` before
    the renormalization and within ``K2_TOL`` after it, and of `repro`'s
    Pallas kernel in interpret mode.
  * K6 (RWKV6 recurrence): the chunk-parallel prefill, chunks of L tokens
    with a ragged last chunk, zero-initialised local passes taken a block
    of tokens a step (decay prefix/suffix products and the intra-block
    matrix A), the stitch of the chunk states and the inter-chunk term,
    held to ``WKV_TOL`` (atol = rtol = 2e-4, the card check's tolerance in
    chip_smoke.py) against `wkv6_plain` and `repro`'s Pallas kernel in
    interpret mode; and the decode kernel's row-group split and butterfly.
"""
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels.edge_histogram import edge_histogram_pallas
from repro.kernels.la_update import la_update_pallas

from repro_torch.core.device_graph import (
    SPAN_EDGES,
    SPAN_ROWS,
    SpanPlan,
    device_graph_from_numpy,
    prepare_device_graph,
)
from repro_torch.graphs import load_dataset
from repro_torch.graphs.blocking import slab_row_ptr, slab_span_plan
from repro_torch.core.la import split_weights_and_signals
from repro_torch.kernels import edge_histogram, edge_phase, la_update, ops, wkv6

WKV_TOL = dict(atol=2e-4, rtol=2e-4)
# K2 against its plain version and the Pallas kernel: only the renorm sum's
# order differs (chip_smoke.py's K2_TOL, the bound tests/test_kernels.py
# holds the Pallas kernel to)
K2_TOL = dict(atol=5e-6, rtol=5e-5)


# --------------------------------------------------------------------------
# K1: span plan
# --------------------------------------------------------------------------
def hub_slab(rng, nb, block_v, k, long_rows, max_deg=9):
    """Row-sorted slabs (the `block_edges` layout: live prefix of eq.-(4)
    weights in {1, 2}, zero-weight padding) whose rows have 0..max_deg
    entries, except ``long_rows`` ({row: entries}); e_max a multiple of 4
    with some padding."""
    deg = rng.integers(0, max_deg + 1, (nb, block_v))
    for r, n in long_rows.items():
        deg[:, r] = n
    e_max = -(-(int(deg.sum(1).max()) + 5) // 4) * 4
    n_pad = nb * block_v
    dst = np.zeros((nb, e_max), np.int32)
    rows = np.zeros((nb, e_max), np.int32)
    vals = np.zeros((nb, e_max), np.float32)
    for b in range(nb):
        cnt = int(deg[b].sum())
        rows[b, :cnt] = np.repeat(np.arange(block_v), deg[b])
        dst[b, :cnt] = rng.integers(0, n_pad, cnt)
        vals[b, :cnt] = rng.integers(1, 3, cnt)
    labels = rng.integers(0, k, n_pad).astype(np.int32)
    lam = rng.integers(0, k, n_pad).astype(np.int32)
    actions = rng.integers(0, k, (nb, block_v)).astype(np.int32)
    feasible = (rng.random((nb, k)) > 0.3).astype(np.float32)
    return dst, rows, vals, labels, lam, actions, feasible


def check_plan(row_ptr, spans, hubs, span_edges, row_cap):
    """Every live entry in exactly one span, every row owned exactly once
    (by a row span or as a hub row), the caps held."""
    nb, block_v = row_ptr.shape[0], row_ptr.shape[1] - 1
    for b in range(nb):
        entry = np.zeros(row_ptr[b, -1], int)
        owned = np.zeros(block_v, int)
        for e0, e1, r0, r1, part in spans[b]:
            if r1 <= r0:
                assert (e0, e1, r0, r1, part) == (0, 0, 0, 0, 0)   # padding
                continue
            entry[e0:e1] += 1
            if part < 0:
                owned[r0:r1] += 1
                assert (e0, e1) == (row_ptr[b, r0], row_ptr[b, r1])
                assert r1 - r0 <= row_cap and e1 - e0 < 2 * span_edges
            else:
                assert r1 == r0 + 1 and 0 < e1 - e0 <= span_edges
                assert row_ptr[b, r0] <= e0 < e1 <= row_ptr[b, r1]
        for row, p0, n in hubs[b]:
            if n == 0:
                continue
            owned[row] += 1
            pieces = spans[b, p0:p0 + n]
            assert (pieces[:, 2] == row).all() and (pieces[:, 4] == np.arange(p0, p0 + n)).all()
            assert pieces[0, 0] == row_ptr[b, row] and pieces[-1, 1] == row_ptr[b, row + 1]
            assert (pieces[1:, 0] == pieces[:-1, 1]).all()
        assert (entry == 1).all() and (owned == 1).all()


@pytest.mark.parametrize("span_edges,row_cap", [(16, 8), (64, 5), (7, 1), (4096, 128)])
def test_span_plan_covers_every_entry_and_row_once(span_edges, row_cap):
    rng = np.random.default_rng(span_edges)
    long_rows = dict.fromkeys((0, 57, 58, 199), 300)
    dst, rows, vals, *_ = hub_slab(rng, 3, 200, 4, long_rows)
    row_ptr = slab_row_ptr(rows, vals, 200)
    spans, hubs = slab_span_plan(row_ptr, span_edges, row_cap)
    assert spans.dtype == hubs.dtype == np.int32
    check_plan(row_ptr, spans, hubs, span_edges, row_cap)
    for b in range(3):
        cut = {int(r) for r, _, n in hubs[b] if n > 1}
        assert cut >= set(long_rows) if span_edges < 300 else not cut


def test_span_plan_of_a_layout_is_cached_on_the_device_graph():
    g = load_dataset("WIKI", scale=0.002)
    dg = prepare_device_graph(g, n_blocks=8, device="cpu")
    plan = dg.blk_spans
    assert (plan.span_edges, plan.row_cap) == (SPAN_EDGES, SPAN_ROWS)
    check_plan(dg.blk_row_ptr.numpy(), plan.spans.numpy(), plan.hubs.numpy(),
               SPAN_EDGES, SPAN_ROWS)
    one = plan.block(3)
    assert torch.equal(one.spans[0], plan.spans[3]) and torch.equal(one.hubs[0], plan.hubs[3])


@pytest.mark.parametrize("weight_mode", edge_phase.WEIGHT_MODES)
def test_the_row_cap_bounds_shared_memory_at_k_64(weight_mode):
    """A span holds at most SPAN_ROWS rows, so a CTA's shared memory at the
    largest k fits an H100 CTA with room for more than one CTA an SM."""
    smem = edge_phase.shared_bytes(SPAN_ROWS, edge_phase.MAX_K, weight_mode)
    assert smem <= edge_phase.SHARED_LIMIT // 3
    assert smem == 4 * (SPAN_ROWS * 64 + SPAN_ROWS * (64 if weight_mode == "neighbor_lambda"
                                                       else 2) + 2 * SPAN_ROWS + 1 + 64)


# --------------------------------------------------------------------------
# K1: the kernel's work split, emulated
# --------------------------------------------------------------------------
def span_edge_phase(dst, vals, row_ptr, spans, hubs, labels, lam, actions, feasible, *,
                    block_v, k, weight_mode):
    """K1's CUDA arithmetic in PyTorch: per span, int32 sums per (row,
    label) over its entries (each entry's row by a binary search in the
    span's row pointer); a row span writes its rows once as f32, a hub piece
    leaves int32 partial sums that the hub pass adds in piece order."""
    neighbor = weight_mode == "neighbor_lambda"
    nb = dst.shape[0]
    hist = torch.full((nb, block_v, k), float("nan"))
    wacc = torch.full((nb, block_v, k), float("nan"))
    written = torch.zeros((nb, block_v), dtype=torch.int64)
    partial = {}
    for b in range(nb):
        feas = torch.round(feasible[b]).to(torch.int32)
        for e0, e1, r0, r1, part in spans[b].tolist():
            rows = r1 - r0
            if rows <= 0:
                continue
            e = torch.arange(e0, e1)
            e = e[vals[b, e] > 0]
            ptr = row_ptr[b, r0:r1 + 1].contiguous()
            row = torch.searchsorted(ptr, e.to(ptr.dtype), right=True) - 1
            wi = torch.round(vals[b, e]).to(torch.int32)
            u = dst[b, e].long()
            lb, lm = labels[u].long(), lam[u].long()
            hs = torch.zeros(rows * k, dtype=torch.int32).index_add_(0, row * k + lb, wi)
            agree = actions[b, r0 + row] == lm
            if neighbor:
                val = torch.where(agree, wi, feas[lm])
                acc = torch.zeros(rows * k, dtype=torch.int32).index_add_(0, row * k + lm, val)
                acc = acc.view(rows, k)
            else:
                acc = torch.zeros(rows * 2, dtype=torch.int32).index_add_(
                    0, row * 2 + (~agree).long(), torch.where(agree, wi, 1).to(torch.int32))
                acc = torch.cat([acc.view(rows, 2), torch.zeros((rows, k - 2), dtype=torch.int32)], 1)
            if part < 0:
                hist[b, r0:r1] = hs.view(rows, k).float()
                wacc[b, r0:r1] = acc.float()
                written[b, r0:r1] += 1
            else:
                partial[b, part] = (hs, acc[0])
        for row, p0, n in hubs[b].tolist():
            if n == 0:
                continue
            hs = torch.zeros(k, dtype=torch.int32)
            acc = torch.zeros(k, dtype=torch.int32)
            for p in range(p0, p0 + n):
                hs, acc = hs + partial[b, p][0], acc + partial[b, p][1]
            hist[b, row], wacc[b, row] = hs.float(), acc.float()
            written[b, row] += 1
    assert bool((written == 1).all()), "a row was written other than once"
    return hist, wacc


@pytest.mark.parametrize("k", [3, 8, 33, 64])
@pytest.mark.parametrize("weight_mode", edge_phase.WEIGHT_MODES)
def test_span_edge_phase_is_bit_equal_to_the_plain_version(k, weight_mode):
    """Small spans (16 entries, 4 rows), so rows 3 and 40 (hub rows of 150
    entries) each span ten pieces, row 41 (17 entries) is cut by one
    boundary, and several spans meet their row cap."""
    rng = np.random.default_rng(k)
    block_v = 96
    host = hub_slab(rng, 2, block_v, k, {3: 150, 40: 150, 41: 17})
    row_ptr = slab_row_ptr(host[1], host[2], block_v)
    plan = SpanPlan.from_row_ptr(row_ptr, "cpu", span_edges=16, row_cap=4)
    pieces = {int(r): int(n) for r, _, n in plan.hubs[0].tolist()}
    assert pieces == {3: 10, 40: 10, 41: 2}
    assert (plan.spans[..., 3] - plan.spans[..., 2] == 4).any()
    dst, rows, vals, labels, lam, actions, feasible = (torch.from_numpy(a) for a in host)
    got = span_edge_phase(dst, vals, torch.from_numpy(row_ptr), plan.spans, plan.hubs,
                          labels, lam, actions, feasible, block_v=block_v, k=k,
                          weight_mode=weight_mode)
    want = edge_phase.fused_edge_phase_plain(dst, rows, vals, labels, lam, actions, feasible,
                                             block_v=block_v, k=k, weight_mode=weight_mode)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


# --------------------------------------------------------------------------
# K3: the span kernel's arithmetic, emulated
# --------------------------------------------------------------------------
def span_edge_histogram(idx, vals, row_ptr, spans, hubs, *, block_v, k, labels=None):
    """K3's span kernel in PyTorch: per span, int32 sums per (row, slot)
    over its entries with a nonzero value (each entry's row by a binary
    search in the span's row pointer; the slot ``idx[e]``, or
    ``labels[idx[e]]`` in the gather form; a slot outside [0, k) adds
    nothing); a row span writes its rows once as f32, a hub piece leaves
    int32 partial sums that the hub pass adds in piece order."""
    nb = idx.shape[0]
    hist = torch.full((nb, block_v, k), float("nan"))
    written = torch.zeros((nb, block_v), dtype=torch.int64)
    partial = {}
    for b in range(nb):
        for e0, e1, r0, r1, part in spans[b].tolist():
            rows = r1 - r0
            if rows <= 0:
                continue
            e = torch.arange(e0, e1)
            wi = torch.round(vals[b, e]).to(torch.int32)
            e, wi = e[wi != 0], wi[wi != 0]
            slot = idx[b, e].long()
            if labels is not None:
                slot = labels[slot].long()
            ok = (slot >= 0) & (slot < k)
            e, wi, slot = e[ok], wi[ok], slot[ok]
            ptr = row_ptr[b, r0:r1 + 1].contiguous()
            row = torch.searchsorted(ptr, e.to(ptr.dtype), right=True) - 1
            hs = torch.zeros(rows * k, dtype=torch.int32).index_add_(0, row * k + slot, wi)
            if part < 0:
                hist[b, r0:r1] = hs.view(rows, k).float()
                written[b, r0:r1] += 1
            else:
                partial[b, part] = hs
        for row, p0, n in hubs[b].tolist():
            if n == 0:
                continue
            hs = torch.zeros(k, dtype=torch.int32)
            for piece in range(p0, p0 + n):
                hs = hs + partial[b, piece]
            hist[b, row] = hs.float()
            written[b, row] += 1
    assert bool((written == 1).all()), "a row was written other than once"
    return hist


def histogram_slab(seed, nb, block_v, k, long_rows):
    """`hub_slab`'s layout with neighbor ids over nb * block_v vertices and
    a label vector; slots = labels[dst]."""
    rng = np.random.default_rng(seed)
    dst, rows, vals, labels, *_ = hub_slab(rng, nb, block_v, k, long_rows)
    return (torch.from_numpy(a) for a in (dst, rows, vals, labels))


@pytest.mark.parametrize("k", [1, 5, 8, 33, 64])
@pytest.mark.parametrize("form", ["slots", "gather"])
def test_span_edge_histogram_is_bit_equal_to_the_plain_version(k, form):
    """Small spans (16 entries, 4 rows): rows 3 and 40 (150 entries) cut
    into ten pieces each, row 41 (17 entries) into two, spans at their row
    cap; nb 1 and 3 over the same slab."""
    dst, rows, vals, labels = histogram_slab(k, 3, 96, k, {3: 150, 40: 150, 41: 17})
    slots = labels[dst.long()]
    for nb in (1, 3):
        row_ptr = torch.from_numpy(slab_row_ptr(rows[:nb].numpy(), vals[:nb].numpy(), 96))
        plan = SpanPlan.from_row_ptr(row_ptr.numpy(), "cpu", span_edges=16, row_cap=4)
        assert {int(r): int(n) for r, _, n in plan.hubs[0].tolist()} == {3: 10, 40: 10, 41: 2}
        idx = slots[:nb] if form == "slots" else dst[:nb]
        got = span_edge_histogram(idx, vals[:nb], row_ptr, plan.spans, plan.hubs, block_v=96,
                                  k=k, labels=None if form == "slots" else labels)
        want = edge_histogram.edge_histogram_plain(slots[:nb], rows[:nb], vals[:nb],
                                                   block_v=96, k=k)
        assert torch.equal(got, want)


def test_span_edge_histogram_on_the_layout_plan_of_a_device_graph():
    """The rules' own input: a WIKI layout's slabs and cached span plan,
    random labels gathered by the slabs' neighbor ids."""
    dg = prepare_device_graph(load_dataset("WIKI", scale=0.002), n_blocks=8, device="cpu")
    labels = torch.from_numpy(np.random.default_rng(3).integers(0, 8, dg.n_pad).astype(np.int32))
    got = span_edge_histogram(dg.blk_dst, dg.blk_w, dg.blk_row_ptr, dg.blk_spans.spans,
                              dg.blk_spans.hubs, block_v=dg.block_v, k=8, labels=labels)
    want = ops.edge_histogram(dg.blk_dst, dg.blk_row, dg.blk_w, labels=labels,
                              row_ptr=dg.blk_row_ptr, spans=dg.blk_spans,
                              block_v=dg.block_v, k=8, integer_values=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("nb,block_v,k", [(1, 64, 3), (3, 96, 8), (2, 128, 17)])
def test_gather_form_matches_pallas_on_gathered_labels(nb, block_v, k):
    """The gather form (the CPU route and the kernel's emulation) against
    `repro`'s Pallas kernel in interpret mode on the slots labels[dst]."""
    dst, rows, vals, labels = histogram_slab(100 + k, nb, block_v, k, {5: 40})
    slots = labels[dst.long()]
    got = ops.edge_histogram(dst, rows, vals, labels=labels, row_ptr=None, block_v=block_v,
                             k=k, integer_values=True)
    e_max = dst.shape[1]
    pad = (-e_max) % 256
    pallas = edge_histogram_pallas(
        *(jnp.asarray(np.pad(a.numpy(), ((0, 0), (0, pad)))) for a in (slots, rows, vals)),
        block_v=block_v, k=k, edge_chunk=256, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    row_ptr = torch.from_numpy(slab_row_ptr(rows.numpy(), vals.numpy(), block_v))
    plan = SpanPlan.from_row_ptr(row_ptr.numpy(), "cpu", span_edges=32, row_cap=8)
    emulated = span_edge_histogram(dst, vals, row_ptr, plan.spans, plan.hubs,
                                   block_v=block_v, k=k, labels=labels)
    np.testing.assert_array_equal(emulated.numpy(), np.asarray(pallas))


# --------------------------------------------------------------------------
# K1 and K3 on a contracted V-cycle level's weights
# --------------------------------------------------------------------------
@pytest.mark.parametrize("form", ["self_lambda", "neighbor_lambda", "slots", "gather"])
@pytest.mark.parametrize("k", [3, 8, 64])
def test_span_sums_are_exact_on_contracted_level_weights(form, k):
    """Integer weights up to 10^4, the range a contracted level holds, in
    K1's two weight modes and K3's two forms, under 16-entry, 4-row spans
    (hub rows of 150 entries in ten pieces): the emulated span sums are
    bit-equal to the plain versions."""
    rng = np.random.default_rng(50 + k)
    block_v = 96
    dst, rows, vals, labels, lam, actions, feasible = hub_slab(
        rng, 2, block_v, k, {3: 150, 40: 150, 41: 17})
    vals = np.where(vals > 0, rng.integers(1, 10_001, vals.shape), 0).astype(np.float32)
    assert vals.max() > 9000
    row_ptr = slab_row_ptr(rows, vals, block_v)
    plan = SpanPlan.from_row_ptr(row_ptr, "cpu", span_edges=16, row_cap=4)
    t = {n: torch.from_numpy(a) for n, a in dict(
        dst=dst, rows=rows, vals=vals, labels=labels, lam=lam, actions=actions,
        feasible=feasible, row_ptr=row_ptr).items()}
    if form in edge_phase.WEIGHT_MODES:
        got = span_edge_phase(t["dst"], t["vals"], t["row_ptr"], plan.spans, plan.hubs,
                              t["labels"], t["lam"], t["actions"], t["feasible"],
                              block_v=block_v, k=k, weight_mode=form)
        want = edge_phase.fused_edge_phase_plain(
            t["dst"], t["rows"], t["vals"], t["labels"], t["lam"], t["actions"],
            t["feasible"], block_v=block_v, k=k, weight_mode=form)
    else:
        slots = t["labels"][t["dst"].long()]
        idx, lab = (slots, None) if form == "slots" else (t["dst"], t["labels"])
        got = (span_edge_histogram(idx, t["vals"], t["row_ptr"], plan.spans, plan.hubs,
                                   block_v=block_v, k=k, labels=lab),)
        want = (edge_histogram.edge_histogram_plain(slots, t["rows"], t["vals"],
                                                    block_v=block_v, k=k),)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_a_layout_past_the_int32_sums_raises():
    """A slab whose row 0 sums to 2^31 or more breaks the span kernels'
    int32 sums: building the layout raises, so no kernel ever sees it."""
    dg = prepare_device_graph(load_dataset("WIKI", scale=0.0005), n_blocks=2, device="cpu")
    arrays = {f: (getattr(dg, f).numpy().copy() if isinstance(getattr(dg, f), torch.Tensor)
                  else getattr(dg, f))
              for f in ("n", "n_pad", "m", "n_blocks", "block_v", "e_max", "dir_src",
                        "dir_dst", "blk_dst", "blk_row", "blk_w", "deg_out", "inv_wsum",
                        "vmask")}
    first = int(dg.blk_row_ptr[0, 1])
    assert first >= 2
    arrays["blk_w"][0, :first] = 2.0 ** 30
    with pytest.raises(ValueError, match="2\\^31"):
        device_graph_from_numpy(arrays, "cpu")
    arrays["blk_w"][0, 1:first] = 1.0    # 2^30 + first - 1 stays below
    device_graph_from_numpy(arrays, "cpu")


# --------------------------------------------------------------------------
# K2: the hoisted-factor passes, emulated
# --------------------------------------------------------------------------
def hoisted_la_update(p, w, r, alpha, beta, *, renorm=True):
    """K2's CUDA arithmetic in f32 PyTorch: each slot's factors 1 - beta w,
    beta w / (k-1), alpha w and 1 - alpha w computed once a row; the
    penalty sweep, then the reward sweep, pass i kept by a select on rows
    that run it (w_i > 0 and r_i in the sweep's class); then the clip and a
    slot-order row sum."""
    k = p.shape[-1]
    km1 = torch.tensor(float(k - 1))
    bw = beta * w
    pen_keep, pen_floor = 1.0 - bw, bw / km1
    rew_gain = alpha * w
    rew_keep = 1.0 - rew_gain
    pen = r > 0
    runs = w > 0
    p = p.clone()
    for want_pen in (True, False):
        for i in range(k):
            run = (runs[..., i] & (pen[..., i] == want_pen))[..., None]
            if want_pen:
                kept = p * pen_keep
                nxt = kept + pen_floor
                nxt[..., i] = kept[..., i]
            else:
                nxt = p * rew_keep
                nxt[..., i] = p[..., i] + rew_gain[..., i] * (1.0 - p[..., i])
            p = torch.where(run, nxt, p)
    if renorm:
        p = torch.clamp(p, 1e-12, 1.0)
        total = torch.zeros(p.shape[:-1])
        for j in range(k):
            total = total + p[..., j]
        p = p / total[..., None]
    return p


def la_inputs(seed, v, k, self_lambda):
    """(p, w, r): rows on the simplex; weights split from random
    accumulations, or as a self_lambda superstep gives them (one weighted
    slot a row, some rows none)."""
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(rng.dirichlet(np.ones(k), v).astype(np.float32))
    if self_lambda:
        slot = torch.from_numpy(rng.integers(0, k, v))
        contrib = torch.from_numpy(rng.integers(1, 40, v).astype(np.float32))
        contrib[::7] = 0.0                     # rows whose edges all disagree
        w_raw = torch.nn.functional.one_hot(slot, k).float() * contrib[:, None]
    else:
        w_raw = torch.from_numpy(rng.integers(0, 6, (v, k)).astype(np.float32))
    return (p, *split_weights_and_signals(w_raw))


@pytest.mark.parametrize("k", [2, 5, 8, 12, 33, 64])
@pytest.mark.parametrize("self_lambda", [False, True], ids=["random", "self_lambda"])
def test_hoisted_la_passes_match_the_plain_version_and_pallas(k, self_lambda):
    """Every pass rounds as the plain version's: bit-equal before the
    renormalization (a self_lambda input runs one reward pass a row at
    most, so that case checks a single pass); after it within K2_TOL of
    `la_update_plain` and of `repro`'s Pallas kernel in interpret mode."""
    v = 203
    p, w, r = la_inputs(k, v, k, self_lambda)
    if self_lambda:
        assert int((w > 0).sum(-1).max()) == 1 and bool((w == 0).all(-1).any())
    raw = hoisted_la_update(p, w, r, 1.0, 0.1, renorm=False)
    assert torch.equal(raw, la_update.la_update_plain(p, w, r, 1.0, 0.1, renorm=False))
    got = hoisted_la_update(p, w, r, 1.0, 0.1)
    torch.testing.assert_close(got, la_update.la_update_plain(p, w, r, 1.0, 0.1), **K2_TOL)
    pad = (-v) % 8
    pallas = la_update_pallas(
        jnp.asarray(np.pad(p.numpy(), ((0, pad), (0, 0)), constant_values=1.0 / k)),
        jnp.asarray(np.pad(w.numpy(), ((0, pad), (0, 0)))),
        jnp.asarray(np.pad(r.numpy(), ((0, pad), (0, 0)))),
        alpha=1.0, beta=0.1, renorm=True, block_v=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas)[:v], **K2_TOL)


def test_the_la_kernel_hoists_the_floor_out_of_its_passes():
    """The penalty floor beta w_j / (k-1) is divided once a row, before the
    passes, not in a pass body (the tool's 'not hoisted' variant puts it
    back by replacing the marked use)."""
    src = (pathlib.Path(la_update.__file__).parent / "csrc" / "la_update.cu").read_text()
    body = src[src.index("for (int sweep = 0;"):src.index("if (renorm)")]
    assert "__fdiv_rn" not in body and "__fadd_rn(kept, pen_floor[j])" in body
    assert "pen_floor[j] = __fdiv_rn(__fmul_rn(beta, w[j]), km1);" in src


def test_the_la_kernel_clamp_keeps_a_nan():
    """K2 clamps to [1e-12, 1] by comparisons, which keep a NaN as
    torch.clamp (the plain version, and the emulation above) does: fmaxf
    would turn it into 1e-12 and hide a corrupt row from the state guard."""
    src = (pathlib.Path(la_update.__file__).parent / "csrc" / "la_update.cu").read_text()
    renorm = src[src.index("if (renorm)"):]
    assert "fmaxf(" not in renorm and "fminf(" not in renorm
    assert "p[j] = p[j] < 1e-12f ? 1e-12f : (p[j] > 1.f ? 1.f : p[j]);" in renorm
    p, w, r = la_inputs(3, 9, 5, False)
    p[0, 2] = float("nan")
    got = hoisted_la_update(p, w, r, 1.0, 0.1)
    want = la_update.la_update_plain(p, w, r, 1.0, 0.1)
    assert torch.isnan(got[0]).all() and torch.isnan(want[0]).all()
    assert torch.isfinite(got[1:]).all() and torch.isfinite(want[1:]).all()


# --------------------------------------------------------------------------
# K6: the chunk-parallel prefill and the spread decode, emulated
# --------------------------------------------------------------------------
def wkv_inputs(seed, b, s, h, n):
    """f32 inputs, decays from strong (w = exp(-e^2)) to weak (exp(-e^-6)),
    a nonzero starting state (as tests/test_torch_rwkv.py makes them)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32) for _ in range(3))
    logw = -np.exp(rng.uniform(-6.0, 2.0, (b, s, h, n))).astype(np.float32)
    u = (rng.standard_normal((h, n)) * 0.3).astype(np.float32)
    s0 = (rng.standard_normal((b, h, n, n)) * 0.1).astype(np.float32)
    return r, k, v, logw, u, s0


def blocked_local_pass(r, k, v, logw, u, block):
    """K6's local pass over one chunk, from a zero state, ``block`` tokens a
    step (a ragged last block padded with identity tokens: r = k = v = 0,
    w = 1). With P_j = prod_{l<j} w_l and Q_i = prod_{i<l<B} w_l over the
    block, for j, i < B:
      y_j = (r_j P_j) . S + sum_{i<=j} A[j, i] v_i,
      A[j, i] = sum_n r_j k_i prod_{i<l<j} w_l (i < j), A[j, j] = r_j . (u k_j),
      S <- P_B S + sum_i (k_i Q_i) v_i^T,
    so each state element takes 2B + 1 products a block, not 3B. Returns
    (y_loc [b, L, h, n], s_loc [b, h, n, n])."""
    b, length, h, n = r.shape
    w = torch.exp(logw)
    pad = (-length) % block
    if pad:
        z = torch.zeros((b, pad, h, n))
        r, k, v, w = (torch.cat([x, z], 1) for x in (r, k, v, w))
        w[:, length:] = 1.0
    st = torch.zeros((b, h, n, n))
    ys = []
    for t0 in range(0, length + pad, block):
        rb, kb, vb, wb = (x[:, t0:t0 + block] for x in (r, k, v, w))
        prefix = torch.cumprod(torch.cat([torch.ones((b, 1, h, n)), wb], 1), 1)  # P_0..P_B
        r_dec = rb * prefix[:, :block]
        suffix = torch.flip(torch.cumprod(torch.flip(
            torch.cat([wb[:, 1:], torch.ones((b, 1, h, n))], 1), [1]), 1), [1])  # Q_0..Q_{B-1}
        k_dec = kb * suffix
        for j in range(block):
            y = torch.einsum("bhn,bhnm->bhm", r_dec[:, j], st)
            for i in range(j):
                between = torch.prod(wb[:, i + 1:j], 1) if j > i + 1 else 1.0
                a = (rb[:, j] * kb[:, i] * between).sum(-1)
                y = y + a[..., None] * vb[:, i]
            y = y + (rb[:, j] * u[None] * kb[:, j]).sum(-1)[..., None] * vb[:, j]
            ys.append(y)
        st = st * prefix[:, block][..., None] + torch.einsum("bthn,bthm->bhnm", k_dec, vb)
    return torch.stack(ys[:length], 1), st


def chunked_wkv6(r, k, v, logw, u, state0, chunk, block=4):
    """K6's prefill in PyTorch: per chunk of ``chunk`` tokens (the last one
    ragged) the local pass from a zero state (`blocked_local_pass`); the
    chunk's state s_loc, decay exp(sum logw) and r_eff = r exp(exclusive
    cumulative logw); then the stitch in chunk order, y += r_eff .
    state_in and state_in <- state_in w_tot + s_loc."""
    b, s, h, n = r.shape
    y = torch.zeros((b, s, h, n))
    parts = []
    for t0 in range(0, s, chunk):
        t1 = min(s, t0 + chunk)
        lw = logw[:, t0:t1]
        y[:, t0:t1], s_loc = blocked_local_pass(r[:, t0:t1], k[:, t0:t1], v[:, t0:t1], lw,
                                                u, block)
        cum = torch.cumsum(lw, 1)
        r_eff = r[:, t0:t1] * torch.exp(cum - lw)
        parts.append((t0, t1, s_loc, torch.exp(cum[:, -1]), r_eff))
    state = state0.clone()
    for t0, t1, s_loc, w_tot, r_eff in parts:
        y[:, t0:t1] += torch.einsum("bthn,bhnm->bthm", r_eff, state)
        state = state * w_tot[..., None] + s_loc
    state0.copy_(state)
    return y, state0


def spread_decode_wkv6(r, k, v, logw, u, state0):
    """K6's decode kernel in PyTorch: the state's rows split into 16 row
    groups (min(16, N); group g holds rows g, g + 16, ...), each group's
    partial y summed by the butterfly of the warp shuffles (offsets 1, 2,
    4, 8). The kernel's staging of the per-row terms and any split of the
    value columns over CTAs leave each column's arithmetic as it is."""
    b, s, h, n = r.shape
    groups = min(16, n)
    state = state0.clone()
    y = torch.zeros((b, s, h, n))
    for t in range(s):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], torch.exp(logw[:, t])
        att = state + (u[None] * kt)[..., None] * vt[..., None, :]
        part = torch.einsum("bhig,bhigm->bhgm", rt.view(b, h, -1, groups),
                            att.view(b, h, n // groups, groups, n))
        x = 1
        while x < groups:
            part = part + part[:, :, torch.arange(groups) ^ x]
            x <<= 1
        y[:, t] = part[:, :, 0]
        state = state * wt[..., None] + kt[..., None] * vt[..., None, :]
    state0.copy_(state)
    return y, state0


@pytest.mark.parametrize("s,chunk,block", [(1, 16, 4), (7, 16, 4), (64, 64, 4), (64, 16, 2),
                                           (130, 64, 4), (130, 32, 4), (130, 32, 1)])
def test_chunked_prefill_matches_the_plain_version_and_repro(s, chunk, block):
    """Ragged last chunks (130 = 2 x 64 + 2 = 4 x 32 + 2), chunks shorter
    than a block step (7 tokens: a padded block) and whole ones, at WKV_TOL
    against `wkv6_plain` and `repro`'s Pallas kernel run in interpret mode
    (as `tests/test_kernels.py` runs it on the CPU)."""
    args = wkv_inputs(s, 2, s, 2, 16)
    y, st = chunked_wkv6(*(torch.from_numpy(a.copy()) for a in args), chunk, block)
    wy, wst = wkv6.wkv6_plain(*(torch.from_numpy(a.copy()) for a in args))
    torch.testing.assert_close(y, wy, **WKV_TOL)
    torch.testing.assert_close(st, wst, **WKV_TOL)
    py, pst = jops.wkv6(*map(jnp.asarray, args), block_s=s, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(py), **WKV_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(pst), **WKV_TOL)


@pytest.mark.parametrize("s,n", [(1, 80), (7, 16), (1, 8), (3, 32)])
def test_spread_decode_matches_the_plain_version(s, n):
    args = wkv_inputs(100 + s, 2, s, 3, n)
    y, st = spread_decode_wkv6(*(torch.from_numpy(a.copy()) for a in args))
    wy, wst = wkv6.wkv6_plain(*(torch.from_numpy(a.copy()) for a in args))
    torch.testing.assert_close(y, wy, **WKV_TOL)
    torch.testing.assert_close(st, wst, **WKV_TOL)


def test_the_chunk_is_whole_staging_sub_blocks():
    """The kernels stage SUB tokens at a time (their shared memory does not
    grow with the chunk), so a chunk is a whole number of sub-blocks; the
    wrapper sizes the chunked passes' scratch by CHUNK, so it is the
    kernels' own compile-time chunk length."""
    assert wkv6.CHUNK % wkv6.SUB == 0 and wkv6.CHUNK >= wkv6.SUB
    src = (pathlib.Path(wkv6.__file__).parent / "csrc" / "wkv6.cu").read_text()
    assert f"constexpr int kChunk = {wkv6.CHUNK};" in src
    assert f"constexpr int kSub = {wkv6.SUB};" in src
