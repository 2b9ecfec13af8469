"""The port's sharded layouts and halo plans equal `repro`'s.

Both packages plan on the host in numpy: the aligned and block-permuted
layout (`plan_layout` against `repro`'s `align_blocks` + `permute_blocks`),
the assignment's block permutation (contiguous, locality, vcycle and an
explicit one), and the halo plan of either granularity (`build_halo_spec`:
boundary rows, per-vertex send lists, the rewritten slabs, the
interior/boundary split, the plan's decision and traffic), with the async
schedule's interior-first order composed on top. The port's uploaded
per-shard slabs and span plans are held to the plan too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import device_graph as jdg
from repro.core import halo as jhalo

from repro_torch.core import halo
from repro_torch.core.device_graph import (
    SpanPlan,
    align_blocks,
    block_vertex_perms,
    host_arrays,
    permute_blocks,
    plan_layout,
    prepare_device_graph,
    prepare_sharded_device_graph,
    vertices_to_original,
)
from repro_torch.graphs import load_dataset
from repro_torch.launch.mesh import BlocksMesh

CPU = torch.device("cpu")
SPEC_ARRAYS = ("boundary_rows", "blk_dst_halo", "send_ids")
SPEC_VALUES = ("n_shards", "blocks_per_shard", "block_v", "b_max", "coverage", "threshold",
               "fallback", "halo_blocks", "boundary_blocks", "granularity", "h_max",
               "block_is_boundary", "interior_counts", "interior_split", "decision",
               "exchange_len", "buf_len")
LAYOUT_ARRAYS = ("blk_dst", "blk_row", "blk_w", "deg_out", "inv_wsum", "vmask", "dir_src",
                 "dir_dst")


def _explicit(nb):
    return np.random.default_rng(7).permutation(nb)


def _repro_layout(g, n_blocks, n_shards, assignment, granularity, threshold, interior_first):
    """`repro`'s host plan, step by step as its `shard_device_graph` and
    runner take it (without placing arrays on a mesh)."""
    base = jdg.align_blocks(jdg.prepare_device_graph(g, n_blocks=max(n_blocks, n_shards)),
                            n_shards)

    def plan(assign):
        perm = jdg.resolve_assignment(base, n_shards, assign)
        dg = jdg.permute_blocks(base, perm) if perm is not None else base
        spec = jhalo.build_halo_spec(np.asarray(dg.blk_dst), np.asarray(dg.blk_w), n_shards,
                                     dg.block_v, threshold=threshold, granularity=granularity)
        return dg, perm, spec

    if callable(assignment):
        assignment = assignment(base.n_blocks)
    dg, perm, spec = plan(assignment)
    if interior_first:
        order = jhalo.interior_first_order(spec)
        if order is not None:
            dg, perm, spec = plan(perm[order] if perm is not None else order)
    return jax.device_get(dg._asdict()), perm, spec


CASES = [
    ("WIKI", 32, 8, "contiguous", "block", 2.0, False),
    ("WIKI", 32, 8, "contiguous", "vertex", 2.0, False),
    ("WIKI", 16, 4, "locality", "auto", 0.75, False),
    ("LJ", 32, 8, "locality", "vertex", 2.0, True),
    ("LJ", 16, 8, "vcycle", "block", 2.0, False),
    ("USA", 32, 8, "contiguous", "block", 2.0, True),
    ("USA", 32, 4, "vcycle", "vertex", 2.0, True),
    ("USA", 24, 8, _explicit, "auto", 0.75, False),
    ("SO", 30, 8, _explicit, "vertex", 2.0, True),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    str(x) if not callable(x) else "explicit" for x in c))
def test_layout_and_halo_plan_match_repro(case):
    dataset, n_blocks, n_shards, assignment, gran, threshold, interior_first = case
    g = load_dataset(dataset, scale=0.002, seed=0)
    want_dg, want_perm, want = _repro_layout(g, n_blocks, n_shards, assignment, gran,
                                             threshold, interior_first)
    n_req = max(n_blocks, n_shards)
    arrays = host_arrays(prepare_device_graph(g, n_blocks=n_req, device="cpu"))
    assign = assignment(want_dg["n_blocks"]) if callable(assignment) else assignment
    laid, perm, spec = plan_layout(arrays, n_shards, assignment=assign, halo=True,
                                   halo_threshold=threshold, halo_granularity=gran,
                                   interior_first=interior_first)[:3]
    assert (perm is None) == (want_perm is None)
    if perm is not None:
        np.testing.assert_array_equal(perm, want_perm)
    for f in LAYOUT_ARRAYS:
        np.testing.assert_array_equal(laid[f], want_dg[f], err_msg=f)
    for f in SPEC_VALUES:
        assert getattr(spec, f) == getattr(want, f), f
    for f in SPEC_ARRAYS:
        a, b = getattr(spec, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    assert spec.gathered_elems_per_device() == want.gathered_elems_per_device()
    assert spec.wire_bytes_per_elem(8) == want.wire_bytes_per_elem(8)
    order = halo.interior_first_order(spec)
    want_order = jhalo.interior_first_order(want)
    assert (order is None) == (want_order is None)
    if order is not None:
        np.testing.assert_array_equal(order, want_order)


@pytest.mark.parametrize("granularity", ["block", "vertex"])
def test_shard_slabs_follow_the_plan(granularity):
    """Each shard's uploaded slabs are its blocks of the permuted layout
    (the halo slabs the plan's rewrite), its span plan is the one its own
    row pointers give, and its exchange indices are the plan's rows."""
    g = load_dataset("LJ", scale=0.002, seed=0)
    n_shards = 4
    sdg = prepare_sharded_device_graph(g, BlocksMesh([CPU] * n_shards), n_blocks=16,
                                       assignment=_explicit(16), halo=True, halo_threshold=2.0,
                                       halo_granularity=granularity)
    spec, bps = sdg.halo, sdg.blocks_per_shard
    row_ptr = sdg.blk_row_ptr.numpy()
    for s, sh in enumerate(sdg.shards):
        blocks = slice(s * bps, (s + 1) * bps)
        np.testing.assert_array_equal(sh.blk_dst.numpy(), sdg.blk_dst[blocks].numpy())
        np.testing.assert_array_equal(sh.blk_dst_halo.numpy(), spec.blk_dst_halo[blocks])
        assert int(sh.blk_dst_halo.max()) < spec.buf_len
        want = SpanPlan.from_row_ptr(row_ptr[blocks], CPU)
        assert torch.equal(sh.blk_spans.spans, want.spans)
        assert torch.equal(sh.blk_spans.hubs, want.hubs)
        if granularity == "vertex":
            np.testing.assert_array_equal(sh.send_ids.numpy(), spec.send_ids[s])
        else:
            np.testing.assert_array_equal(sh.halo_rows.numpy(), spec.boundary_rows[s])
    assert sdg.o2s is not None and np.array_equal(sdg.s2o[sdg.o2s], np.arange(sdg.n_pad))


def test_align_and_permute_a_device_graph_as_repro_does():
    """The `DeviceGraph`-level transforms: padding blocks to a shard
    multiple, then a block permutation, give `repro`'s arrays, with the row
    pointer and span plan derived anew from the permuted slabs; the vertex
    maps are `repro`'s, and `vertices_to_original` undoes the permutation."""
    g = load_dataset("WIKI", scale=0.002, seed=0)
    dg = align_blocks(prepare_device_graph(g, n_blocks=13, device="cpu"), 8)
    want = jdg.align_blocks(jdg.prepare_device_graph(g, n_blocks=13), 8)
    assert dg.n_blocks == want.n_blocks == 16
    perm = _explicit(dg.n_blocks)
    dg = permute_blocks(dg, perm)
    want = jax.device_get(jdg.permute_blocks(want, perm)._asdict())
    for f in LAYOUT_ARRAYS:
        np.testing.assert_array_equal(getattr(dg, f).numpy(), want[f], err_msg=f)
    fresh = SpanPlan.from_row_ptr(dg.blk_row_ptr.numpy(), CPU)
    assert torch.equal(dg.blk_spans.spans, fresh.spans)
    o2s, s2o = block_vertex_perms(perm, dg.block_v)
    for a, b in zip((o2s, s2o), jdg.block_vertex_perms(perm, dg.block_v)):
        np.testing.assert_array_equal(a, b)
    sdg = prepare_sharded_device_graph(g, BlocksMesh([CPU] * 8), n_blocks=13, assignment=perm)
    x = torch.arange(sdg.n_pad)
    np.testing.assert_array_equal(vertices_to_original(sdg, x[sdg.s2o_t]).numpy(),
                                  np.arange(sdg.n_pad))


def test_hub_plan_matches_repro():
    """The hub replication plan is `repro`'s: held equal to it on a
    quantile hub set."""
    g = load_dataset("WIKI", scale=0.002, seed=0)
    a = host_arrays(prepare_device_graph(g, n_blocks=16, device="cpu"))
    kw = dict(threshold=2.0, granularity="vertex", deg=a["deg_out"], vmask=a["vmask"],
              blk_row=a["blk_row"])
    spec = halo.build_halo_spec(a["blk_dst"], a["blk_w"], 8, a["block_v"],
                                hubs=halo.HubConfig(quantile=0.95), **kw)
    want = jhalo.build_halo_spec(a["blk_dst"], a["blk_w"], 8, a["block_v"],
                                 hubs=jhalo.HubConfig(quantile=0.95), **kw)
    assert spec.n_hubs == want.n_hubs > 0 and spec.hub_ids == want.hub_ids
    for f in SPEC_ARRAYS + ("hub_owner", "hub_local", "hub_deg", "hub_src", "hub_slot",
                            "hub_w", "vmask_nonhub"):
        np.testing.assert_array_equal(getattr(spec, f), np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in SPEC_VALUES:
        assert getattr(spec, f) == getattr(want, f), f


def test_hub_slabs_upload_the_plan():
    """Each shard's `HubSlabs` holds the plan's replicated vectors, its own
    vote slab (the weights as int32) and its slice of ``vmask_nonhub``; the
    layout's vmask stays the real-vertex mask."""
    g = load_dataset("WIKI", scale=0.002, seed=0)
    sdg = prepare_sharded_device_graph(g, BlocksMesh([CPU] * 4), n_blocks=16, halo=True,
                                       halo_threshold=2.0, hubs=halo.HubConfig(quantile=0.95))
    spec = sdg.halo
    assert sdg.hubs_on and spec.n_hubs > 0
    ln = sdg.local_n
    for s, sh in enumerate(sdg.shards):
        hub = sh.hub
        np.testing.assert_array_equal(hub.owner.numpy(), spec.hub_owner)
        np.testing.assert_array_equal(hub.local.numpy(), spec.hub_local)
        np.testing.assert_array_equal(hub.deg.numpy(), spec.hub_deg)
        np.testing.assert_array_equal(hub.ids.numpy(), np.asarray(spec.hub_ids))
        np.testing.assert_array_equal(hub.src.numpy(), spec.hub_src[s])
        np.testing.assert_array_equal(hub.slot.numpy(), spec.hub_slot[s])
        assert hub.w.dtype == torch.int32
        np.testing.assert_array_equal(hub.w.numpy(), spec.hub_w[s])
        np.testing.assert_array_equal(hub.vmask_nonhub.numpy(),
                                      spec.vmask_nonhub[s * ln:(s + 1) * ln])
        np.testing.assert_array_equal(sh.vmask.numpy(), sdg.vmask[s * ln:(s + 1) * ln].numpy())
    plain = prepare_sharded_device_graph(g, BlocksMesh([CPU] * 4), n_blocks=16, halo=True,
                                         halo_threshold=2.0)
    assert not plain.hubs_on and plain.shards[0].hub is None
