"""The port's copy of the host graph layer builds exactly what `repro`'s
builds: the same CSR arrays and the same padded slabs, so both packages
partition identical inputs."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.graphs import blocking as jax_blocking
from repro.graphs import datasets as jax_datasets
from repro.graphs import generators as jax_generators

from repro_torch.graphs import blocking, datasets, generators

SCALE = 0.0005


def assert_same_fields(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("name", ["WIKI", "USA", "SO"])
def test_load_dataset_matches_reference(name):
    assert_same_fields(datasets.load_dataset(name, scale=SCALE, seed=1),
                       jax_datasets.load_dataset(name, scale=SCALE, seed=1))


@pytest.mark.parametrize("name", ["WIKI", "USA", "SO"])
def test_block_edges_matches_reference(name):
    g = datasets.load_dataset(name, scale=SCALE)
    assert_same_fields(blocking.block_edges(g, block_v=128),
                       jax_blocking.block_edges(g, block_v=128))


def test_rmat_matches_reference():
    assert_same_fields(generators.rmat(500, 4000, seed=2),
                       jax_generators.rmat(500, 4000, seed=2))


def test_slab_row_ptr_gives_each_row_its_run():
    g = datasets.load_dataset("WIKI", scale=SCALE)
    bl = blocking.block_edges(g, block_v=128)
    ptr = blocking.slab_row_ptr(bl.edge_row, bl.edge_w, bl.block_v)
    assert ptr.shape == (bl.n_blocks, bl.block_v + 1) and ptr.dtype == np.int32
    for b in range(bl.n_blocks):
        for r in range(bl.block_v):
            run = slice(ptr[b, r], ptr[b, r + 1])
            assert (bl.edge_row[b, run] == r).all()
            v = b * bl.block_v + r
            deg = g.adj_ptr[v + 1] - g.adj_ptr[v] if v < g.n else 0
            assert ptr[b, r + 1] - ptr[b, r] == deg
        # everything past the last run is padding
        assert (bl.edge_w[b, ptr[b, -1]:] == 0).all()


def test_slab_row_ptr_rejects_unsorted_slabs():
    rows = np.array([[0, 2, 1, 0]], np.int32)
    w = np.array([[1, 1, 1, 0]], np.float32)
    with pytest.raises(ValueError, match="sorted"):
        blocking.slab_row_ptr(rows, w, 4)
    with pytest.raises(ValueError, match="padding"):
        blocking.slab_row_ptr(np.array([[0, 0, 1, 0]], np.int32),
                              np.array([[1, 0, 1, 0]], np.float32), 4)


# the sorted-key merge primitives of the streaming subsystem and the
# contraction primitives of the V-cycle, on the same inputs
def _keys_case(rng, n=200, m=900):
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    return n, src, dst


def _case_encode(csr, rng):
    n, src, dst = _keys_case(rng)
    return (csr.encode_edge_keys(src, dst, n),
            *csr.decode_edge_keys(csr.encode_edge_keys(src, dst, n), n))


def _case_canonicalize(csr, rng):
    n, src, dst = _keys_case(rng)
    return (csr.canonicalize_edges(src, dst, n),
            csr.canonicalize_edges(np.empty(0), np.empty(0), n))


def _case_isin_merge_remove(csr, rng):
    n, src, dst = _keys_case(rng)
    keys = csr.canonicalize_edges(src, dst, n)
    q = csr.canonicalize_edges(*_keys_case(rng)[1:], n)
    hit = csr.sorted_isin(keys, q)
    return (hit, csr.sorted_isin(np.empty(0, np.int64), q),
            csr.merge_sorted_keys(keys, q[~hit]), csr.remove_sorted_keys(keys, q[hit]))


def _case_graph_from_sorted_state(csr, rng):
    n, src, dst = _keys_case(rng)
    dir_keys = csr.canonicalize_edges(src, dst, n)
    sym_keys = np.unique(np.concatenate([dir_keys, (dir_keys % n) * n + dir_keys // n]))
    sym_w = rng.integers(1, 3, sym_keys.size).astype(np.float32)
    return dataclasses.astuple(csr.graph_from_sorted_state(n, dir_keys, sym_keys, sym_w))


def _case_matching_and_contraction(csr, rng):
    g = csr.build_graph(*_keys_case(rng, 300, 2400)[1:], 300)
    cmap, n_coarse = csr.heavy_edge_matching(g)
    coarse, self_w = csr.contract_graph(g, cmap, n_coarse)
    cmap2, n2 = csr.heavy_edge_matching(coarse)   # weights past 2 now
    return (cmap, n_coarse, *dataclasses.astuple(coarse), self_w, cmap2, n2,
            *dataclasses.astuple(csr.contract_graph(coarse, cmap2, n2)[0]))


@pytest.mark.parametrize("case", [_case_encode, _case_canonicalize, _case_isin_merge_remove,
                                  _case_graph_from_sorted_state,
                                  _case_matching_and_contraction],
                         ids=lambda f: f.__name__[6:])
@pytest.mark.parametrize("seed", [0, 1])
def test_copied_csr_functions_match_reference(case, seed):
    from repro.graphs import csr as jax_csr

    from repro_torch.graphs import csr

    got = case(csr, np.random.default_rng(seed))
    want = case(jax_csr, np.random.default_rng(seed))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, i
            np.testing.assert_array_equal(a, b, err_msg=str(i))
        else:
            assert a == b, i


def test_edge_split_matches_reference():
    g = datasets.load_dataset("WIKI", scale=SCALE)
    for a, b in zip(generators.edge_split(g), jax_generators.edge_split(g)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_cliques,size", [(4, 8), (8, 5), (1, 3)])
def test_ring_of_cliques_matches_reference(n_cliques, size):
    assert_same_fields(generators.ring_of_cliques(n_cliques, size),
                       jax_generators.ring_of_cliques(n_cliques, size))


@pytest.mark.parametrize("name", ["WIKI", "USA", "SO", "ring"])
def test_graph_stats_matches_reference(name):
    from repro.graphs.csr import graph_stats as jax_graph_stats
    from repro_torch.graphs import graph_stats

    g = (generators.ring_of_cliques(6, 7) if name == "ring"
         else datasets.load_dataset(name, scale=SCALE, seed=1))
    assert graph_stats(g) == jax_graph_stats(g)


def test_check_integer_weights_holds_the_span_kernels_contract():
    rows = np.array([[0, 0, 1, 2, 0, 0]], np.int32)
    ptr = blocking.slab_row_ptr(rows, np.array([[1, 2, 1, 1, 0, 0]], np.float32), 3)
    blocking.check_integer_weights(np.array([[1e4, 2, 7, 1, 0, 0]], np.float32), ptr)
    with pytest.raises(ValueError, match="not an integer"):
        blocking.check_integer_weights(np.array([[1, 2.5, 1, 1, 0, 0]], np.float32), ptr)
    # row 0's two weights sum to 2^31: past the int32 sums
    with pytest.raises(ValueError, match="2\\^31"):
        blocking.check_integer_weights(np.array([[2.0 ** 30, 2.0 ** 30, 1, 1, 0, 0]],
                                                np.float32), ptr)


@pytest.mark.parametrize("name", ["WIKI", "SO"])
def test_fill_block_slab_into_permuted_storage_matches_reference(name):
    """`out_blk` / `dst_map`: every block written into its storage row of a
    permuted layout with its neighbor ids remapped, over slabs holding
    stale entries (the tails must be zeroed), equals `repro`'s."""
    from repro_torch.core.device_graph import block_vertex_perms

    g = datasets.load_dataset(name, scale=SCALE)
    bv = 64
    nb = -(-g.n // bv)
    rng = np.random.default_rng(5)
    perm = rng.permutation(nb)
    pos = np.empty(nb, np.int64)
    pos[perm] = np.arange(nb)
    o2s, _ = block_vertex_perms(perm, bv)
    e_max = int(blocking.block_slab_sizes(g.adj_ptr, g.n, bv, nb).max()) + 7
    stale = (rng.integers(0, g.n, (nb, e_max)).astype(np.int32),
             rng.integers(0, bv, (nb, e_max)).astype(np.int32),
             np.ones((nb, e_max), np.float32))
    slabs = {}
    for mod in (blocking, jax_blocking):
        dst, row, w = (a.copy() for a in stale)
        cnts = [mod.fill_block_slab(g, b, bv, dst, row, w, out_blk=int(pos[b]), dst_map=o2s)
                for b in range(nb)]
        slabs[mod] = (dst, row, w, cnts)
    for a, b in zip(slabs[blocking], slabs[jax_blocking]):
        np.testing.assert_array_equal(a, b)
    dst, _, w, cnts = slabs[blocking]
    plain = blocking.block_edges(g, block_v=bv)
    for b in range(nb):
        live = w[pos[b]] > 0
        assert live.sum() == cnts[b] and not live[cnts[b]:].any()
        np.testing.assert_array_equal(dst[pos[b], :cnts[b]], o2s[plain.edge_dst[b, :cnts[b]]])
    # without the keywords the block is written in place, ids unmapped
    d2, r2, w2 = (np.zeros_like(x) for x in (dst, dst, w))
    blocking.fill_block_slab(g, 1, bv, d2, r2, w2)
    np.testing.assert_array_equal(d2[1, :cnts[1]], plain.edge_dst[1, :cnts[1]])


@pytest.mark.parametrize("name,n_blocks,n_shards", [
    ("WIKI", 32, 8), ("LJ", 16, 4), ("USA", 32, 4), ("SO", 24, 8)])
def test_block_orders_match_reference(name, n_blocks, n_shards):
    """The block-level structure the sharded layouts assign by: the
    edge-cut matrix (summed by bincount in the port), the greedy locality
    order, the V-cycle order and the two criteria they rank by."""
    g = datasets.load_dataset(name, scale=0.002)
    bv = -(-g.n // n_blocks)
    be = blocking.block_edges(g, block_v=bv)
    pad = (-be.n_blocks) % n_shards
    dst = np.concatenate([be.edge_dst, np.zeros((pad, be.e_max), np.int32)])
    w = np.concatenate([be.edge_w, np.zeros((pad, be.e_max), np.float32)])
    adj = blocking.block_adjacency(dst, w, bv)
    want = jax_blocking.block_adjacency(dst, w, bv)
    assert adj.dtype == want.dtype
    np.testing.assert_array_equal(adj, want)
    for fn in ("locality_block_order", "vcycle_block_order"):
        np.testing.assert_array_equal(getattr(blocking, fn)(adj, n_shards),
                                      getattr(jax_blocking, fn)(want, n_shards), err_msg=fn)
    perm = np.random.default_rng(0).permutation(adj.shape[0])
    bps = adj.shape[0] // n_shards
    assert blocking._cross_weight(adj, perm, bps) == jax_blocking._cross_weight(adj, perm, bps)
    assert blocking._worst_boundary(adj, perm, bps) == jax_blocking._worst_boundary(adj, perm, bps)
