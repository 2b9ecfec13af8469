"""Block-CSR padding: the per-block edge slabs the superstep and K1 consume.

The port's copy of `repro.graphs.blocking`: the batch layout, and the
block-level structure the sharded schedules assign blocks to shards by
(`block_adjacency`, `locality_block_order`, `vcycle_block_order`). Vertices are blocked
into `block_v`-sized tiles and each tile's adjacency slab is stored
contiguously, padded to the maximum slab length over all tiles (rounded up
to `edge_chunk`).

For each edge slot:
  * `edge_dst`  — global neighbor id,
  * `edge_row`  — the *local* row (0..block_v-1) owning the edge,
  * `edge_w`    — eq. (4) weight; 0.0 marks padding (padding rows point at
                   local row 0 but carry zero weight, so they are harmless).

Slabs are row-sorted with the padding at the tail, so every row owns one
contiguous run of its slab; `slab_row_ptr` turns that into the per-block row
pointer the hand-written edge-phase kernel walks.

The weight contract of the span kernels (K1, and K3 as the rules call it):
every live weight is an integer and each row's weights sum below 2^31.
They sum per (row, label) in int32 and write f32 once. The eq.-(4) weights
are in {1, 2}; a contracted V-cycle level sums them past 2 (its weights
stay integers). `check_integer_weights` holds a layout to the contract
when the layout is built; one that breaks it raises.
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np

from repro_torch.graphs.csr import Graph

_log = logging.getLogger("repro_torch.graphs.blocking")


@dataclasses.dataclass(frozen=True)
class BlockedEdges:
    """Padded per-block edge slabs (host numpy; moved to device by callers)."""

    n: int                 # true vertex count
    n_pad: int             # padded vertex count (= n_blocks * block_v)
    block_v: int
    n_blocks: int
    e_max: int             # padded slab length per block
    edge_dst: np.ndarray   # [n_blocks, e_max] int32, 0 for padding
    edge_row: np.ndarray   # [n_blocks, e_max] int32 local row, 0 for padding
    edge_w: np.ndarray     # [n_blocks, e_max] float32, 0.0 for padding
    pad_frac: float        # fraction of padded slots (diagnostic)


def block_slab_sizes(adj_ptr: np.ndarray, n: int, block_v: int, n_blocks: int) -> np.ndarray:
    """Per-block symmetrized-edge counts (the slab lengths before padding)."""
    lo = np.minimum(np.arange(n_blocks, dtype=np.int64) * block_v, n)
    hi = np.minimum(lo + block_v, n)
    return (adj_ptr[hi] - adj_ptr[lo]).astype(np.int64)


def fill_block_slab(
    g: Graph,
    blk: int,
    block_v: int,
    edge_dst: np.ndarray,
    edge_row: np.ndarray,
    edge_w: np.ndarray,
    *,
    out_blk: int | None = None,
    dst_map: np.ndarray | None = None,
) -> int:
    """Rewrite one block's slab row in place from `g`'s adjacency.

    Zeroes the padded tail. Returns the slab's real edge count. Raises
    ValueError if the block does not fit `e_max`.

    `blk` names the block in *graph* (original vertex-id) space; under a
    permuted block->shard assignment the slab is stored elsewhere and its
    neighbor ids live in the permuted space — `out_blk` selects the storage
    row (default: `blk` itself) and `dst_map` ([>= n] int) remaps each
    neighbor id before it is written.
    """
    e_max = edge_dst.shape[1]
    if out_blk is None:
        out_blk = blk
    v0 = blk * block_v
    v1 = min(v0 + block_v, g.n)
    lo, hi = int(g.adj_ptr[v0]), int(g.adj_ptr[v1])
    cnt = hi - lo
    if cnt > e_max:
        raise ValueError(f"block {blk} overflows e_max={e_max} with {cnt} edges")
    rows = np.repeat(
        np.arange(v0, v1, dtype=np.int64),
        np.diff(g.adj_ptr[v0 : v1 + 1]).astype(np.int64),
    )
    dst = g.adj_idx[lo:hi]
    if dst_map is not None:
        dst = dst_map[dst]
    edge_dst[out_blk, :cnt] = dst
    edge_row[out_blk, :cnt] = (rows - v0).astype(np.int32)
    edge_w[out_blk, :cnt] = g.adj_w[lo:hi]
    edge_dst[out_blk, cnt:] = 0
    edge_row[out_blk, cnt:] = 0
    edge_w[out_blk, cnt:] = 0.0
    return cnt


def block_edges(g: Graph, block_v: int = 256, edge_chunk: int = 256) -> BlockedEdges:
    n_blocks = -(-g.n // block_v)
    n_pad = n_blocks * block_v

    block_sizes = block_slab_sizes(g.adj_ptr, g.n, block_v, n_blocks)
    e_max = int(block_sizes.max()) if n_blocks else edge_chunk
    e_max = -(-max(e_max, 1) // edge_chunk) * edge_chunk

    edge_dst = np.zeros((n_blocks, e_max), dtype=np.int32)
    edge_row = np.zeros((n_blocks, e_max), dtype=np.int32)
    edge_w = np.zeros((n_blocks, e_max), dtype=np.float32)

    for blk in range(n_blocks):
        fill_block_slab(g, blk, block_v, edge_dst, edge_row, edge_w)

    total = n_blocks * e_max
    pad_frac = 1.0 - (g.num_sym_edges / total) if total else 0.0
    return BlockedEdges(
        n=g.n,
        n_pad=n_pad,
        block_v=block_v,
        n_blocks=n_blocks,
        e_max=e_max,
        edge_dst=edge_dst,
        edge_row=edge_row,
        edge_w=edge_w,
        pad_frac=pad_frac,
    )


def slab_row_ptr(edge_row: np.ndarray, edge_w: np.ndarray, block_v: int) -> np.ndarray:
    """Per-block row pointer of row-sorted slabs: ``[n_blocks, block_v+1]``
    int32, where row r of block b owns slab entries
    ``[ptr[b, r], ptr[b, r+1])``.

    Raises ValueError unless every slab is a live (w > 0), row-sorted
    prefix followed by zero-weight padding — the layout `block_edges`
    builds and the edge-phase kernel relies on.
    """
    edge_row = np.asarray(edge_row)
    edge_w = np.asarray(edge_w)
    nb = edge_row.shape[0]
    live = edge_w > 0
    cnt = live.sum(axis=1)
    ptr = np.empty((nb, block_v + 1), dtype=np.int32)
    queries = np.arange(block_v + 1)
    for b in range(nb):
        c = int(cnt[b])
        rows = edge_row[b, :c]
        if not live[b, :c].all():
            raise ValueError(f"block {b}: padding inside the live slab prefix")
        if c and (np.any(np.diff(rows) < 0) or rows[0] < 0
                  or rows[-1] >= block_v):
            raise ValueError(f"block {b}: slab rows are not sorted in "
                             f"[0, {block_v})")
        ptr[b] = np.searchsorted(rows, queries, side="left")
    return ptr


# the span kernels' per-(row, label) int32 sums stay below this
INT32_SUM_LIMIT = 2 ** 31


def check_integer_weights(edge_w: np.ndarray, row_ptr: np.ndarray) -> None:
    """Raise ValueError unless the slabs keep the span kernels' weight
    contract (module docstring): every live weight an integer, and each
    row's weight sum, which bounds each of its (row, label) sums, below
    2^31. ``row_ptr`` is `slab_row_ptr`'s for the same slabs."""
    edge_w = np.asarray(edge_w)
    for b in range(edge_w.shape[0]):
        w = edge_w[b, :int(row_ptr[b, -1])]
        if not np.array_equal(w, np.floor(w)):
            raise ValueError(f"block {b}: a slab weight is not an integer; the span "
                             "kernels sum weights in int32")
        csum = np.concatenate([[0.0], np.cumsum(w, dtype=np.float64)])
        row_sums = csum[row_ptr[b, 1:]] - csum[row_ptr[b, :-1]]
        if row_sums.size and not row_sums.max() < INT32_SUM_LIMIT:
            raise ValueError(f"block {b}: a row's weights sum to {row_sums.max():.0f}, "
                             f"past the span kernels' int32 sums (< 2^31)")


def slab_span_plan(row_ptr: np.ndarray, span_edges: int, row_cap: int):
    """Edge-balanced work split of row-sorted slabs for the edge-phase kernel.

    ``row_ptr`` is `slab_row_ptr`'s ``[nb, block_v+1]``. Returns two int32
    arrays, padded over blocks to the longest list:

      * ``spans [nb, S, 5]``: ``(e0, e1, r0, r1, part)``. A row span
        (``part = -1``) owns rows ``[r0, r1)`` whole, their slab entries
        ``[e0, e1)`` being ``[row_ptr[r0], row_ptr[r1])``; it holds at most
        ``row_cap`` rows, and its rows all start inside one window of
        ``span_edges`` entries, so it holds fewer than ``2 * span_edges``
        entries. A hub row (more than ``span_edges`` entries) is cut into
        pieces of ``span_edges`` entries, one span each (``r1 = r0 + 1``,
        ``part`` = the span's own index, where it leaves its partial sums).
        Padding spans are all zero and own no row.
      * ``hubs [nb, H, 3]``: ``(row, first piece, pieces)`` per hub row, its
        pieces consecutive spans; padding entries have 0 pieces.

    Every row of every block is owned by one row span or is one hub row,
    and every live entry lies in exactly one span.
    """
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    nb, block_v = row_ptr.shape[0], row_ptr.shape[1] - 1
    if span_edges < 1 or row_cap < 1:
        raise ValueError(f"span_edges {span_edges} and row_cap {row_cap} must be >= 1")
    per_block_spans, per_block_hubs = [], []
    r = np.arange(1, block_v)
    for b in range(nb):
        ptr = row_ptr[b]
        hub = np.diff(ptr) > span_edges
        window = ptr[:-1] // span_edges
        cut = ((r % row_cap == 0) | (window[r] != window[r - 1])
               | hub[r] | hub[r - 1])
        starts = np.concatenate([[0], r[cut]]) if block_v else np.zeros(0, np.int64)
        ends = np.concatenate([starts[1:], [block_v]]) if block_v else starts
        is_hub = hub[starts] if block_v else np.zeros(0, bool)
        rs, re = starts[~is_hub], ends[~is_hub]
        spans = [np.stack([ptr[rs], ptr[re], rs, re, np.full_like(rs, -1)], 1)]
        hubs = []
        n = len(rs)
        for h in starts[is_hub]:
            lo, hi = int(ptr[h]), int(ptr[h + 1])
            e0 = np.arange(lo, hi, span_edges)
            e1 = np.minimum(e0 + span_edges, hi)
            idx = np.arange(n, n + len(e0))
            spans.append(np.stack([e0, e1, np.full_like(e0, h), np.full_like(e0, h + 1), idx], 1))
            hubs.append((h, n, len(e0)))
            n += len(e0)
        per_block_spans.append(np.concatenate(spans).reshape(-1, 5))
        per_block_hubs.append(np.array(hubs, dtype=np.int64).reshape(-1, 3))
    s_max = max([len(s) for s in per_block_spans] + [1])
    h_max = max(len(h) for h in per_block_hubs) if nb else 0
    spans = np.zeros((nb, s_max, 5), np.int32)
    hubs = np.zeros((nb, h_max, 3), np.int32)
    for b in range(nb):
        spans[b, :len(per_block_spans[b])] = per_block_spans[b]
        hubs[b, :len(per_block_hubs[b])] = per_block_hubs[b]
    return spans, hubs


# ---------------------------------------------------------------------------
# block-level structure: the inputs of locality-aware shard assignment
# ---------------------------------------------------------------------------
def block_adjacency(edge_dst: np.ndarray, edge_w: np.ndarray, block_v: int) -> np.ndarray:
    """Block-level edge-cut matrix from the padded slabs.

    Returns `W` `[n_blocks, n_blocks]` f32 with `W[a, b]` = total eq.-(4)
    weight of slab-`a` edges whose neighbor lives in block `b` (padding slots
    carry zero weight, so they contribute nothing). `W[a, b] + W[b, a]` is
    the weight crossing the (a, b) block pair — the quantity a block->shard
    assignment wants to keep intra-shard, and the denominator of the
    halo-exchange traffic model (`repro_torch.core.halo`).
    """
    edge_dst = np.asarray(edge_dst)
    edge_w = np.asarray(edge_w, dtype=np.float64)
    nb, e_max = edge_dst.shape
    # `repro`'s np.add.at in f64, as one bincount: the weights are integers,
    # so the f64 sums are exact in any order and the matrices are equal
    w = np.zeros((nb, nb), dtype=np.float64)
    for b in range(nb):
        w[b] = np.bincount(edge_dst[b].astype(np.int64) // block_v,
                           weights=edge_w[b], minlength=nb)[:nb]
    return w.astype(np.float32)


def locality_block_order(adj: np.ndarray, n_shards: int) -> np.ndarray:
    """Greedy co-location of densely connected blocks into shard groups.

    Returns a permutation `perm` `[n_blocks]` (storage slot -> original
    block id) whose consecutive `n_blocks / n_shards`-sized groups are the
    shard assignments: slicing the permuted layout contiguously — exactly
    what the sharded layout does on the block axis — hands each shard a cluster of
    mutually dense blocks, so most slab references stay intra-shard and the
    halo exchange carries only the genuinely cross-cluster slabs.

    The heuristic is greedy agglomeration seeded from the periphery: each
    group starts at the unassigned block with the *least* weight toward the
    other unassigned blocks (a cluster edge — seeding interior hubs splits
    clusters when the group fills mid-growth), then repeatedly absorbs the
    unassigned block with the strongest connection to the group. The result
    is kept only if its worst-shard boundary-block count (the `b_max` that
    prices the halo exchange, see `repro_torch.core.halo`) beats the natural
    contiguous striping's — vertex orders that are already
    locality-friendly (road lattices, community-sorted SBMs) keep their
    identity assignment instead of being fragmented by a greedy pass. Pure
    numpy with id-ordered tie breaking, so a given (graph, n_shards) always
    yields the same assignment — partitions stay reproducible at fixed
    seed.
    """
    adj = np.asarray(adj, dtype=np.float64)
    nb = adj.shape[0]
    if adj.shape != (nb, nb):
        raise ValueError(f"adjacency must be square, got {adj.shape}")
    if nb % n_shards != 0:
        raise ValueError(
            f"n_blocks={nb} not divisible by n_shards={n_shards}; "
            "align_blocks first")
    bps = nb // n_shards
    sym = adj + adj.T
    np.fill_diagonal(sym, 0.0)
    remaining = np.ones(nb, dtype=bool)
    perm = np.empty(nb, dtype=np.int64)
    slot = 0
    for _ in range(n_shards):
        frontier = sym[:, remaining].sum(axis=1)    # weight toward unassigned
        seed = int(np.argmin(np.where(remaining, frontier, np.inf)))
        remaining[seed] = False
        perm[slot] = seed
        slot += 1
        conn = sym[seed].copy()            # connection of candidates to group
        for _ in range(bps - 1):
            nxt = int(np.argmax(np.where(remaining, conn, -1.0)))
            remaining[nxt] = False
            perm[slot] = nxt
            slot += 1
            conn += sym[nxt]
    identity = np.arange(nb, dtype=np.int64)
    wb_perm = _worst_boundary(adj, perm, bps)
    wb_id = _worst_boundary(adj, identity, bps)
    if wb_perm > wb_id:
        return identity
    if wb_perm == wb_id:
        # The SBM failure mode: when every community spans the same number
        # of blocks as a contiguous stripe, greedy agglomeration ties the
        # striping on the boundary criterion and used to keep the striping
        # silently. Break the tie deterministically on the secondary
        # criterion — total cross-shard weight, the bytes the wire actually
        # carries — and say so.
        cw_perm = _cross_weight(adj, perm, bps)
        cw_id = _cross_weight(adj, identity, bps)
        keep_perm = cw_perm < cw_id
        _log.warning(
            "locality_block_order: greedy agglomeration ties contiguous "
            "striping (worst boundary %d on both at n_blocks=%d, "
            "n_shards=%d); tie broken on cross weight (%.0f agglomerated "
            "vs %.0f striped) -> %s",
            wb_id, nb, nb // bps, cw_perm, cw_id,
            "agglomerated" if keep_perm else "striping")
        return perm if keep_perm else identity
    return perm


def vcycle_block_order(adj: np.ndarray, n_shards: int, *,
                       max_passes: int = 8) -> np.ndarray:
    """Principled block->shard assignment: the locality problem solved one
    level up (``assignment="vcycle"``).

    The block edge-cut matrix *is* a contracted graph — exactly what the
    multilevel V-cycle partitions at its coarsest level
    (`repro_torch.core.multilevel`) — and the block->shard assignment is a k-way
    partition of it with exact group sizes. This pass treats it that way:
    seed from the greedy `locality_block_order` result (which already
    guards against contiguous striping), then refine with deterministic
    pairwise slot swaps, Kernighan-Lin style, accepted only on a *strict*
    improvement of the lexicographic objective ``(worst-shard boundary
    count, total cross weight)`` — first the `b_max` the halo exchange
    pays, then the weight the wire actually carries. Because refinement
    starts from the locality answer and accepts strict improvements only,
    the result is never worse than `locality_block_order` on either
    criterion.
    """
    adj = np.asarray(adj, dtype=np.float64)
    nb = adj.shape[0]
    if adj.shape != (nb, nb):
        raise ValueError(f"adjacency must be square, got {adj.shape}")
    if nb % n_shards != 0:
        raise ValueError(
            f"n_blocks={nb} not divisible by n_shards={n_shards}; "
            "align_blocks first")
    bps = nb // n_shards
    perm = np.array(locality_block_order(adj, n_shards), dtype=np.int64)
    key = (_worst_boundary(adj, perm, bps), _cross_weight(adj, perm, bps))
    for _ in range(max_passes):
        improved = False
        for i in range(nb):
            gi = i // bps
            for j in range(i + 1, nb):
                if j // bps == gi:
                    continue        # same group: a swap changes nothing
                perm[i], perm[j] = perm[j], perm[i]
                cand = (_worst_boundary(adj, perm, bps),
                        _cross_weight(adj, perm, bps))
                if cand < key:
                    key = cand
                    improved = True
                else:
                    perm[i], perm[j] = perm[j], perm[i]
        if not improved:
            break
    return perm


def _cross_weight(adj: np.ndarray, perm: np.ndarray, bps: int) -> float:
    """Total edge weight crossing shard groups under `perm` — the secondary
    assignment criterion (`_worst_boundary` ties break toward it)."""
    nb = adj.shape[0]
    group = np.empty(nb, dtype=np.int64)
    group[perm] = np.arange(nb) // bps
    cross = group[:, None] != group[None, :]
    return float(np.asarray(adj, dtype=np.float64)[cross].sum())


def _worst_boundary(adj: np.ndarray, perm: np.ndarray, bps: int) -> int:
    """Max over shards of the number of their blocks that some other shard's
    slabs reference — the `b_max` the halo exchange pays (before padding)."""
    nb = adj.shape[0]
    group = np.empty(nb, dtype=np.int64)
    group[perm] = np.arange(nb) // bps
    refs = adj > 0
    cross = refs & (group[:, None] != group[None, :])
    referenced = cross.any(axis=0)         # block b is someone else's halo
    counts = np.bincount(group[referenced], minlength=nb // bps)
    return int(counts.max()) if counts.size else 0
