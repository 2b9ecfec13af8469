"""Block-CSR padding: the per-block edge slabs the superstep and K1 consume.

The port's copy of `repro.graphs.blocking`'s batch layout (the locality and
V-cycle block orders wait for the multi-GPU slice). Vertices are blocked
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

import numpy as np

from repro_torch.graphs.csr import Graph


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
) -> int:
    """Rewrite one block's slab row in place from `g`'s adjacency.

    Zeroes the padded tail. Returns the slab's real edge count. Raises
    ValueError if the block does not fit `e_max`.
    """
    e_max = edge_dst.shape[1]
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
    edge_dst[blk, :cnt] = g.adj_idx[lo:hi]
    edge_row[blk, :cnt] = (rows - v0).astype(np.int32)
    edge_w[blk, :cnt] = g.adj_w[lo:hi]
    edge_dst[blk, cnt:] = 0
    edge_row[blk, cnt:] = 0
    edge_w[blk, cnt:] = 0.0
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
