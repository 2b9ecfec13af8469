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
