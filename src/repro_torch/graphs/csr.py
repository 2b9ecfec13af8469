"""CSR graph container with the symmetrized weighted adjacency of eq. (4).

The paper partitions a *directed* graph G=(V,E) into k edge-balanced parts.
Two views of the graph are needed:

  * the directed out-edge CSR  — defines each vertex's load contribution
    deg(v) (outdegree) and the local-edges metric;
  * the symmetrized neighborhood N(v) = {u : (u,v) in E or (v,u) in E} with
    the weighing function of eq. (4):

        w_hat(u,v) = 1 if exactly one of (u,v),(v,u) is in E
                     2 if both are in E

    used by the LP scoring term tau (eq. 11) and the weight accumulation
    (eq. 13).

Everything is built once on the host in numpy and then moved to device
tensors (`repro_torch.core.device_graph`). This module is the port's own copy
of `repro.graphs.csr`: the batch builder, the sorted-key merge primitives of
the streaming subsystem, the contraction primitives of the V-cycle and the
Table-I statistics (`graph_stats`). The
arithmetic is unchanged, so both packages build identical arrays from the
same input (tests/test_torch_graphs.py pins that).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """Immutable host-side graph.

    Attributes:
      n: number of vertices |V|.
      m: number of directed edges |E| (after dedup / self-loop removal).
      row_ptr, col_idx: out-edge CSR of the directed graph.
      adj_ptr, adj_idx, adj_w: CSR of the symmetrized neighborhood with
        eq. (4) weights (adj_w in {1.0, 2.0}).
      deg_out: outdegree per vertex (int32); sum(deg_out) == m.
    """

    n: int
    m: int
    row_ptr: np.ndarray
    col_idx: np.ndarray
    adj_ptr: np.ndarray
    adj_idx: np.ndarray
    adj_w: np.ndarray
    deg_out: np.ndarray

    @property
    def num_sym_edges(self) -> int:
        return int(self.adj_idx.shape[0])

    def neighbors(self, v: int) -> np.ndarray:
        return self.adj_idx[self.adj_ptr[v] : self.adj_ptr[v + 1]]


def _dedup_edges(src: np.ndarray, dst: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Remove self loops and duplicate directed edges."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src.astype(np.int64) * n + dst.astype(np.int64)
    key = np.unique(key)
    return (key // n).astype(np.int32), (key % n).astype(np.int32)


def build_graph(src: np.ndarray, dst: np.ndarray, n: int) -> Graph:
    """Build the dual CSR representation from a directed edge list."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    src, dst = _dedup_edges(src, dst, n)
    m = src.shape[0]

    # --- directed out-edge CSR ---------------------------------------------
    order = np.argsort(src, kind="stable")
    s_sorted, d_sorted = src[order], dst[order]
    deg_out = np.bincount(s_sorted, minlength=n).astype(np.int32)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg_out, out=row_ptr[1:])

    # --- symmetrized adjacency with eq. (4) weights -------------------------
    key = src.astype(np.int64) * n + dst.astype(np.int64)
    rkey = dst.astype(np.int64) * n + src.astype(np.int64)
    key_sorted = np.sort(key)

    # Union of both directions: every (u,v) with (u,v) in E or (v,u) in E.
    union = np.unique(np.concatenate([key, rkey]))
    u_src = (union // n).astype(np.int32)
    u_dst = (union % n).astype(np.int32)
    # weight 2 iff both directions present in the original E.
    fwd_in_e = np.searchsorted(key_sorted, union)
    fwd_hit = (fwd_in_e < m) & (key_sorted[np.minimum(fwd_in_e, m - 1)] == union)
    rev = u_dst.astype(np.int64) * n + u_src.astype(np.int64)
    rev_in_e = np.searchsorted(key_sorted, rev)
    rev_hit = (rev_in_e < m) & (key_sorted[np.minimum(rev_in_e, m - 1)] == rev)
    w = np.where(fwd_hit & rev_hit, 2.0, 1.0).astype(np.float32)

    adj_deg = np.bincount(u_src, minlength=n).astype(np.int64)
    adj_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(adj_deg, out=adj_ptr[1:])

    return Graph(
        n=n,
        m=int(m),
        row_ptr=row_ptr.astype(np.int64),
        col_idx=d_sorted.astype(np.int32),
        adj_ptr=adj_ptr,
        adj_idx=u_dst.astype(np.int32),
        adj_w=w,
        deg_out=deg_out,
    )


# ---------------------------------------------------------------------------
# Incremental-merge primitives (streaming ingestion; see repro_torch.streaming).
#
# The streaming subsystem never re-runs the O(m log m) `build_graph` sort on
# the full edge list. Instead it maintains *sorted int64 key arrays*
# (key = src * n + dst) for the directed edge set and the symmetrized
# adjacency, and merges each delta in O(m + d log m) with the helpers below.
# ---------------------------------------------------------------------------


def encode_edge_keys(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    """Pack (src, dst) pairs into sortable int64 keys: key = src * n + dst."""
    return np.asarray(src, dtype=np.int64) * n + np.asarray(dst, dtype=np.int64)


def decode_edge_keys(keys: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of `encode_edge_keys`; returns int32 (src, dst)."""
    return (keys // n).astype(np.int32), (keys % n).astype(np.int32)


def canonicalize_edges(src: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    """Sorted unique directed-edge keys with self loops removed.

    The normal form every delta is brought into before merging: duplicates
    within the batch collapse, (v, v) edges vanish, and the result is sorted
    so it can be merged against the maintained key arrays without a re-sort.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.size == 0:
        return np.empty(0, dtype=np.int64)
    keep = src != dst
    return np.unique(src[keep] * n + dst[keep])


def sorted_isin(keys: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Membership mask of `queries` in the *sorted* array `keys`."""
    if keys.size == 0:
        return np.zeros(queries.shape, dtype=bool)
    pos = np.searchsorted(keys, queries)
    pos_c = np.minimum(pos, keys.size - 1)
    return (pos < keys.size) & (keys[pos_c] == queries)


def merge_sorted_keys(keys: np.ndarray, add: np.ndarray) -> np.ndarray:
    """Insert sorted unique `add` (disjoint from `keys`) keeping sort order.

    O(m + d): one searchsorted over the existing array plus a single copy —
    no re-sort of the maintained edge set.
    """
    if add.size == 0:
        return keys
    return np.insert(keys, np.searchsorted(keys, add), add)


def remove_sorted_keys(keys: np.ndarray, drop: np.ndarray) -> np.ndarray:
    """Remove every key in sorted `drop` (all present) keeping sort order."""
    if drop.size == 0:
        return keys
    return np.delete(keys, np.searchsorted(keys, drop))


def graph_from_sorted_state(
    n: int,
    dir_keys: np.ndarray,
    sym_keys: np.ndarray,
    sym_w: np.ndarray,
) -> Graph:
    """Materialize a `Graph` container from maintained sorted key arrays.

    O(m) vectorized — the keys are already sorted, so both CSRs fall out of
    a bincount + cumsum with no sorting. This is the bridge between the
    incremental streaming state and every batch consumer (metrics, runner,
    DeviceGraph preparation).
    """
    d_src, d_dst = decode_edge_keys(dir_keys, n)
    deg_out = np.bincount(d_src, minlength=n).astype(np.int32)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg_out, out=row_ptr[1:])

    a_src, a_dst = decode_edge_keys(sym_keys, n)
    adj_deg = np.bincount(a_src, minlength=n).astype(np.int64)
    adj_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(adj_deg, out=adj_ptr[1:])

    return Graph(
        n=n,
        m=int(dir_keys.size),
        row_ptr=row_ptr,
        col_idx=d_dst,
        adj_ptr=adj_ptr,
        adj_idx=a_dst,
        adj_w=np.asarray(sym_w, dtype=np.float32),
        deg_out=deg_out,
    )


# ---------------------------------------------------------------------------
# Contraction primitives (multilevel V-cycle; see repro_torch.core.multilevel).
#
# A coarse level must keep the *fine* graph's balance and quality semantics
# exactly, or refinement at that level optimizes the wrong objective. The two
# functions below guarantee that by construction:
#
#   * `deg_out[c]` on the coarse graph is the aggregated vertex weight (sum
#     of the constituents' deg_out) — internal directed edges stay counted,
#     so sum(deg_out) == fine |E| at every level and, with `m` kept at the
#     fine edge count, the engine's capacity C = (1+eps)|E|/k prices coarse
#     loads in fine-edge units: a balanced coarse partition projects to a
#     balanced fine partition with *identical* per-part loads.
#   * the coarse directed edge list keeps every fine cross edge with its
#     multiplicity (internal edges drop out), so `local_edges` measured on a
#     coarse level equals the fine-graph locality of the projected labels on
#     exactly the edges still in play.
# ---------------------------------------------------------------------------


def heavy_edge_matching(g: Graph) -> Tuple[np.ndarray, int]:
    """Greedy heavy-edge matching over the symmetrized adjacency.

    Returns ``(cmap, n_coarse)`` where ``cmap[v]`` is the coarse vertex id
    of fine vertex ``v`` and coarse ids are dense in ``[0, n_coarse)``,
    numbered by each pair's smallest fine member so the map is stable under
    re-runs. Deterministic with no RNG: vertices are visited in ascending
    symmetrized-degree order (id tie-break — low-degree periphery first, so
    hubs don't exhaust each other's neighborhoods early), each unmatched
    vertex pairs with its heaviest unmatched neighbor (smallest id on weight
    ties), and vertices with no unmatched neighbor — isolated vertices
    included — become singletons.
    """
    n = g.n
    adj_ptr, adj_idx, adj_w = g.adj_ptr, g.adj_idx, g.adj_w
    order = np.argsort(np.diff(adj_ptr), kind="stable")
    match = np.full(n, -1, dtype=np.int64)
    for v in order:
        v = int(v)
        if match[v] >= 0:
            continue
        lo, hi = int(adj_ptr[v]), int(adj_ptr[v + 1])
        nbrs = adj_idx[lo:hi]
        free = (match[nbrs] < 0) & (nbrs != v)
        if not free.any():
            match[v] = v
            continue
        cand = np.where(free, adj_w[lo:hi], -1.0)
        # adj_idx rows are id-sorted, so argmax lands on the smallest id
        # among maximum-weight candidates — the deterministic tie-break
        u = int(nbrs[int(np.argmax(cand))])
        match[v] = u
        match[u] = v
    rep = np.minimum(np.arange(n, dtype=np.int64), match)
    reps = np.unique(rep)
    cmap = np.searchsorted(reps, rep).astype(np.int32)
    return cmap, int(reps.size)


def contract_graph(g: Graph, cmap: np.ndarray, n_coarse: int) -> Tuple[Graph, np.ndarray]:
    """Contract ``g`` along a fine->coarse vertex map.

    Returns ``(coarse, self_w)``. The coarse `Graph` has:

      * ``deg_out`` — aggregated vertex weights (see module section note);
        ``m`` stays the *fine* edge count, so ``sum(deg_out) == m`` holds at
        every level and capacity/balance semantics are unchanged;
      * ``row_ptr``/``col_idx`` — the fine cross edges mapped through
        ``cmap`` with multiplicity (internal edges removed);
      * ``adj_ptr``/``adj_idx``/``adj_w`` — eq.-(4) weights aggregated over
        coarse vertex pairs (weights grow past {1, 2}; every consumer treats
        them as generic positive weights).

    ``self_w[c]`` is the symmetrized weight folded *into* coarse vertex
    ``c`` (both CSR directions of each internal pair), so
    ``sum(adj_w) + sum(self_w) == sum(fine adj_w)`` exactly — the
    conservation invariant the JAX package's tests pin.
    """
    cmap = np.asarray(cmap, dtype=np.int64)
    if cmap.shape != (g.n,):
        raise ValueError(f"cmap must be [{g.n}], got {cmap.shape}")
    if cmap.size and (cmap.min() < 0 or cmap.max() >= n_coarse):
        raise ValueError(
            f"cmap values must be in [0, {n_coarse}), got "
            f"[{cmap.min()}, {cmap.max()}]")

    # directed cross edges, multiplicity retained
    d_src = cmap[np.repeat(np.arange(g.n, dtype=np.int64),
                           np.diff(g.row_ptr).astype(np.int64))]
    d_dst = cmap[g.col_idx]
    cross = d_src != d_dst
    d_src, d_dst = d_src[cross], d_dst[cross]
    order = np.argsort(d_src, kind="stable")
    d_src, d_dst = d_src[order], d_dst[order]
    row_ptr = np.zeros(n_coarse + 1, dtype=np.int64)
    np.cumsum(np.bincount(d_src, minlength=n_coarse), out=row_ptr[1:])

    # aggregated vertex weights (exact: integer-valued sums)
    deg_out = np.bincount(cmap, weights=g.deg_out.astype(np.float64),
                          minlength=n_coarse).astype(np.int32)

    # symmetrized adjacency aggregated over coarse pairs; internal weight
    # folds into self_w
    a_src = cmap[np.repeat(np.arange(g.n, dtype=np.int64),
                           np.diff(g.adj_ptr).astype(np.int64))]
    a_dst = cmap[g.adj_idx]
    internal = a_src == a_dst
    self_w = np.zeros(n_coarse, dtype=np.float64)
    np.add.at(self_w, a_src[internal], g.adj_w[internal].astype(np.float64))
    key = a_src[~internal] * n_coarse + a_dst[~internal]
    uniq, inv = np.unique(key, return_inverse=True)
    w = np.bincount(inv, weights=g.adj_w[~internal].astype(np.float64),
                    minlength=uniq.size)
    u_src = (uniq // n_coarse).astype(np.int64)
    u_dst = (uniq % n_coarse).astype(np.int32)
    adj_ptr = np.zeros(n_coarse + 1, dtype=np.int64)
    np.cumsum(np.bincount(u_src, minlength=n_coarse), out=adj_ptr[1:])

    coarse = Graph(
        n=n_coarse,
        m=g.m,
        row_ptr=row_ptr,
        col_idx=d_dst.astype(np.int32),
        adj_ptr=adj_ptr,
        adj_idx=u_dst,
        adj_w=w.astype(np.float32),
        deg_out=deg_out,
    )
    return coarse, self_w.astype(np.float32)


def graph_stats(g: Graph) -> Dict[str, float]:
    """Table I statistics: density and Pearson's 1st skewness coefficient.

    density  D = |E| / (|V| * (|V|-1))
    skewness = (mean - mode) / std     over the outdegree distribution
    """
    deg = g.deg_out.astype(np.float64)
    mean = float(deg.mean())
    std = float(deg.std())
    # mode of the outdegree distribution
    counts = np.bincount(g.deg_out)
    mode = float(np.argmax(counts))
    skew = 0.0 if std == 0 else (mean - mode) / std
    density = g.m / (g.n * max(g.n - 1, 1))
    return {
        "n": float(g.n),
        "m": float(g.m),
        "density": density,
        "skewness": skew,
        "mean_deg": mean,
        "max_deg": float(deg.max()) if g.n else 0.0,
    }
