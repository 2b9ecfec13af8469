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
of `repro.graphs.csr`'s batch builder: the arithmetic is unchanged, so both
packages build identical graphs from the same edge list
(tests/test_torch_graphs.py pins that).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

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
