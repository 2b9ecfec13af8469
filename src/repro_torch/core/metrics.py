"""Partition-quality metrics from Section V-E of the paper."""
from __future__ import annotations

import torch


def bin_sums(index: torch.Tensor, values: torch.Tensor, k: int) -> torch.Tensor:
    """[k] f32 sums of integer-valued ``values`` by ``index`` in [0, k).

    Degrees and masked degrees are integers, but an f32 running sum of
    them stops being exact, and so depends on the order of the adds (CUDA's
    atomic `index_add_` has none), once a bin passes 2^24. The sums are
    taken in int64, exact in any order, and rounded to f32 once.
    """
    acc = torch.zeros((k,), dtype=torch.int64, device=values.device)
    return acc.index_add_(0, index.long(), values.long()).to(torch.float32)


def moved_sums(src: torch.Tensor, dst: torch.Tensor, values: torch.Tensor,
               k: int) -> torch.Tensor:
    """[k] f32 load delta of moving integer-valued ``values`` from bin
    ``src`` to bin ``dst``, summed in int64 and rounded to f32 once (see
    `bin_sums`)."""
    v = values.long()
    acc = torch.zeros((k,), dtype=torch.int64, device=values.device)
    return acc.index_add_(0, src.long(), -v).index_add_(0, dst.long(), v).to(torch.float32)


def partition_loads(labels: torch.Tensor, deg_out: torch.Tensor, k: int) -> torch.Tensor:
    """b(l) = sum of outdegrees of vertices assigned to l (eq. 5); sums to |E|.
    A label outside [0, k) (a corrupt state the guard has yet to see)
    counts in no partition, as `repro`'s segment sum drops it."""
    ok = (labels >= 0) & (labels < k)
    return bin_sums(torch.where(ok, labels, 0), deg_out * ok, k)


def local_edges(labels: torch.Tensor, edge_src: torch.Tensor,
                edge_dst: torch.Tensor) -> torch.Tensor:
    """Fraction of directed edges with both endpoints in the same partition."""
    same = (labels[edge_src.long()] == labels[edge_dst.long()]).float()
    return torch.mean(same)


def edge_cuts(labels: torch.Tensor, edge_src: torch.Tensor,
              edge_dst: torch.Tensor) -> torch.Tensor:
    """1 - local_edges (Section V-E)."""
    return 1.0 - local_edges(labels, edge_src, edge_dst)


def max_normalized_load(labels: torch.Tensor, deg_out: torch.Tensor, k: int) -> torch.Tensor:
    """Max Load / Expected Load, Expected Load = |E|/k."""
    loads = partition_loads(labels, deg_out, k)
    expected = torch.sum(loads) / k
    return torch.max(loads) / torch.clamp_min(expected, 1e-9)
