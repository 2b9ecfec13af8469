"""Partition-quality metrics from Section V-E of the paper."""
from __future__ import annotations

import torch


def partition_loads(labels: torch.Tensor, deg_out: torch.Tensor, k: int) -> torch.Tensor:
    """b(l) = sum of outdegrees of vertices assigned to l (eq. 5); sums to |E|."""
    loads = torch.zeros((k,), dtype=torch.float32, device=labels.device)
    return loads.index_add_(0, labels.long(), deg_out.float())


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
