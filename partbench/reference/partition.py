"""Plain recount of a finished partition: range, loads, balance, locality.

Works on the benchmark's own copy of the graph (its directed edge list and
out-degrees), never on the program's layout or its reported metrics.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class PartitionCount:
    bad_labels: int        # vertices whose label lies outside [0, k)
    local_edges: float     # directed edges with both ends in one part / m
    loads: np.ndarray      # [k] int64 out-degree sums per part
    max_norm_load: float   # max load / (m / k)


class EdgeList:
    """The directed edges and out-degrees of a graph on ``device``, for
    recounting many partitions of it."""

    def __init__(self, graph: dict, device):
        n = int(graph["n"])
        self.n, self.m = n, int(graph["m"])
        row_ptr = torch.as_tensor(graph["row_ptr"], device=device)
        self.src = torch.repeat_interleave(
            torch.arange(n, device=device, dtype=torch.int32), torch.diff(row_ptr))
        self.dst = torch.as_tensor(graph["col_idx"], device=device)
        self.deg = torch.as_tensor(graph["deg_out"], device=device).to(torch.int64)
        self.device = device

    def count(self, labels: np.ndarray, k: int) -> PartitionCount:
        lab = torch.as_tensor(np.asarray(labels), device=self.device).to(torch.int64)
        if lab.shape != (self.n,):
            raise ValueError(f"labels have shape {tuple(lab.shape)}, expected ({self.n},)")
        ok = (lab >= 0) & (lab < k)
        bad = int((~ok).sum())
        same = int((lab[self.src] == lab[self.dst]).sum())
        loads = torch.zeros(k, dtype=torch.int64, device=self.device)
        loads.index_add_(0, torch.where(ok, lab, 0), self.deg * ok)
        loads = loads.cpu().numpy()
        return PartitionCount(bad_labels=bad, local_edges=same / self.m, loads=loads,
                              max_norm_load=float(loads.max()) / (self.m / k))
