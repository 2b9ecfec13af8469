"""The paper's static baselines (Section V-D): Hash and Range partitioning.

Registered as `StaticAlgorithm` entries, so ``run_partitioner("hash")`` /
``("range")`` resolve through the same registry as the superstep
algorithms: the no-learning quality baseline of every sweep. They run no
supersteps and launch no kernel. Like every entry point of the port they
default to the card and raise without one (pass ``device="cpu"`` for the
CPU); `run_partitioner` passes the layout's device.
"""
from __future__ import annotations

import torch

from repro_torch.core.device_graph import resolve_device
from repro_torch.core.registry import StaticAlgorithm, register


def hash_partition(n: int, k: int, device="cuda") -> torch.Tensor:
    """v mod k, [n] int32."""
    return (torch.arange(n, dtype=torch.int64, device=resolve_device(device)) % k).to(torch.int32)


def range_partition(n: int, k: int, device="cuda") -> torch.Tensor:
    """floor(v * k / |V|), [n] int32 (int64 products, as in `repro`)."""
    v = torch.arange(n, dtype=torch.int64, device=resolve_device(device))
    return torch.clamp_max((v * k) // n, k - 1).to(torch.int32)


HASH = register(StaticAlgorithm(name="hash", partition=hash_partition))
RANGE = register(StaticAlgorithm(name="range", partition=range_partition))
