"""The port's 1-D ``("blocks",)`` mesh for the sharded partitioner superstep.

`repro` is single-controller: one Python process drives a JAX mesh through
``shard_map``, and its tests fake a mesh of 8 with
``--xla_force_host_platform_device_count=8``. The port keeps that model: a
`BlocksMesh` is an explicit list of `torch.device`s, one per shard, driven
by one process. Entries may repeat — the port's counterpart of the forced
host device count, and how 8 shards run on one card. Collectives are tensor
moves inside the process (`repro_torch.parallel.collectives`); shards on
distinct cards run concurrently because launches are asynchronous.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch

from repro_torch.core.device_graph import resolve_device


class BlocksMesh:
    """One device per shard, in shard order (entries may repeat)."""

    def __init__(self, devices: Iterable):
        devs: Tuple[torch.device, ...] = tuple(resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("a BlocksMesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a BlocksMesh's devices share one type, got {devs}")
        # "cuda" and "cuda:0" name one card: index every CUDA device
        self.devices = tuple(
            torch.device("cuda", torch.cuda.current_device() if d.index is None else d.index)
            if d.type == "cuda" else d for d in devs)

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """Shard 0's device, where the whole state lives in storage order."""
        return self.devices[0]

    def device_of(self, s: int) -> torch.device:
        return self.devices[s]

    def __eq__(self, other) -> bool:
        return isinstance(other, BlocksMesh) and self.devices == other.devices

    def __repr__(self) -> str:
        return f"BlocksMesh({[str(d) for d in self.devices]})"


def make_blocks_mesh(n_shards: Optional[int] = None, *, device=None) -> BlocksMesh:
    """`repro`'s rule: one shard per distinct visible CUDA device, the first
    ``n_shards`` of them (``None`` takes every one); a count above the
    visible cards raises. With ``device="cpu"`` each shard is one CPU
    device (``None`` gives 1 shard). A mesh with a device repeated is built
    explicitly: ``BlocksMesh([dev] * n)``."""
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cpu":
        n_shards = 1 if n_shards is None else n_shards
        if n_shards < 1:
            raise ValueError(f"n_shards={n_shards} must be >= 1")
        return BlocksMesh([dev] * n_shards)
    visible = torch.cuda.device_count()
    if n_shards is None:
        n_shards = visible
    if not 1 <= n_shards <= visible:
        raise ValueError(
            f"n_shards={n_shards} not in [1, {visible}] visible CUDA devices; "
            "a mesh repeating a device is built with BlocksMesh([dev] * n)")
    return BlocksMesh([torch.device("cuda", i) for i in range(n_shards)])


__all__ = ["BlocksMesh", "make_blocks_mesh"]
