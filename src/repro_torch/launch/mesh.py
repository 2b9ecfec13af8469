"""The port's meshes: the 1-D ``("blocks",)`` mesh of the sharded
partitioner superstep (`BlocksMesh`) and the LM mesh (`LMMesh`).

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

import itertools
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

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
        self.devices = _index_cuda(devs)

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


LM_AXES = ("pod", "data", "model")


def _index_cuda(devs) -> tuple:
    """"cuda" and "cuda:0" name one card: index every CUDA device."""
    return tuple(
        torch.device("cuda", torch.cuda.current_device() if d.index is None else d.index)
        if d.type == "cuda" else d for d in devs)


class LMMesh:
    """Named axes (a subset of ``("pod", "data", "model")``) over ``prod(shape)`` ranks. Rank r sits at the row-major coordinates of
    r in ``shape`` and runs on ``devices[r]``; entries may repeat (8 ranks
    on one card). ``devices=None`` builds a mesh for the spec functions
    only."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Optional[Iterable] = None):
        shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or not shape:
            raise ValueError(f"shape {shape} and axes {axis_names} differ in length")
        if len(set(axis_names)) != len(axis_names) or not set(axis_names) <= set(LM_AXES):
            raise ValueError(f"axes {axis_names} are not distinct names of {LM_AXES}")
        if min(shape) < 1:
            raise ValueError(f"shape {shape} has an empty axis")
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.devices: Optional[Tuple[torch.device, ...]] = None
        if devices is not None:
            devs = tuple(resolve_device(d) for d in devices)
            if len(devs) != math.prod(shape):
                raise ValueError(f"{len(devs)} devices for a mesh of {math.prod(shape)} ranks")
            if len({d.type for d in devs}) != 1:
                raise ValueError(f"an LMMesh's devices share one type, got {devs}")
            self.devices = _index_cuda(devs)

    @property
    def n_ranks(self) -> int:
        return math.prod(self.shape.values())

    @property
    def home(self) -> torch.device:
        return self.device_of(0)

    def device_of(self, rank: int) -> torch.device:
        if self.devices is None:
            raise ValueError("this mesh was built for specs only: it has no devices")
        return self.devices[rank]

    def coords(self, rank: int) -> Dict[str, int]:
        """``{axis: index}`` of ``rank`` (row-major, the last axis fastest)."""
        out = {}
        for name in reversed(self.axis_names):
            rank, out[name] = divmod(rank, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def rank_of(self, **coords: int) -> int:
        """The rank at ``coords`` (an axis left out is index 0)."""
        rank = 0
        for name in self.axis_names:
            rank = rank * self.shape[name] + coords.get(name, 0)
        return rank

    def axis_index(self, rank: int, axes) -> int:
        """``rank``'s index along ``axes`` (a name or a tuple of names, the
        first major), as `jax.lax.axis_index` gives it inside ``shard_map``;
        an axis the mesh lacks has size 1."""
        idx = 0
        for name in ((axes,) if isinstance(axes, str) else tuple(axes)):
            idx = idx * self.shape.get(name, 1) + self.coords(rank).get(name, 0)
        return idx

    def groups(self, axes) -> List[List[int]]:
        """The rank groups of a collective over ``axes`` (a name or a tuple):
        one group for each index of the other axes, the ranks in order of
        their index along ``axes``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        others = [n for n in self.axis_names if n not in axes]
        out = []
        for fixed in itertools.product(*(range(self.shape[n]) for n in others)):
            base = dict(zip(others, fixed))
            members = [r for r in range(self.n_ranks)
                       if all(self.coords(r)[n] == i for n, i in base.items())]
            out.append(sorted(members, key=lambda r: self.axis_index(r, axes)))
        return out

    def __eq__(self, other) -> bool:
        return (isinstance(other, LMMesh) and self.shape == other.shape
                and self.axis_names == other.axis_names and self.devices == other.devices)

    def __repr__(self) -> str:
        devs = None if self.devices is None else [str(d) for d in self.devices]
        return f"LMMesh({self.shape}, devices={devs})"


def make_mesh_compat(shape: Sequence[int], axes: Sequence[str], *, device=None) -> LMMesh:
    """`repro`'s ``make_mesh_compat``: an `LMMesh` of ``shape`` over one
    distinct CUDA device a rank (a count above the visible cards raises),
    or with ``device="cpu"`` every rank on the CPU. A mesh repeating a card
    is built explicitly: ``LMMesh(shape, axes, [dev] * n)``."""
    dev = resolve_device("cuda" if device is None else device)
    n = math.prod(shape)
    if dev.type == "cpu":
        return LMMesh(shape, axes, [dev] * n)
    visible = torch.cuda.device_count()
    if n > visible:
        raise ValueError(f"a mesh of {n} ranks needs {n} CUDA devices, {visible} visible; "
                         "a mesh repeating a device is built with LMMesh(shape, axes, [dev] * n)")
    return LMMesh(shape, axes, [torch.device("cuda", i) for i in range(n)])


def make_production_mesh(*, multi_pod: bool = False) -> LMMesh:
    """`repro`'s production meshes for the spec functions, without devices:
    single-pod (data=16, model=16) = 256 ranks; multi-pod (pod=2, data=16,
    model=16) = 512."""
    if multi_pod:
        return LMMesh((2, 16, 16), ("pod", "data", "model"))
    return LMMesh((16, 16), ("data", "model"))


def make_host_mesh(*, device=None) -> LMMesh:
    """One rank with the production axis names (tests and smoke runs)."""
    return make_mesh_compat((1, 1), ("data", "model"), device=device)


__all__ = ["BlocksMesh", "make_blocks_mesh", "LMMesh", "LM_AXES", "make_mesh_compat",
           "make_production_mesh", "make_host_mesh"]
