"""Device-resident graph layout consumed by the partitioning supersteps.

Two layouts are kept:

  * the flat **directed** edges `[M]` — used by the quality metrics;
  * **blocked** per-chunk slabs `[n_blocks, e_max]` of the symmetrized
    adjacency — used by Revolver's sequential block scan and by the
    edge-phase kernel. The port adds `blk_row_ptr`, each slab's per-row
    pointer, and `blk_spans`, the edge-phase kernel's edge-balanced work
    split of the slabs (a `SpanPlan`), both built once per layout.

`repro`'s `DeviceGraph` also carries the flat symmetrized adjacency
(`edge_src` / `edge_dst` / `edge_w`), which no code of either package reads;
the port leaves it out (0.74 GB of device memory at full WIKI).

All per-vertex tensors are padded to `n_pad = n_blocks * block_v`; `vmask`
marks real vertices. Padding vertices carry zero degree and no edges so they
never influence loads or scores.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.graphs.blocking import (
    block_edges,
    check_integer_weights,
    slab_row_ptr,
    slab_span_plan,
)
from repro_torch.graphs.csr import Graph

# the edge-phase kernel's span plan: a span holds fewer than 2 x SPAN_EDGES
# slab entries (a hub row is cut into pieces of SPAN_EDGES) and at most
# SPAN_ROWS rows, which bounds its shared memory (`kernels.edge_phase`)
SPAN_EDGES = 2048
SPAN_ROWS = 128


def resolve_device(device) -> torch.device:
    """`torch.device` for an entry point's ``device=`` argument.

    A CUDA device without a usable CUDA runtime raises: the port never moves
    to the CPU on its own (pass ``device="cpu"`` for that).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


@dataclasses.dataclass(frozen=True, eq=False)
class SpanPlan:
    """The edge-phase kernel's work split of row-sorted slabs, built once
    per layout from the row pointer (`slab_span_plan`): each span is one CTA
    of the kernel, and each hub row's pieces are added by a second pass."""

    spans: torch.Tensor   # [nb, S, 5] int32 (e0, e1, r0, r1, part)
    hubs: torch.Tensor    # [nb, H, 3] int32 (row, first piece, pieces)
    span_edges: int
    row_cap: int

    @classmethod
    def from_row_ptr(cls, row_ptr: np.ndarray, device, *, span_edges: int = SPAN_EDGES,
                     row_cap: int = SPAN_ROWS) -> "SpanPlan":
        spans, hubs = slab_span_plan(row_ptr, span_edges, row_cap)
        dev = torch.device(device)
        return cls(torch.from_numpy(spans).to(dev), torch.from_numpy(hubs).to(dev),
                   span_edges, row_cap)

    def block(self, b: int) -> "SpanPlan":
        """The plan of block ``b`` alone (nb = 1), as views."""
        return dataclasses.replace(self, spans=self.spans[b:b + 1], hubs=self.hubs[b:b + 1])


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Static-shape tensors for one graph on one device. Ints are python."""

    n: int
    n_pad: int
    m: int                    # |E| directed edges
    n_blocks: int
    block_v: int
    e_max: int
    # flat *directed* edges (for the local-edges metric)
    dir_src: torch.Tensor     # [M] int32
    dir_dst: torch.Tensor     # [M] int32
    # blocked symmetrized adjacency (row-sorted, zero-weight padded tail)
    blk_dst: torch.Tensor     # [n_blocks, e_max] int32 (0 pad)
    blk_row: torch.Tensor     # [n_blocks, e_max] int32 local row (0 pad)
    blk_w: torch.Tensor       # [n_blocks, e_max] f32 (0.0 pad)
    blk_row_ptr: torch.Tensor  # [n_blocks, block_v+1] int32 row runs
    blk_spans: SpanPlan        # the edge-phase kernel's work split
    # per-vertex
    deg_out: torch.Tensor     # [n_pad] f32 outdegree (load contribution)
    inv_wsum: torch.Tensor    # [n_pad] f32 1/sum_u w_hat(u,v) (0 if isolated)
    vmask: torch.Tensor       # [n_pad] bool real-vertex mask

    @property
    def device(self) -> torch.device:
        return self.blk_dst.device


def device_graph_from_numpy(arrays: dict, device) -> DeviceGraph:
    """Build a `DeviceGraph` on ``device`` from its fields as numpy arrays
    and ints — e.g. the fields of `repro`'s `DeviceGraph` from
    ``jax.device_get(dg._asdict())``; fields the port does not keep are
    ignored. `blk_row_ptr` and `blk_spans` are derived from the slabs
    (`slab_row_ptr` also checks their row-sorted layout, and
    `check_integer_weights` the span kernels' weight contract). Arrays are
    copied.
    """
    dev = resolve_device(device)
    ints = {f: int(arrays[f])
            for f in ("n", "n_pad", "m", "n_blocks", "block_v", "e_max")}
    row_ptr = slab_row_ptr(arrays["blk_row"], arrays["blk_w"], ints["block_v"])
    check_integer_weights(arrays["blk_w"], row_ptr)
    dtypes = {"blk_w": np.float32, "deg_out": np.float32,
              "inv_wsum": np.float32, "vmask": bool}
    tensors = {}
    for f in ("dir_src", "dir_dst", "blk_dst", "blk_row", "blk_w", "deg_out",
              "inv_wsum", "vmask"):
        a = np.array(arrays[f], dtype=dtypes.get(f, np.int32))
        tensors[f] = torch.from_numpy(a).to(dev)
    tensors["blk_row_ptr"] = torch.from_numpy(row_ptr).to(dev)
    tensors["blk_spans"] = SpanPlan.from_row_ptr(row_ptr, dev)
    return DeviceGraph(**ints, **tensors)


def prepare_device_graph(g: Graph, n_blocks: int = 8, block_multiple: int = 8,
                         *, device="cuda") -> DeviceGraph:
    """Build the DeviceGraph with `n_blocks` asynchronous chunks on
    ``device`` (default CUDA; raises when it is unavailable)."""
    n_blocks = max(1, min(n_blocks, g.n))
    block_v = -(-g.n // n_blocks)
    block_v = -(-block_v // block_multiple) * block_multiple
    blocked = block_edges(g, block_v=block_v)
    return device_graph_from_numpy(dict(
        n=g.n,
        n_pad=blocked.n_pad,
        m=g.m,
        n_blocks=blocked.n_blocks,
        block_v=blocked.block_v,
        e_max=blocked.e_max,
        blk_dst=blocked.edge_dst,
        blk_row=blocked.edge_row,
        blk_w=blocked.edge_w,
        **vertex_arrays(g, blocked.n_pad),
    ), device)


def vertex_arrays(g: Graph, n_pad: int) -> dict:
    """The per-vertex fields (padded to ``n_pad``) and the flat directed
    edges of a `DeviceGraph` of ``g``, as numpy arrays."""
    deg_out = np.zeros(n_pad, dtype=np.float32)
    deg_out[: g.n] = g.deg_out.astype(np.float32)

    src_flat = np.repeat(np.arange(g.n, dtype=np.int32),
                         np.diff(g.adj_ptr).astype(np.int64))
    # sums of integer weights (eq.-(4)'s {1, 2}, or a contracted level's
    # sums of them): bincount sums in f64 (exact below 2^53) and rounds to
    # f32 once, so it equals the reference's sequential f32 np.add.at bit
    # for bit while a vertex's sum stays below 2^24
    wsum = np.zeros(n_pad, dtype=np.float32)
    wsum[: g.n] = np.bincount(src_flat, weights=g.adj_w, minlength=g.n)
    inv_wsum = np.where(wsum > 0, 1.0 / np.maximum(wsum, 1e-30), 0.0).astype(np.float32)

    vmask = np.zeros(n_pad, dtype=bool)
    vmask[: g.n] = True

    dir_src = np.repeat(np.arange(g.n, dtype=np.int32), np.diff(g.row_ptr).astype(np.int64))
    return dict(dir_src=dir_src, dir_dst=g.col_idx, deg_out=deg_out,
                inv_wsum=inv_wsum, vmask=vmask)


CAPACITY_MODES = ("spinner", "paper")


def capacity(m: int, k: int, epsilon: float, mode: str) -> float:
    """Partition capacity C.

    mode="spinner": C = (1+eps)|E|/k — Spinner's definition, the default.
    mode="paper":   C = eps|E|/k     — the literal Section III-A text (makes
                    every partition over-capacity; kept for faithfulness,
                    the footnote-1 shift in eq. (12) keeps it well-defined).
    """
    if mode == "spinner":
        return (1.0 + epsilon) * m / k
    if mode == "paper":
        return epsilon * m / k
    raise ValueError(f"unknown capacity mode {mode!r}")


@functools.lru_cache(maxsize=256)
def scalar_device(value: float, device: torch.device) -> torch.Tensor:
    """``value`` as a 0-dim f32 tensor on ``device``, cached so every
    superstep of a run reuses one buffer.

    The port divides by such a tensor, never by a Python number: CUDA
    divides by a host scalar as a multiply by its reciprocal, which does not
    round like an f32 division, so the card's result would drift from the
    CPU's (and the reference's) by an ulp.
    """
    return torch.tensor(value, dtype=torch.float32, device=device)


def capacity_device(m: int, k: int, epsilon: float, mode: str,
                    device: torch.device) -> torch.Tensor:
    """`capacity(...)` as a cached 0-dim f32 tensor on ``device`` (see
    `scalar_device`): the divisor of eqs. (5) and (12)."""
    return scalar_device(capacity(m, k, epsilon, mode), device)
