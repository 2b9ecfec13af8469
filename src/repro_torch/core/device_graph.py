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

The sharded layout (`ShardedDeviceGraph`, `shard_device_graph`,
`prepare_sharded_device_graph`) is `repro`'s over the port's single-process
mesh (`repro_torch.launch.mesh`): the whole layout stays on the mesh's home
device, and each shard's slabs, span plan and halo plan sit on its own
device. Layout transforms (alignment, block permutation, the halo plan) run
on the host copy and upload once.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.halo import (
    DEFAULT_HALO_THRESHOLD,
    HaloSpec,
    HubConfig,
    build_halo_spec,
    interior_first_order,
)
from repro_torch.graphs.blocking import (
    block_adjacency,
    block_edges,
    check_integer_weights,
    locality_block_order,
    slab_row_ptr,
    slab_span_plan,
    vcycle_block_order,
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
    return device_graph_from_numpy(graph_host_arrays(g, n_blocks, block_multiple), device)


def graph_host_arrays(g: Graph, n_blocks: int = 8, block_multiple: int = 8) -> dict:
    """The host arrays of `prepare_device_graph`'s layout of ``g``: the
    fields `device_graph_from_numpy` takes."""
    n_blocks = max(1, min(n_blocks, g.n))
    block_v = -(-g.n // n_blocks)
    block_v = -(-block_v // block_multiple) * block_multiple
    blocked = block_edges(g, block_v=block_v)
    return dict(n=g.n, n_pad=blocked.n_pad, m=g.m, n_blocks=blocked.n_blocks,
                block_v=blocked.block_v, e_max=blocked.e_max, blk_dst=blocked.edge_dst,
                blk_row=blocked.edge_row, blk_w=blocked.edge_w,
                **vertex_arrays(g, blocked.n_pad))


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


# ---------------------------------------------------------------------------
# the sharded layout: chunk_schedule="sharded" | "halo" | "async"
# ---------------------------------------------------------------------------
_INT_FIELDS = ("n", "n_pad", "m", "n_blocks", "block_v", "e_max")
_BLOCKED_FIELDS = ("blk_dst", "blk_row", "blk_w")
_VERTEX_FIELDS = ("deg_out", "inv_wsum", "vmask")


def host_arrays(dg: DeviceGraph) -> dict:
    """The fields of ``dg`` that `device_graph_from_numpy` takes, as numpy
    arrays and ints (the layout's host copy; one download)."""
    out = {f: getattr(dg, f) for f in _INT_FIELDS}
    for f in ("dir_src", "dir_dst") + _BLOCKED_FIELDS + _VERTEX_FIELDS:
        out[f] = getattr(dg, f).cpu().numpy()
    return out


def _align_host(arrays: dict, multiple: int) -> dict:
    """`align_blocks` on host arrays."""
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    pad_blocks = (-arrays["n_blocks"]) % multiple
    if pad_blocks == 0:
        return arrays
    nb = arrays["n_blocks"] + pad_blocks
    n_pad = nb * arrays["block_v"]
    pad_v = n_pad - arrays["n_pad"]
    out = dict(arrays, n_blocks=nb, n_pad=n_pad)
    for f in _BLOCKED_FIELDS:
        a = np.asarray(arrays[f])
        out[f] = np.concatenate([a, np.zeros((pad_blocks, a.shape[1]), a.dtype)])
    for f in _VERTEX_FIELDS:
        out[f] = np.pad(np.asarray(arrays[f]), (0, pad_v))
    return out


def align_blocks(dg: DeviceGraph, multiple: int) -> DeviceGraph:
    """Pad ``dg`` with empty blocks until ``n_blocks % multiple == 0``.

    Padding blocks carry all-zero slabs (dst=0, row=0, w=0.0) and masked-out
    vertices with zero degree, exactly like the in-block padding the kernels
    already ignore, so they change no score, load, or migration.
    """
    if multiple > 0 and dg.n_blocks % multiple == 0:
        return dg
    return device_graph_from_numpy(_align_host(host_arrays(dg), multiple), dg.device)


def block_vertex_perms(perm: np.ndarray, block_v: int):
    """Vertex-id maps induced by a block permutation.

    Returns `(o2s, s2o)` int32 `[n_blocks * block_v]` arrays: `o2s[v]` is
    the storage position of original vertex `v` (its block moved, its row
    within the block did not), `s2o` the inverse.
    """
    perm = np.asarray(perm, dtype=np.int64)
    nb = perm.size
    pos = np.empty(nb, dtype=np.int64)
    pos[perm] = np.arange(nb)
    v = np.arange(nb * block_v, dtype=np.int64)
    o2s = pos[v // block_v] * block_v + v % block_v
    s2o = np.empty_like(o2s)
    s2o[o2s] = v
    return o2s.astype(np.int32), s2o.astype(np.int32)


def _check_perm(perm: np.ndarray, n_blocks: int) -> np.ndarray:
    perm = np.asarray(perm, dtype=np.int64)
    if perm.shape != (n_blocks,) or not np.array_equal(np.sort(perm), np.arange(n_blocks)):
        raise ValueError(f"perm must be a permutation of range({n_blocks})")
    return perm


def _permute_host(arrays: dict, perm: np.ndarray) -> dict:
    """`permute_blocks` on host arrays."""
    nb, bv = arrays["n_blocks"], arrays["block_v"]
    perm = _check_perm(perm, nb)
    if np.array_equal(perm, np.arange(nb)):
        return arrays
    o2s, _ = block_vertex_perms(perm, bv)
    out = dict(arrays)
    for f in ("dir_src", "dir_dst"):
        out[f] = o2s[np.asarray(arrays[f])]
    out["blk_dst"] = o2s[np.asarray(arrays["blk_dst"])[perm]]
    for f in ("blk_row", "blk_w"):
        out[f] = np.asarray(arrays[f])[perm]
    for f in _VERTEX_FIELDS:
        out[f] = np.asarray(arrays[f]).reshape(nb, bv)[perm].reshape(-1)
    return out


def permute_blocks(dg: DeviceGraph, perm: np.ndarray) -> DeviceGraph:
    """Reorder the blocked layout so storage slot i holds block `perm[i]`.

    Every vertex id in the returned graph — slab neighbor ids and the flat
    metric arrays included — is rewritten into the permuted space, so the
    result is a self-consistent `DeviceGraph`: the engine, the kernels, and
    the metrics consume it exactly like an unpermuted one. Its row pointer
    and span plan are derived anew from the permuted slabs. Only the
    *meaning* of index v changes (storage slot, not original vertex id);
    callers that cross the boundary convert with `block_vertex_perms` /
    `vertices_to_original`.
    """
    perm = _check_perm(perm, dg.n_blocks)
    if np.array_equal(perm, np.arange(dg.n_blocks)):
        return dg
    return device_graph_from_numpy(_permute_host(host_arrays(dg), perm), dg.device)


def resolve_assignment(arrays: dict, n_shards: int, assignment):
    """Turn an `assignment=` argument into a block permutation (or None).

    ``arrays`` are a layout's `host_arrays`. "contiguous" / None keep the
    natural block striping; "locality" runs the greedy co-location pass
    over the block-level edge-cut matrix; "vcycle" the one-level-up
    multilevel solve of the same problem (`vcycle_block_order`); an explicit
    array is validated and used as-is. Identity permutations collapse to
    None.
    """
    if assignment is None or (isinstance(assignment, str) and assignment == "contiguous"):
        return None
    nb = arrays["n_blocks"]
    if isinstance(assignment, str):
        if assignment not in ("locality", "vcycle"):
            raise ValueError(
                f"unknown assignment {assignment!r}; expected 'contiguous', "
                "'locality', 'vcycle', or an explicit block permutation")
        adj = block_adjacency(arrays["blk_dst"], arrays["blk_w"], arrays["block_v"])
        order_fn = locality_block_order if assignment == "locality" else vcycle_block_order
        perm = order_fn(adj, n_shards)
    else:
        perm = _check_perm(assignment, nb)
    if np.array_equal(perm, np.arange(nb)):
        return None
    return np.asarray(perm, dtype=np.int64)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardSlabs:
    """One shard's slice of a sharded layout, on the shard's device.

    On the layout's home device these are views of the whole layout's
    tensors; on another device, copies. ``blk_dst`` holds global (storage)
    vertex ids, ``blk_dst_halo`` the same slabs rewritten into the shard's
    ``local + halo`` buffer space (halo layouts only). The span plan was
    derived from the shard's own row pointers (`SpanPlan.from_row_ptr`); the
    halo rewrite changes ids, not rows, so both slabs share it.
    """

    device: torch.device
    blk_dst: torch.Tensor        # [bps, e_max] int32 global ids
    blk_row: torch.Tensor        # [bps, e_max] int32
    blk_w: torch.Tensor          # [bps, e_max] f32
    blk_row_ptr: torch.Tensor    # [bps, block_v+1] int32
    blk_spans: SpanPlan          # the slabs' span plan (nb = bps)
    deg: torch.Tensor            # [local_n] f32
    inv_wsum: torch.Tensor       # [local_n] f32
    vmask: torch.Tensor          # [local_n] bool
    blk_dst_halo: Optional[torch.Tensor] = None   # [bps, e_max] int32 buffer ids
    halo_rows: Optional[torch.Tensor] = None      # [b_max] int64 own blocks sent
    send_ids: Optional[torch.Tensor] = None       # [S, h_max] int64 rows sent to each shard


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedDeviceGraph:
    """A `DeviceGraph` laid out over a `BlocksMesh`.

    ``dg`` is the whole layout in storage order on the mesh's home device
    (shard 0's): the state, the metrics and the sequential schedule read it.
    Shard s owns the contiguous blocks ``[s * bps, (s + 1) * bps)`` and the
    matching vertex range; ``shards[s]`` holds their slabs and per-vertex
    slices on ``mesh.device_of(s)``. Attribute access falls through to
    ``dg``.

    **Locality-aware assignment**: the stored block order is permuted so
    each shard's slice is a cluster of densely connected blocks;
    ``block_perm`` / ``o2s`` / ``s2o`` record the mapping (``o2s_t`` and
    ``s2o_t`` are its tensors on the home device). Labels and probabilities
    cross the public API boundary in *original* vertex order.

    **Halo exchange**: ``halo`` is the numpy `HaloSpec` of the
    ``"halo"`` / ``"async"`` schedules (None: only the full gather runs).
    """

    dg: DeviceGraph
    mesh: Any
    n_shards: int
    blocks_per_shard: int
    shards: Tuple[ShardSlabs, ...]
    block_perm: Optional[Tuple[int, ...]] = None
    o2s: Optional[np.ndarray] = None
    s2o: Optional[np.ndarray] = None
    o2s_t: Optional[torch.Tensor] = None
    s2o_t: Optional[torch.Tensor] = None
    halo: Optional[HaloSpec] = None

    def __getattr__(self, name):
        if name == "dg":      # not yet set (copy/pickle): no recursion
            raise AttributeError(name)
        return getattr(self.dg, name)

    @property
    def local_n(self) -> int:
        return self.blocks_per_shard * self.dg.block_v


def vertices_to_original(sdg, x: torch.Tensor) -> torch.Tensor:
    """Reindex a storage-order per-vertex tensor into original vertex order
    (identity for unpermuted layouts and plain `DeviceGraph`s)."""
    o2s = getattr(sdg, "o2s_t", None)
    if o2s is None:
        return x
    return x.index_select(0, o2s.to(x.device, non_blocking=True))


def plan_layout(arrays: dict, n_shards: int, *, assignment="contiguous", halo: bool = False,
                halo_threshold: float = DEFAULT_HALO_THRESHOLD, halo_granularity: str = "auto",
                hubs: Optional[HubConfig] = None, interior_first: bool = False):
    """The host half of a sharded layout: align ``arrays`` (`host_arrays`)
    to ``n_shards``, resolve and apply the assignment, and build the halo
    plan. ``interior_first`` composes `interior_first_order` on top (the
    async schedule's layout: each shard's interior blocks first) and plans
    again. Returns ``(arrays, perm, spec)``: storage-order arrays, the
    block permutation (None: natural order) and the `HaloSpec` (None
    without ``halo``)."""
    if hubs is not None:
        raise NotImplementedError(
            "hub replication is not ported yet; it comes with ROADMAP queue 1 item 9 "
            "(multi-GPU schedules, second half)")
    aligned = _align_host(arrays, n_shards)
    perm = resolve_assignment(aligned, n_shards, assignment)

    def plan(perm):
        laid = _permute_host(aligned, perm) if perm is not None else aligned
        spec = None
        if halo:
            spec = build_halo_spec(laid["blk_dst"], laid["blk_w"], n_shards, laid["block_v"],
                                   threshold=halo_threshold, granularity=halo_granularity)
        return laid, spec

    laid, spec = plan(perm)
    if interior_first and spec is not None:
        order = interior_first_order(spec)
        if order is not None:
            perm = perm[order] if perm is not None else order
            laid, spec = plan(perm)
    return laid, perm, spec


def _upload_shards(dg: DeviceGraph, mesh, spec: Optional[HaloSpec]):
    """Each shard's `ShardSlabs` on its device (views of ``dg`` on the home
    device), with the halo plan's slabs and exchange indices."""
    n_shards = mesh.n_shards
    bps = dg.n_blocks // n_shards
    bv = dg.block_v
    local_n = bps * bv
    row_ptr = dg.blk_row_ptr.cpu().numpy()
    halo_dst = {}
    use_halo = spec is not None and not spec.fallback
    shards = []
    for s, dev in enumerate(mesh.devices):
        blocks = slice(s * bps, (s + 1) * bps)
        verts = slice(s * local_n, (s + 1) * local_n)

        def place(t):
            return t if t.device == dev else t.to(dev)

        extra = {}
        if use_halo:
            if dev not in halo_dst:
                halo_dst[dev] = torch.from_numpy(np.ascontiguousarray(spec.blk_dst_halo)).to(dev)
            extra["blk_dst_halo"] = halo_dst[dev][blocks]
            if spec.granularity == "vertex":
                extra["send_ids"] = torch.from_numpy(spec.send_ids[s].astype(np.int64)).to(dev)
            else:
                extra["halo_rows"] = torch.from_numpy(
                    spec.boundary_rows[s].astype(np.int64)).to(dev)
        shards.append(ShardSlabs(
            device=dev,
            blk_dst=place(dg.blk_dst[blocks]), blk_row=place(dg.blk_row[blocks]),
            blk_w=place(dg.blk_w[blocks]), blk_row_ptr=place(dg.blk_row_ptr[blocks]),
            blk_spans=SpanPlan.from_row_ptr(row_ptr[blocks], dev),
            deg=place(dg.deg_out[verts]), inv_wsum=place(dg.inv_wsum[verts]),
            vmask=place(dg.vmask[verts]), **extra))
    return tuple(shards)


def _sharded(dg: DeviceGraph, mesh, perm, spec) -> ShardedDeviceGraph:
    o2s = s2o = o2s_t = s2o_t = None
    if perm is not None:
        o2s, s2o = block_vertex_perms(perm, dg.block_v)
        o2s_t = torch.from_numpy(o2s.astype(np.int64)).to(dg.device)
        s2o_t = torch.from_numpy(s2o.astype(np.int64)).to(dg.device)
    return ShardedDeviceGraph(
        dg=dg, mesh=mesh, n_shards=mesh.n_shards,
        blocks_per_shard=dg.n_blocks // mesh.n_shards,
        shards=_upload_shards(dg, mesh, spec),
        block_perm=tuple(int(b) for b in perm) if perm is not None else None,
        o2s=o2s, s2o=s2o, o2s_t=o2s_t, s2o_t=s2o_t, halo=spec)


def shard_device_graph(dg: DeviceGraph, mesh, *, assignment="contiguous", halo: bool = False,
                       halo_threshold: float = DEFAULT_HALO_THRESHOLD,
                       halo_granularity: str = "auto", hubs: Optional[HubConfig] = None,
                       interior_first: bool = False) -> ShardedDeviceGraph:
    """Lay ``dg`` (on the mesh's home device) out over ``mesh``: align its
    blocks to the shard count, apply ``assignment`` ("contiguous" keeps the
    natural striping, "locality" / "vcycle" co-locate densely connected
    blocks, an explicit ``[n_blocks]`` permutation is used verbatim), build
    the halo plan with ``halo=True`` (`repro_torch.core.halo`:
    ``halo_threshold`` sets the coverage above which it falls back to the
    full gather, ``halo_granularity`` the exchange unit), and place each
    shard's slabs on its device. ``interior_first`` orders each shard's
    interior blocks first (the async schedule's layout). A contiguous,
    already aligned layout keeps ``dg``'s tensors; anything else is
    rebuilt from its host copy."""
    if dg.device != mesh.home:
        raise ValueError(f"dg lives on {dg.device}, the mesh's home device is {mesh.home}")
    if (assignment is None or (isinstance(assignment, str) and assignment == "contiguous")) \
            and not halo and hubs is None and dg.n_blocks % mesh.n_shards == 0:
        return _sharded(dg, mesh, None, None)
    arrays = host_arrays(dg)
    laid, perm, spec = plan_layout(
        arrays, mesh.n_shards, assignment=assignment, halo=halo,
        halo_threshold=halo_threshold, halo_granularity=halo_granularity, hubs=hubs,
        interior_first=interior_first)
    if laid is not arrays:
        dg = device_graph_from_numpy(laid, mesh.home)
    return _sharded(dg, mesh, perm, spec)


def attach_halo(sdg: ShardedDeviceGraph, halo_threshold: float = DEFAULT_HALO_THRESHOLD, *,
                halo_granularity: str = "auto",
                hubs: Optional[HubConfig] = None) -> ShardedDeviceGraph:
    """Build (or rebuild) the halo plan of an already laid-out sharded
    layout, keeping its storage order."""
    if hubs is not None:
        plan_layout({}, 1, hubs=hubs)      # raises: not ported yet
    spec = build_halo_spec(sdg.dg.blk_dst.cpu().numpy(), sdg.dg.blk_w.cpu().numpy(),
                           sdg.n_shards, sdg.block_v, threshold=halo_threshold,
                           granularity=halo_granularity)
    return dataclasses.replace(sdg, halo=spec,
                               shards=_upload_shards(sdg.dg, sdg.mesh, spec))


def prepare_sharded_device_graph(g: Graph, mesh, n_blocks: int = 8, block_multiple: int = 8, *,
                                 assignment="contiguous", halo: bool = False,
                                 halo_threshold: float = DEFAULT_HALO_THRESHOLD,
                                 halo_granularity: str = "auto",
                                 hubs: Optional[HubConfig] = None,
                                 interior_first: bool = False) -> ShardedDeviceGraph:
    """`prepare_device_graph` laid out over ``mesh`` (see
    `shard_device_graph`), built on the host and uploaded once. Requests at
    least one block per shard; the block count the blocking pass settles
    on is then padded to a multiple of the shard count."""
    arrays = graph_host_arrays(g, max(n_blocks, mesh.n_shards), block_multiple)
    return shard_host_arrays(arrays, mesh, assignment=assignment, halo=halo,
                             halo_threshold=halo_threshold,
                             halo_granularity=halo_granularity, hubs=hubs,
                             interior_first=interior_first)


def shard_host_arrays(arrays: dict, mesh, **knobs) -> ShardedDeviceGraph:
    """A sharded layout of a `DeviceGraph`'s host arrays (`host_arrays`, or
    a graph's blocked arrays): `plan_layout` with ``knobs``, then one
    upload. Several layouts of one graph share its host arrays."""
    laid, perm, spec = plan_layout(arrays, mesh.n_shards, **knobs)
    dg = device_graph_from_numpy(laid, mesh.home)
    return _sharded(dg, mesh, perm, spec)
