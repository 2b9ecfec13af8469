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
device. Layout transforms (alignment, block permutation, the halo plan and
its hub replication plan) run on the host copy and upload once; each
shard's part of the hub plan is a `HubSlabs`. `hub_oracle_slabs` uploads a
1-shard plan for the sequential hub schedule.
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
class HubSlabs:
    """One shard's part of a halo plan's hub replication, on the shard's
    device: the plan vectors (replicated on every shard's device), the
    shard's vote slab and its vertex mask with the hubs cleared."""

    owner: torch.Tensor          # [hub_pad] int32 owner shard (-1 pad)
    local: torch.Tensor          # [hub_pad] int64 row in the owner's slice (0 pad)
    deg: torch.Tensor            # [hub_pad] f32 outdegree (0 pad)
    ids: torch.Tensor            # [n_hubs] int64 the hubs' storage ids
    src: torch.Tensor            # [he_max] int64 local row of each vote (0 pad)
    slot: torch.Tensor           # [he_max] int64 hub slot it votes for (0 pad)
    w: torch.Tensor              # [he_max] int32 its weight (0 pad)
    vmask_nonhub: torch.Tensor   # [local_n] bool real, non-hub vertices

    @property
    def hub_pad(self) -> int:
        return self.owner.shape[0]


@dataclasses.dataclass(frozen=True, eq=False)
class ShardSlabs:
    """One shard's slice of a sharded layout, on the shard's device.

    On the layout's home device these are views of the whole layout's
    tensors; on another device, copies. ``blk_dst`` holds global (storage)
    vertex ids, ``blk_dst_halo`` the same slabs rewritten into the shard's
    ``local + halo + hub`` buffer space (halo layouts only). The span plan
    was derived from the shard's own row pointers (`SpanPlan.from_row_ptr`);
    the halo rewrite changes ids, not rows, so both slabs share it. ``hub``
    is the shard's part of the hub plan (halo layouts with hubs only); the
    halo and async schedules then scan with its ``vmask_nonhub``.
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
    hub: Optional[HubSlabs] = None


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
    A spec with hubs (``hubs_on``) gives every shard its `HubSlabs`.
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

    @property
    def hubs_on(self) -> bool:
        """Whether the halo and async schedules replicate hubs here."""
        return self.shards[0].hub is not None


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
    plan, with hub replication when ``hubs`` is given (ignored without
    ``halo``, as in `repro`). ``interior_first`` composes
    `interior_first_order` on top (the async schedule's layout: each
    shard's interior blocks first) and plans again. Returns ``(arrays,
    perm, spec)``: storage-order arrays, the block permutation (None:
    natural order) and the `HaloSpec` (None without ``halo``)."""
    aligned = _align_host(arrays, n_shards)
    perm = resolve_assignment(aligned, n_shards, assignment)

    def plan(perm):
        laid = _permute_host(aligned, perm) if perm is not None else aligned
        spec = None
        if halo:
            spec = _halo_spec(laid, n_shards, halo_threshold, halo_granularity, hubs)
        return laid, spec

    laid, spec = plan(perm)
    if interior_first and spec is not None:
        order = interior_first_order(spec)
        if order is not None:
            perm = perm[order] if perm is not None else order
            laid, spec = plan(perm)
    return laid, perm, spec


def _halo_spec(laid: dict, n_shards: int, threshold: float, granularity: str,
               hubs: Optional[HubConfig]) -> HaloSpec:
    """`build_halo_spec` of storage-order host arrays (with the per-vertex
    arrays and row slabs the hub plan reads)."""
    extra = {}
    if hubs is not None:
        extra = dict(hubs=hubs, deg=np.asarray(laid["deg_out"]),
                     vmask=np.asarray(laid["vmask"]), blk_row=np.asarray(laid["blk_row"]))
    return build_halo_spec(np.asarray(laid["blk_dst"]), np.asarray(laid["blk_w"]), n_shards,
                           laid["block_v"], threshold=threshold, granularity=granularity,
                           **extra)


def device_halo_spec(dg: DeviceGraph, n_shards: int,
                     threshold: float = DEFAULT_HALO_THRESHOLD, granularity: str = "auto",
                     hubs: Optional[HubConfig] = None) -> HaloSpec:
    """The halo plan, with ``hubs`` its hub plan, of ``dg``'s storage-order
    slabs over ``n_shards`` shards (the arrays it reads downloaded once);
    ``n_shards=1`` with hubs is the sequential hub oracle's plan."""
    names = ("blk_dst", "blk_w") + (("blk_row", "deg_out", "vmask") if hubs is not None else ())
    laid = {f: getattr(dg, f).cpu().numpy() for f in names}
    return _halo_spec(dict(laid, block_v=dg.block_v), n_shards, threshold, granularity, hubs)


def _check_vote_sums(spec: HaloSpec) -> None:
    """The vote table's contract: the integer weights that vote for one hub
    slot, over every shard, sum below 2^31 (the span kernels' check,
    `check_integer_weights`, on each slot's sum), so the int32 table is
    exact. Raises ValueError otherwise."""
    sums = np.bincount(spec.hub_slot.reshape(-1), weights=spec.hub_w.reshape(-1),
                       minlength=spec.hub_pad)
    try:
        check_integer_weights(sums[None, :], np.arange(spec.hub_pad + 1)[None, :])
    except ValueError as e:
        raise ValueError(f"the hub vote table's int32 sums: {e}") from e


def _hub_slabs(spec: HaloSpec, s: int, dev: torch.device, repl: dict) -> HubSlabs:
    """Shard ``s``'s `HubSlabs` on ``dev``; ``repl`` caches the replicated
    plan vectors per device."""
    if dev not in repl:
        n, local_n = spec.n_hubs, spec.local_n
        ids = (spec.hub_owner[:n].astype(np.int64) * local_n
               + spec.hub_local[:n].astype(np.int64))
        repl[dev] = dict(
            owner=torch.from_numpy(spec.hub_owner.astype(np.int32)).to(dev),
            local=torch.from_numpy(spec.hub_local.astype(np.int64)).to(dev),
            deg=torch.from_numpy(spec.hub_deg.astype(np.float32)).to(dev),
            ids=torch.from_numpy(ids).to(dev))
    verts = slice(s * spec.local_n, (s + 1) * spec.local_n)
    return HubSlabs(
        **repl[dev],
        src=torch.from_numpy(spec.hub_src[s].astype(np.int64)).to(dev),
        slot=torch.from_numpy(spec.hub_slot[s].astype(np.int64)).to(dev),
        w=torch.from_numpy(spec.hub_w[s].astype(np.int32)).to(dev),
        vmask_nonhub=torch.from_numpy(np.ascontiguousarray(spec.vmask_nonhub[verts])).to(dev))


_SLAB_FIELDS = _BLOCKED_FIELDS + ("blk_row_ptr",)


def _upload_shards(dg: DeviceGraph, mesh, spec: Optional[HaloSpec], *,
                   row_ptr: Optional[np.ndarray] = None, slabs=None):
    """Each shard's `ShardSlabs` on its device (views of ``dg`` on the home
    device), with the halo plan's slabs, exchange indices and hub plan.
    ``row_ptr`` is ``dg``'s row pointer on the host (downloaded when None);
    ``slabs[s]``, when given, holds shard s's slabs and row pointer
    (`_SLAB_FIELDS`) already resident on its device (the incremental
    layout keeps them across deltas)."""
    n_shards = mesh.n_shards
    bps = dg.n_blocks // n_shards
    bv = dg.block_v
    local_n = bps * bv
    if row_ptr is None:
        row_ptr = dg.blk_row_ptr.cpu().numpy()
    halo_dst = {}
    use_halo = spec is not None and not spec.fallback
    use_hubs = use_halo and spec.hub_owner is not None
    if use_hubs:
        _check_vote_sums(spec)
    hub_repl: dict = {}
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
        if use_hubs:
            extra["hub"] = _hub_slabs(spec, s, dev, hub_repl)
        own = (slabs[s] if slabs is not None
               else {f: place(getattr(dg, f)[blocks]) for f in _SLAB_FIELDS})
        shards.append(ShardSlabs(
            device=dev, **own,
            blk_spans=SpanPlan.from_row_ptr(row_ptr[blocks], dev),
            deg=place(dg.deg_out[verts]), inv_wsum=place(dg.inv_wsum[verts]),
            vmask=place(dg.vmask[verts]), **extra))
    return tuple(shards)


def hub_oracle_slabs(dg: DeviceGraph, spec: HaloSpec) -> Optional[ShardSlabs]:
    """The sequential hub schedule's layout (`repro`'s 1-shard hub oracle):
    ``dg``'s slabs rewritten into the ``[n_pad | hub]`` buffer by the
    1-shard ``spec``, with its `HubSlabs`, on ``dg``'s device (the other
    fields are ``dg``'s own tensors). None when the plan carries no hubs or
    fell back."""
    if spec.n_shards != 1:
        raise ValueError("the sequential schedule takes a 1-shard halo plan; got "
                         f"n_shards={spec.n_shards}")
    if spec.fallback or spec.hub_owner is None:
        return None
    _check_vote_sums(spec)
    dev = dg.device
    return ShardSlabs(
        device=dev, blk_dst=dg.blk_dst, blk_row=dg.blk_row, blk_w=dg.blk_w,
        blk_row_ptr=dg.blk_row_ptr, blk_spans=dg.blk_spans, deg=dg.deg_out,
        inv_wsum=dg.inv_wsum, vmask=dg.vmask,
        blk_dst_halo=torch.from_numpy(np.ascontiguousarray(spec.blk_dst_halo)).to(dev),
        hub=_hub_slabs(spec, 0, dev, {}))


def sharded_layout(dg: DeviceGraph, mesh, perm: Optional[np.ndarray] = None,
                   spec: Optional[HaloSpec] = None) -> ShardedDeviceGraph:
    """The `ShardedDeviceGraph` of a planned layout: ``dg`` holds
    `plan_layout`'s storage-order arrays on the mesh's home device, ``perm``
    and ``spec`` are its block permutation and halo plan (a plan made
    elsewhere, e.g. in another process, is placed here without planning
    again)."""
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
        return sharded_layout(dg, mesh)
    arrays = host_arrays(dg)
    laid, perm, spec = plan_layout(
        arrays, mesh.n_shards, assignment=assignment, halo=halo,
        halo_threshold=halo_threshold, halo_granularity=halo_granularity, hubs=hubs,
        interior_first=interior_first)
    if laid is not arrays:
        dg = device_graph_from_numpy(laid, mesh.home)
    return sharded_layout(dg, mesh, perm, spec)


def attach_halo(sdg: ShardedDeviceGraph, halo_threshold: float = DEFAULT_HALO_THRESHOLD, *,
                halo_granularity: str = "auto",
                hubs: Optional[HubConfig] = None) -> ShardedDeviceGraph:
    """Build (or rebuild) the halo plan, and with ``hubs`` its hub
    replication plan, of an already laid-out sharded layout, keeping its
    storage order."""
    spec = device_halo_spec(sdg.dg, sdg.n_shards, halo_threshold, halo_granularity, hubs)
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
    return sharded_layout(dg, mesh, perm, spec)
