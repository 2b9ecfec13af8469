"""Collectives of the port's single-process meshes.

The port of `repro.parallel.collectives`: the LM collectives
(``lse_combine`` and ``sharded_decode_attention``, flash-decode over a
seq-sharded KV cache through K5; ``ef_int8_psum``, the error-feedback
int8 gradient all-reduce) and the partitioner primitives
(``gather_shards``, ``psum_delta_merge``, ``vertex_halo_exchange``,
``hub_gather``, ``shard_chain_key``) and the hub vote merge of `repro`'s
reconcile (``hub_votes``). `repro` runs them inside ``shard_map``
as XLA collectives; the port's mesh is a list of devices driven by one
process (`repro_torch.launch.mesh`), so each collective is a function of
the per-shard tensor list (shard s's tensor on ``mesh.device_of(s)``) and
the mesh, made of concatenations, indexed gathers and
``.to(dst, non_blocking=True)`` copies. Results come back as per-shard
lists in shard order; shards on one device may share a read-only result.
The LM collectives take an `LMMesh` or a `BlocksMesh` (its ranks are the
shards) for the group they reduce over, or ``None`` for one result.

Division is by 0-dim device tensors, never by a host scalar: CUDA turns
the latter into a multiply by the reciprocal, which rounds otherwise.

`count_collective` is the cost hook of the dry run
(`repro_torch.parallel.cost_count`): the cost counter reports through it the
collectives a sharded step would issue (the partial sums a sharded
contraction leaves, the flash-decode combine of a split cache). No step the
dry run counts calls the collectives below, so they do not report. With no
counter active it does nothing.
"""
from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Sequence

import torch


# the cost counter's hook (kind, nbytes, axes) while one counts on this thread
_HOOK = threading.local()


def count_collective(kind: str, nbytes: float, axes=None) -> None:
    """Report one collective (``kind`` "all-reduce", "all-gather", ...) of
    ``nbytes`` sent by one rank over the mesh ``axes`` (None: the
    collective's own group) to the cost counter counting on this thread;
    nothing happens when none is."""
    hook = getattr(_HOOK, "fn", None)
    if hook is not None:
        hook(kind, float(nbytes), axes)


def _per_device(mesh, make):
    """``[make(dev) for each shard's device]``, computed once per distinct
    device (shards on one device share the result)."""
    cache: Dict[torch.device, torch.Tensor] = {}
    out = []
    for dev in mesh.devices:
        if dev not in cache:
            cache[dev] = make(dev)
        out.append(cache[dev])
    return out


def _to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return x if x.device == dev else x.to(dev, non_blocking=True)


def gather_shards(xs: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """All-gather per-shard slices back to the global vector: shard t gets
    ``cat(xs)`` on its device, a fresh tensor of its own (the sharded
    schedule drifts each shard's copy independently)."""
    return [torch.cat([_to(x, dev) for x in xs]) for dev in mesh.devices]


def psum(xs: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Sum per-shard tensors across shards; every shard gets the sum on its
    device (``mesh=None``: one entry, on ``xs[0]``'s device). Floating
    values are accumulated in f64 in shard order and rounded once, so
    integer-valued sums (degree demands) are exact below 2^53, in any
    order, and equal `repro`'s f32 psum below 2^24."""
    home = xs[0].device

    def acc(x):
        return torch.float64 if x.is_floating_point() else torch.int64

    if len({x.dtype for x in xs}) == 1:         # one stack, one widening cast
        total = torch.stack([_to(x, home) for x in xs]).to(acc(xs[0])).sum(0)
    else:
        total = torch.stack([_to(x, home).to(acc(x)) for x in xs]).sum(0)
    total = total.to(xs[0].dtype)
    if mesh is None:
        return [total]
    return _per_device(mesh, lambda dev: _to(total, dev))


def psum_delta_merge(base: torch.Tensor, deltas: Sequence[torch.Tensor], mesh) -> torch.Tensor:
    """``base + psum(deltas)`` on ``base``'s device — merge the shards'
    load deltas. The deltas are integer-valued f32 (degree sums); they are
    summed in int64 with the integer base and rounded to f32 once, so the
    merge is exact past 2^24 (ROADMAP item 19), and equal to `repro`'s f32
    psum below it. On one shard it is ``base + delta``."""
    dev = base.device
    total = torch.stack([_to(d, dev).to(torch.float64) for d in deltas]).sum(0)
    return (base.to(torch.int64) + total.round().to(torch.int64)).to(base.dtype)


def halo_exchange(xs: Sequence[torch.Tensor], rows: Sequence[torch.Tensor], mesh,
                  blocks_per_shard: int, block_v: int) -> List[torch.Tensor]:
    """Boundary-block halo sync: shard t contributes the ``[b_max]`` blocks
    of its slice that remote slabs reference (``rows[t]``, int64 on t's
    device — `repro.core.halo`'s ``boundary_rows[t]``), and every shard gets
    all contributions ``[S * b_max * block_v]`` in shard order: the tail its
    rewritten slab ids point into. The values are the start-of-superstep
    snapshots the full gather would deliver."""
    contrib = [x.view(blocks_per_shard, block_v).index_select(0, r)
               for x, r in zip(xs, rows)]
    return _per_device(mesh, lambda dev: torch.cat([_to(c, dev) for c in contrib]).view(-1))


def vertex_halo_exchange(xs: Sequence[torch.Tensor], send_ids: Sequence[torch.Tensor], mesh,
                         wire_dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """Per-vertex halo sync, `repro`'s ragged all-to-all: ``send_ids[s]``
    ([S, h_max] int64 on s's device, `repro.core.halo`'s ``send_ids[s]``)
    lists the local rows shard s sends to each shard t, 0-padded. Shard t's
    tail ``[S * h_max]`` holds at ``s * h_max + p`` the p-th vertex it needs
    from shard s. ``wire_dtype`` (int8 for label fields when k <= 127)
    narrows what moves and is restored after: exact for in-range values.
    Tensors on one device skip the copy, not the cast."""
    n_shards = mesh.n_shards
    h_max = send_ids[0].shape[1] if send_ids else 0
    dtype = xs[0].dtype
    if h_max == 0:
        return [x.new_zeros((0,)) for x in xs]
    contrib = []
    for x, ids in zip(xs, send_ids):
        c = x.index_select(0, ids.view(-1))
        contrib.append(c.to(wire_dtype) if wire_dtype is not None else c)
    return [torch.cat([_to(contrib[s].view(n_shards, h_max)[t], dev) for s in range(n_shards)])
            .to(dtype) for t, dev in enumerate(mesh.devices)]


def hub_gather(xs: Sequence[torch.Tensor], hub_owner: torch.Tensor, hub_local: torch.Tensor,
               mesh) -> List[torch.Tensor]:
    """Assemble `repro`'s replicated hub region from the owners' slices:
    each shard masks the slots it does not own to zero and the masked
    vectors are summed (one contributor per slot, so the sum is an exact
    broadcast; pad slots, owner -1, assemble to 0). ``hub_owner`` /
    ``hub_local`` are [hub_pad] int tensors on any device. Every shard gets
    the region on its device. The same assembly of the post-scan labels is
    the reconcile's current hub labels (`repro`'s masked ``cur`` psum).
    ``mesh=None`` is one shard on ``xs[0]``'s device (the sequential hub
    schedule)."""
    vals = []
    for s, x in enumerate(xs):
        owner = _to(hub_owner, x.device)
        v = x.index_select(0, torch.clamp_min(_to(hub_local, x.device), 0).long())
        vals.append(torch.where(owner == s, v, torch.zeros_like(v)))
    return psum(vals, mesh)


def hub_votes(labels: Sequence[torch.Tensor], srcs: Sequence[torch.Tensor],
              slots: Sequence[torch.Tensor], weights: Sequence[torch.Tensor], hub_pad: int,
              k: int, home: torch.device) -> torch.Tensor:
    """The merged hub vote table ``[hub_pad, k]`` int32 on ``home``: shard
    s adds each of its vote slab's weights ``weights[s]`` (int32) at
    ``(slots[s], labels[s][srcs[s]])`` into a table of its own (int32, on
    its device; ``labels[s]`` is its local slice after the scan), and the
    tables are summed in int64. Integer sums: exact and independent of the
    order of the adds, shards included. The layout guarantees that every
    slot's sum stays below 2^31 (`repro_torch.core.device_graph`)."""
    total = None
    for lab, src, slot, w in zip(labels, srcs, slots, weights):
        flat = torch.zeros((hub_pad * k,), dtype=torch.int32, device=lab.device)
        flat.index_add_(0, slot * k + lab.index_select(0, src).long(), w)
        part = _to(flat, home).to(torch.int64)
        total = part if total is None else total + part
    return total.to(torch.int32).view(hub_pad, k)


def _div(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x / value`` as an IEEE division by a cached 0-dim f32 tensor on
    ``x``'s device (module docstring)."""
    from repro_torch.core.device_graph import scalar_device
    return x / scalar_device(float(value), x.device)


# --------------------------------------------------------------------------
# flash-decode over a seq-sharded KV cache
# --------------------------------------------------------------------------
def lse_combine(os: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                ls: Sequence[torch.Tensor], mesh=None) -> List[torch.Tensor]:
    """Merge per-shard partial attention — outputs ``os[s]`` [..., D], running
    maxima ``ms[s]`` and sums ``ls[s]`` [...] — into the full softmax output
    (f32), `repro`'s ``lse_combine_psum``: each shard's normalised output is
    reweighted by its mass ``exp(m_s - max_s m) * l_s``. The sums run in
    shard order on shard 0's device; every shard gets the result on its
    device (``mesh=None``: one entry)."""
    home = os[0].device
    o = [_to(x, home).float() for x in os]
    m = [_to(x, home) for x in ms]
    l_ = [_to(x, home) for x in ls]
    m_g = torch.stack(m).amax(0)
    scale = [torch.exp(mi - m_g) * li for mi, li in zip(m, l_)]
    denom = scale[0]
    num = o[0] * scale[0][..., None]
    for oi, si in zip(o[1:], scale[1:]):
        denom = denom + si
        num = num + oi * si[..., None]
    out = num / torch.clamp_min(denom, 1e-30)[..., None]
    if mesh is None:
        return [out]
    return _per_device(mesh, lambda dev: _to(out, dev))


def sharded_decode_attention(q: torch.Tensor, k_shards: Sequence[torch.Tensor],
                             v_shards: Sequence[torch.Tensor],
                             kv_len_locals: Sequence[torch.Tensor], mesh=None) -> List[torch.Tensor]:
    """Flash-decode where the cache's seq axis is split into shards:
    q [B,Hq,D] (replicated), ``k_shards[s]`` / ``v_shards[s]``
    [B,Hkv,S_s,D] on shard s's device, ``kv_len_locals[s]`` [B] int32 the
    valid length within shard s. Each shard runs K5
    (`ops.decode_attention` with ``return_lse``); the partials merge in
    f32 (`lse_combine`) and are cast to q's dtype. Returns [B,Hq,D] for
    each shard (``mesh=None``: one entry). A shard with no valid row adds
    nothing (K5 gives it l = 0)."""
    from repro_torch.kernels import ops

    os, ms, ls = [], [], []
    for k, v, n in zip(k_shards, v_shards, kv_len_locals):
        o, m, l_ = ops.decode_attention(_to(q, k.device), k, v, n, return_lse=True)
        os.append(o)
        ms.append(m)
        ls.append(l_)
    return [x.to(q.dtype) for x in lse_combine(os, ms, ls, mesh)]


# --------------------------------------------------------------------------
# error-feedback int8 compressed all-reduce (gradient compression)
# --------------------------------------------------------------------------
def _quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 codes of f32 ``x`` and their scale (0-dim
    f32): scale = (max |x| + 1e-12) / 127, codes = round-half-even(x /
    scale) clipped to [-127, 127], as `repro`'s."""
    amax = x.abs().amax() + 1e-12
    scale = _div(amax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def ef_int8_psum(gs: Sequence[torch.Tensor], errs: Sequence[torch.Tensor], mesh=None):
    """`repro`'s ``ef_int8_psum`` over the ranks of ``gs``: each rank
    quantises its gradient plus its carried error to int8 (the wire format,
    4x smaller than f32), the dequantised values are summed across ranks
    (`psum`) and divided by the rank count. Returns (the mean-reduced f32
    gradient for each rank, each rank's new error ``g + err - deq``); the
    residual carried to the next step keeps the compression unbiased in
    the long run."""
    deqs, new_errs = [], []
    for g, err in zip(gs, errs):
        x = g.float() + err
        q, scale = _quantize_int8(x)
        deq = q.float() * scale
        new_errs.append(x - deq)
        deqs.append(deq)
    total = psum(deqs, None)[0]
    mean = _div(total, float(len(deqs)))
    if mesh is None:
        return [mean], new_errs
    return _per_device(mesh, lambda dev: _to(mean, dev)), new_errs


def _derived_seed(gen: torch.Generator, s: int) -> int:
    """A 63-bit seed from the generator's state bytes and ``s``. Reading a
    CUDA generator's state reads its host-side seed and offset: no sync."""
    data = gen.get_state().numpy().tobytes() + int(s).to_bytes(8, "little")
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little") >> 1


def shard_chain_key(gen: torch.Generator, mesh) -> List[torch.Generator]:
    """Per-shard generators for a superstep, `repro`'s ``shard_chain_key``:
    shard 0 draws from ``gen`` itself (so a 1-shard mesh repeats the
    sequential schedule's draws), shard s > 0 from a generator on its device
    seeded from ``gen``'s state and s, which consumes no draw of ``gen``.
    Derive them before shard 0 draws. After the superstep the state's
    generator is shard 0's chain, advanced in place: `repro`'s
    ``replicated_chain_key``, with nothing to gather (a checkpoint still
    carries one generator)."""
    return [gen] + [torch.Generator(device=mesh.device_of(s)).manual_seed(_derived_seed(gen, s))
                    for s in range(1, mesh.n_shards)]


def replicated_key(gen: torch.Generator, mesh) -> List[torch.Generator]:
    """Per-shard generators that all draw what ``gen`` would: shard 0 uses
    ``gen``, every other shard a copy of its state on its own device — the
    Spinner rule's semantics, where every shard draws from the same key and
    slices the global draw."""
    state = gen.get_state()
    out = [gen]
    for s in range(1, mesh.n_shards):
        g = torch.Generator(device=mesh.device_of(s))
        g.set_state(state)
        out.append(g)
    return out


__all__ = ["count_collective", "lse_combine", "sharded_decode_attention", "ef_int8_psum",
           "gather_shards", "psum", "psum_delta_merge", "halo_exchange",
           "vertex_halo_exchange", "hub_gather", "hub_votes", "shard_chain_key",
           "replicated_key"]
