"""Public wrappers of the port's kernels, routed by device.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
hand-written kernel or raises. There is no other route and no fallback: a
kernel that fails to build or launch raises to the caller.

The attention kernels K4 and K5, the recurrence K6 and the bf16 SwiGLU F1
have no backward: their outputs carry no ``grad_fn``. So
`flash_attention`, `decode_attention`, `wkv6` and `swiglu` raise a
RuntimeError when grad mode is on and an input requires grad
(`needs_grad`), on either device, rather than hand autograd a result whose
inputs would get zero gradients. The models take their differentiable
plain forms on that route instead (`repro_torch.models.attention.attend`,
`repro_torch.models.rwkv6`, `repro_torch.models.common.swiglu`).

On a meta tensor (the dry run) those four return outputs of the right
shapes and report their counted FLOPs and the tensors they read and write
through `count_kernel` instead of launching; the partitioner kernels have
no meta route and raise.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import decode_attention as _decode_attention
from repro_torch.kernels import edge_histogram as _edge_histogram
from repro_torch.kernels import edge_phase as _edge_phase
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import hub_reconcile as _hub_reconcile
from repro_torch.kernels import la_update as _la_update
from repro_torch.kernels import swiglu as _swiglu
from repro_torch.kernels import wkv6 as _wkv6

LAUNCH_COUNTERS = {
    "fused_edge_phase": _edge_phase.LAUNCHES,
    "la_update": _la_update.LAUNCHES,
    "edge_histogram": _edge_histogram.LAUNCHES,
    "edge_histogram_float": _edge_histogram.FLOAT_LAUNCHES,
    "flash_attention": _flash_attention.LAUNCHES,
    "decode_attention": _decode_attention.LAUNCHES,
    "wkv6": _wkv6.LAUNCHES,
    "hub_reconcile": _hub_reconcile.LAUNCHES,
    "swiglu": _swiglu.LAUNCHES,
}


def launch_counts() -> dict:
    """``{kernel name: launches so far}`` for every kernel wrapper."""
    return {name: c.count for name, c in LAUNCH_COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in LAUNCH_COUNTERS.values():
        c.reset()


# the dry run's hook (name, flops, reads, writes) while a cost counter
# (`repro_torch.parallel.cost_count`) counts on this thread
KERNEL_HOOK = threading.local()


def count_kernel(name: str, work) -> None:
    """Report a meta route's counted work (FLOPs over the whole call, the
    tensors read once, the tensors written once) to the cost counter
    counting on this thread; nothing happens when none is."""
    hook = getattr(KERNEL_HOOK, "fn", None)
    if hook is not None:
        hook(name, *work)


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether a forward over ``tensors`` would be recorded by autograd:
    grad mode on and one of them requires grad (the training route)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _no_backward(what: str, *tensors: torch.Tensor) -> None:
    if needs_grad(*tensors):
        raise RuntimeError(f"{what} has no backward; a forward under autograd takes the "
                           f"model's differentiable plain form (ops.needs_grad)")


def _route(t: torch.Tensor, what: str, *, meta: bool = False) -> str:
    if t.device.type in ("cpu", "cuda") or (meta and t.device.type == "meta"):
        return t.device.type
    raise ValueError(f"{what} has no implementation for device {t.device}")


def fused_edge_phase(edge_dst, edge_rows, edge_vals, labels, lam, actions,
                     feasible, *, row_ptr, spans=None, block_v: int, k: int,
                     weight_mode: str = "self_lambda"):
    """(hist_score, w_acc), both [nb, block_v, k] f32 — see
    `repro_torch.kernels.edge_phase`.

    The `repro.kernels.ops.fused_edge_phase` signature plus ``row_ptr``
    ([nb, block_v+1] int32, the row runs of the row-sorted slabs) and
    ``spans`` (their `SpanPlan`, e.g. `DeviceGraph.blk_spans`), by which the
    CUDA kernel splits the slabs instead of scattering by ``edge_rows``;
    the CPU path reads neither.
    """
    if _route(edge_dst, "fused_edge_phase") == "cpu":
        return _edge_phase.fused_edge_phase_plain(
            edge_dst, edge_rows, edge_vals, labels, lam, actions, feasible,
            block_v=block_v, k=k, weight_mode=weight_mode)
    if spans is None:
        raise ValueError("fused_edge_phase on CUDA needs the slabs' span plan (spans=)")
    return _edge_phase.fused_edge_phase_cuda(
        edge_dst, edge_vals, row_ptr, spans, labels, lam, actions, feasible,
        block_v=block_v, k=k, weight_mode=weight_mode)


def la_update(probs, weights, signals, alpha: float, beta: float, *,
              renorm: bool = True):
    """Weighted-LA probability update (eqs. 8/9) on [..., k] — see
    `repro_torch.kernels.la_update`. Returns a new tensor."""
    if _route(probs, "la_update") == "cpu":
        return _la_update.la_update_plain(probs, weights, signals, alpha,
                                          beta, renorm=renorm)
    return _la_update.la_update_cuda(probs, weights, signals, alpha, beta,
                                     renorm=renorm)


def edge_histogram(slots, rows, vals, *, row_ptr, block_v: int, k: int, spans=None,
                   labels=None, integer_values: bool = False):
    """hist [nb, block_v, k] f32, hist[b, r, l] = sum of ``vals[b, e]``
    over slab entries with ``rows[b, e] == r`` and slot l — see
    `repro_torch.kernels.edge_histogram`.

    The `repro.kernels.edge_histogram.edge_histogram_pallas` signature
    (without ``edge_chunk``) plus ``row_ptr`` ([nb, block_v+1] int32, the
    row runs of the row-sorted slabs), by which the CUDA kernels split the
    slabs instead of scattering by ``rows``. The slot of entry e is
    ``slots[b, e]``, or with ``labels`` (the gather form) ``labels[slots[b,
    e]]``, ``slots`` then holding the neighbor ids.

    ``integer_values=True`` states that the values are small non-negative
    integers (the eq.-(4) weights): on CUDA they then take the span kernel
    over ``spans`` (the slabs' `SpanPlan`, e.g. `DeviceGraph.blk_spans`),
    else the row walk, which sums any f32 values. The gather form needs the
    statement. The CPU path reads neither ``row_ptr`` nor ``spans``.
    """
    if labels is not None and not integer_values:
        raise ValueError("the gather form (labels=) sums integer values only "
                         "(integer_values=True)")
    if _route(slots, "edge_histogram") == "cpu":
        if labels is not None:
            slots = labels[slots]
        return _edge_histogram.edge_histogram_plain(slots, rows, vals,
                                                    block_v=block_v, k=k)
    if not integer_values:
        return _edge_histogram.edge_histogram_cuda(slots, vals, row_ptr,
                                                   block_v=block_v, k=k)
    if spans is None:
        raise ValueError("edge_histogram on CUDA with integer values needs the slabs' "
                         "span plan (spans=)")
    return _edge_histogram.edge_histogram_spans_cuda(slots, vals, row_ptr, spans,
                                                     block_v=block_v, k=k, labels=labels)


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """Causal / sliding-window GQA attention, q [B,Hq,Sq,D] against k, v
    [B,Hkv,Skv,D] -> [B,Hq,Sq,D] in q's dtype — see
    `repro_torch.kernels.flash_attention`. Raises under autograd."""
    _no_backward("flash_attention", q, k, v)
    route = _route(q, "flash_attention", meta=True)
    if route == "meta":
        out, work = _flash_attention.flash_attention_meta(q, k, v, causal=causal,
                                                          window=window)
        count_kernel("flash_attention", work)
        return out
    if route == "cpu":
        return _flash_attention.flash_attention_plain(q, k, v, causal=causal,
                                                      window=window)
    return _flash_attention.flash_attention_cuda(q, k, v, causal=causal,
                                                 window=window)


def decode_attention(q, k_cache, v_cache, kv_len, *, return_lse: bool = False):
    """One query token per sequence, q [B,Hq,D], against the first
    ``kv_len[b]`` positions of caches [B,Hkv,S,D] -> o [B,Hq,D] (and, with
    ``return_lse``, m and l [B,Hq] f32) — see
    `repro_torch.kernels.decode_attention`. Raises under autograd."""
    _no_backward("decode_attention", q, k_cache, v_cache)
    route = _route(q, "decode_attention", meta=True)
    if route == "meta":
        out, work = _decode_attention.decode_attention_meta(
            q, k_cache, v_cache, kv_len, return_lse=return_lse)
        count_kernel("decode_attention", work)
        return out
    if route == "cpu":
        return _decode_attention.decode_attention_plain(
            q, k_cache, v_cache, kv_len, return_lse=return_lse)
    return _decode_attention.decode_attention_cuda(
        q, k_cache, v_cache, kv_len, return_lse=return_lse)


def wkv6(r, k, v, logw, u, state0):
    """RWKV6 recurrence, r/k/v/logw [B,S,H,N], u [H,N], state0 [B,H,N,N],
    all f32 -> (y [B,S,H,N] f32, state0), the final state written over
    ``state0`` — see `repro_torch.kernels.wkv6`. Raises under autograd."""
    _no_backward("wkv6", r, k, v, logw, u, state0)
    route = _route(r, "wkv6", meta=True)
    if route == "meta":
        out, work = _wkv6.wkv6_meta(r, k, v, logw, u, state0)
        count_kernel("wkv6", work)
        return out
    if route == "cpu":
        return _wkv6.wkv6_plain(r, k, v, logw, u, state0)
    return _wkv6.wkv6_cuda(r, k, v, logw, u, state0)


def hub_reconcile(votes, cur, hub_deg, hub_owner, loads, cap):
    """The hub vote reconcile of hub replication: winners [hub_pad] int32
    from the merged int32 votes [hub_pad, k], ``loads`` ([k] f32) updated in
    place — see `repro_torch.kernels.hub_reconcile`."""
    if _route(votes, "hub_reconcile") == "cpu":
        return _hub_reconcile.hub_reconcile_plain(votes, cur, hub_deg, hub_owner, loads, cap)
    return _hub_reconcile.hub_reconcile_cuda(votes, cur, hub_deg, hub_owner, loads, cap)


def swiglu(gate, up):
    """SiLU(gate) * up in bf16 with `repro`'s ``bf16_silu`` roundings, gate
    and up of one shape -> the product — see `repro_torch.kernels.swiglu`.
    Raises under autograd."""
    _no_backward("swiglu", gate, up)
    route = _route(gate, "swiglu", meta=True)
    if route == "meta":
        out, work = _swiglu.swiglu_bf16_meta(gate, up)
        count_kernel("swiglu", work)
        return out
    if route == "cpu":
        return _swiglu.swiglu_bf16_plain(gate, up)
    return _swiglu.swiglu_bf16_cuda(gate, up)
