"""Mixture-of-Experts layer (DeepSeek-V2 style: shared + routed top-k).

The counterpart of `repro.models.moe`'s single-device path
(``_apply_moe_local``). Dispatch is sort-based ("dropless-with-capacity"):
the [T*K] (token, choice) pairs are sorted by expert id (a stable sort),
each expert takes up to C slots (capacity factor over the mean load) in
that order, overflow is dropped. The [E, C, d] buffer is filled by a
gather (slot (e, c) reads the c-th pair of expert e's run), the experts
run as batched products over E, and the combine puts each pair's gated
output back in (token, choice) order (zeros for a dropped pair) and sums
the K choices of a token in a fixed order. Nothing scatters with
duplicate indices and nothing adds with atomics, so two calls on the card
are bit-equal; `repro` combines with ``.at[token_of].add`` in sorted-pair
order instead, which differs from the port's sum by rounding only.

The router's per-expert load, drop count and mean probabilities come back
with ``return_stats`` (the input of `repro`'s expert placement, ROADMAP
queue 1 item 15).

Not ported here: `repro`'s expert-parallel mesh paths
(``_apply_moe_shardmap``, ``_apply_moe_ep2d``), which come with the LM
parallelism of ROADMAP queue 1 item 18.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.models.common import Dense, _normal, _param, swiglu
from repro_torch.models.mlp import MLP, apply_mlp, init_mlp


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    n_experts: int             # routed experts
    top_k: int
    d_ff_expert: int
    n_shared: int = 0          # shared experts (always active)
    capacity_factor: float = 1.25
    norm_topk: bool = False    # renormalize top-k gates to sum to 1
    routed_scale: float = 1.0  # DeepSeek routed_scaling_factor


class MoE(nn.Module):
    """``router.w`` [d, E] f32, ``w_gate``/``w_up`` [E, d, f] and ``w_down``
    [E, f, d] (raw tensors, as `repro` keeps them), and the optional shared
    `MLP` of ``n_shared * f`` hidden units."""

    def __init__(self, router: Dense, w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, shared: MLP | None = None):
        super().__init__()
        self.router = router
        self.w_gate, self.w_up, self.w_down = _param(w_gate), _param(w_up), _param(w_down)
        self.shared = shared


def init_moe(gen: torch.Generator, spec: MoESpec, dtype) -> MoE:
    scale = 1.0 / (spec.d_model ** 0.5)
    e, d, f = spec.n_experts, spec.d_model, spec.d_ff_expert
    router = Dense(_normal(gen, (d, e), scale, torch.float32))
    w_gate = _normal(gen, (e, d, f), scale, dtype)
    w_up = _normal(gen, (e, d, f), scale, dtype)
    w_down = _normal(gen, (e, f, d), 1.0 / (f ** 0.5), dtype)
    shared = init_mlp(gen, d, f * spec.n_shared, dtype) if spec.n_shared else None
    return MoE(router, w_gate, w_up, w_down, shared)


def route(p_router: Dense, x2d: torch.Tensor, spec: MoESpec):
    """x2d [T, d] -> (gates [T, K] f32, idx [T, K] int32, probs [T, E] f32).
    Exact ties between probabilities may be broken otherwise than
    ``jax.lax.top_k`` does (lower index first)."""
    logits = x2d.float() @ p_router.w                              # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, spec.top_k, dim=-1)
    if spec.norm_topk:
        gates = gates / gates.sum(-1, keepdim=True)
    gates = gates * spec.routed_scale
    return gates, idx.to(torch.int32), probs


def moe_capacity(n_tokens: int, spec: MoESpec) -> int:
    c = int(n_tokens * spec.top_k * spec.capacity_factor / spec.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def apply_moe(p: MoE, x: torch.Tensor, spec: MoESpec, *, return_stats: bool = False):
    """x [B, S, d] (or [T, d]) -> same shape; with ``return_stats`` also
    ``{"expert_load" [E] f32, "dropped" (0-dim int64), "router_probs_mean"
    [E] f32, "top_idx" [T, K] int32}``."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    t, d = x2.shape
    e, k = spec.n_experts, spec.top_k
    cap = moe_capacity(t, spec)
    dev = x.device

    gates, idx, probs = route(p.router, x2, spec)

    # ---- sort-based dispatch ------------------------------------------------
    flat_e = idx.reshape(-1).long()                               # [T*K]
    order = torch.argsort(flat_e, stable=True)                    # [T*K]
    sorted_e = flat_e[order]
    experts = torch.arange(e, device=dev)
    seg_start = torch.searchsorted(sorted_e, experts)             # [E]
    count = torch.searchsorted(sorted_e, experts, right=True) - seg_start
    pos = torch.arange(t * k, device=dev) - seg_start[sorted_e]
    keep = pos < cap
    slot = torch.where(keep, sorted_e * cap + pos, 0)             # a drop reads slot 0

    # slot (e, c) holds expert e's c-th pair in sorted order, if it has one
    c_idx = torch.arange(cap, device=dev)
    filled = c_idx[None, :] < count[:, None]                      # [E, C]
    src = torch.clamp(seg_start[:, None] + c_idx[None, :], max=t * k - 1)
    h = torch.where(filled[..., None], x2[order[src] // k], 0)    # [E, C, d]

    # ---- expert computation (batched over E) --------------------------------
    act = swiglu(torch.bmm(h, p.w_gate), torch.bmm(h, p.w_up))
    out = torch.bmm(act, p.w_down).reshape(e * cap, d)

    # ---- combine: back to (token, choice) order, then a sum over K ----------
    pair_slot = torch.empty_like(slot)
    pair_slot[order] = slot
    pair_keep = torch.empty_like(keep)
    pair_keep[order] = keep
    contrib = torch.where(pair_keep[:, None], out[pair_slot], 0)  # [T*K, d]
    contrib = contrib * gates.reshape(-1, 1).to(x.dtype)
    y2 = contrib.reshape(t, k, d).sum(dim=1)

    if p.shared is not None:
        y2 = y2 + apply_mlp(p.shared, x2)

    y = y2.reshape(shape)
    if return_stats:
        return y, {"expert_load": count.float(), "dropped": torch.sum(~keep),
                   "router_probs_mean": probs.mean(dim=0), "top_idx": idx}
    return y


def moe_ref(p: MoE, x: torch.Tensor, spec: MoESpec) -> torch.Tensor:
    """O(T*E) dense oracle (no capacity drops) for tests."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    gates, idx, _ = route(p.router, x2, spec)
    y2 = torch.zeros_like(x2)
    for j in range(spec.n_experts):
        w = torch.where(idx == j, gates, 0.0).sum(-1)             # [T]
        act = swiglu(x2 @ p.w_gate[j], x2 @ p.w_up[j])
        y2 = y2 + (act @ p.w_down[j]) * w[:, None].to(x2.dtype)
    if p.shared is not None:
        y2 = y2 + apply_mlp(p.shared, x2)
    return y2.reshape(shape)
