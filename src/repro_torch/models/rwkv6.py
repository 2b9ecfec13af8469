"""RWKV6 "Finch" (arXiv:2404.05892): attention-free time mix with
data-dependent decay, plus the RWKV channel mix.

Core recurrence per head (state [N, V] = key-dim x value-dim):

  y_t     = r_t · (state_{t-1} + u ⊙ k_t ⊗ v_t)
  state_t = diag(w_t) state_{t-1} + k_t ⊗ v_t

with w_t = exp(-exp(w0 + lora(x))), the data-dependent decay.

The counterpart of `repro.models.rwkv6`. Serving runs the recurrence
through `repro_torch.kernels.ops.wkv6`: a CPU tensor takes the
token-by-token plain version, a CUDA tensor the hand-written kernel K6,
for any sequence length; a given state is updated in place. Under autograd
(training: `ops.needs_grad`) it takes `wkv6_scan`, the same token-by-token
recurrence out of place, on either device: K6 has no backward, and an
in-place state update would break autograd. `repro`'s ``impl`` switch and
its ``"chunked"`` form (an XLA memory-planning variant whose result equals
the scan's, which `repro` trains through) have no counterpart, nor has the
spec's ``chunk``.

Rounding points are `repro`'s: the LoRA ``tanh`` and the ``mix`` product in
f32, cast back to the activation dtype; the decay LoRA as an f32 product;
r, k, v cast to f32 before the recurrence; the per-head group norm with f32
statistics and eps 64e-5, ``ln_x``'s affine on the f32 result, then a
cast; ``silu(g)`` in f32; the channel mix's ``square(relu(.))`` and
``sigmoid`` in f32.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.common import Dense, Norm, _normal, _param, dense, dense_init


@dataclasses.dataclass(frozen=True)
class RWKV6Spec:
    d_model: int
    n_heads: int
    d_ffn: int
    mix_rank: int = 32          # ddlerp LoRA rank
    decay_rank: int = 64        # decay LoRA rank

    @property
    def d_attn(self) -> int:
        return self.d_model

    @property
    def d_head(self) -> int:
        return self.d_attn // self.n_heads


class TimeMix(nn.Module):
    """The time-mix parameters, named as `repro`'s dict keys."""

    def __init__(self, *, mu_x, mu, mix_w1, mix_w2, wr: Dense, wk: Dense,
                 wv: Dense, wg: Dense, w0, decay_w1, decay_w2, u, ln_x: Norm,
                 wo: Dense):
        super().__init__()
        self.mu_x, self.mu = _param(mu_x), _param(mu)
        self.mix_w1, self.mix_w2 = _param(mix_w1), _param(mix_w2)
        self.wr, self.wk, self.wv, self.wg = wr, wk, wv, wg
        self.w0 = _param(w0)
        self.decay_w1, self.decay_w2 = _param(decay_w1), _param(decay_w2)
        self.u = _param(u)
        self.ln_x = ln_x
        self.wo = wo


class ChannelMix(nn.Module):
    """The channel-mix parameters, named as `repro`'s dict keys."""

    def __init__(self, *, mu_k, mu_r, wk: Dense, wv: Dense, wr: Dense):
        super().__init__()
        self.mu_k, self.mu_r = _param(mu_k), _param(mu_r)
        self.wk, self.wv, self.wr = wk, wv, wr


def init_rwkv6_time(gen: torch.Generator, spec: RWKV6Spec, dtype) -> TimeMix:
    """Random time-mix parameters on the generator's device, drawn in a
    fixed order (the scales of `repro`'s init, not its numbers)."""
    dev = gen.device
    d, da = spec.d_model, spec.d_attn
    h, n = spec.n_heads, spec.d_head
    rm, rd = spec.mix_rank, spec.decay_rank
    s = 1.0 / (d ** 0.5)
    return TimeMix(
        mu_x=torch.full((d,), 0.5, dtype=dtype, device=dev),
        mu=torch.full((5, d), 0.5, dtype=dtype, device=dev),   # w,k,v,r,g lerps
        mix_w1=_normal(gen, (d, 5 * rm), s, dtype),
        mix_w2=_normal(gen, (5, rm, d), 0.1, dtype),
        wr=dense_init(gen, d, da, dtype),
        wk=dense_init(gen, d, da, dtype),
        wv=dense_init(gen, d, da, dtype),
        wg=dense_init(gen, d, da, dtype),
        w0=torch.full((da,), -4.0, dtype=torch.float32, device=dev),  # slow decay
        decay_w1=_normal(gen, (d, rd), s, dtype),
        decay_w2=_normal(gen, (rd, da), 0.1, dtype),
        u=_normal(gen, (h, n), 0.1, torch.float32),
        ln_x=Norm(torch.ones((da,), dtype=dtype, device=dev),
                  torch.zeros((da,), dtype=dtype, device=dev)),
        wo=dense_init(gen, da, d, dtype),
    )


def init_rwkv6_channel(gen: torch.Generator, spec: RWKV6Spec, dtype) -> ChannelMix:
    d = spec.d_model
    return ChannelMix(
        mu_k=torch.full((d,), 0.5, dtype=dtype, device=gen.device),
        mu_r=torch.full((d,), 0.5, dtype=dtype, device=gen.device),
        wk=dense_init(gen, d, spec.d_ffn, dtype),
        wv=dense_init(gen, spec.d_ffn, d, dtype),
        wr=dense_init(gen, d, d, dtype),
    )


def _shift(x: torch.Tensor, x_prev: torch.Tensor | None = None) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros / carried state at t=0)."""
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, :1])
    return torch.cat([x_prev, x[:, :-1]], dim=1)


def _ddlerp(p: TimeMix, x: torch.Tensor, xs: torch.Tensor) -> list[torch.Tensor]:
    """Data-dependent lerp producing the 5 mixed inputs [5][B,S,d]."""
    xx = xs - x
    xxx = x + xx * p.mu_x
    r = torch.tanh((xxx @ p.mix_w1).float())
    rm = p.mix_w2.shape[1]
    b, s, _ = x.shape
    r = r.reshape(b, s, 5, rm)
    mix = torch.einsum("bsfr,frd->fbsd", r, p.mix_w2.float())
    return [x + xx * (p.mu[i] + mix[i].to(x.dtype)) for i in range(5)]


def _scan_step(rt, kt, vt, logwt, u, state):
    """One token of `wkv6_scan`: (y_t [B,H,N], the next state)."""
    att = state + u[None, :, :, None] * kt[..., None] * vt[..., None, :]
    y = torch.einsum("bhn,bhnm->bhm", rt, att)
    return y, state * torch.exp(logwt)[..., None] + kt[..., None] * vt[..., None, :]


def _scan_step_grads(rt, kt, vt, logwt, u, state, gy, gnext):
    """The gradients of `_scan_step`'s inputs (rt, kt, vt, logwt, u, state)
    from those of its outputs (gy [B,H,N], gnext [B,H,N,N]): the products
    autograd runs for one token, written out."""
    kv = kt[..., None] * vt[..., None, :]
    att = state + u[None, :, :, None] * kv
    w = torch.exp(logwt)
    g_att = torch.einsum("bhn,bhm->bhnm", rt, gy)
    g_r = torch.einsum("bhm,bhnm->bhn", gy, att)
    g_kv = g_att * u[None, :, :, None] + gnext
    return (g_r, (g_kv * vt[..., None, :]).sum(-1), (g_kv * kt[..., None]).sum(-2),
            (gnext * state).sum(-1) * w, (g_att * kv).sum((0, 3)),
            g_att + gnext * w[..., None])


class _CountedScan(torch.autograd.Function):
    """`wkv6_scan` on meta tensors (the dry run,
    `repro_torch.parallel.cost_count`): one token's step and its gradients
    (`_scan_step_grads`) counted S times over (`cost_count.repeat`), as
    `repro` counts a scan's body by its trip count. `looped_scan` on meta
    counts the same work within 25 % (``tests/test_torch_dryrun.py``) but
    runs S steps a layer in Python: rwkv6-3b's train_4k cell took 2,206 s
    that way on one CPU core against 11 s counted
    (``tools/torch_dryrun_scan_cost.py``). The step runs on a state split
    as r is over batch and heads, as every state after the first is in
    the loop; the two state-sized tensors a step keeps for backward are
    held as one meta tensor of S steps."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state0):
        from repro_torch.parallel.cost_count import repeat, split_empty

        s, shape = r.shape[1], tuple(state0.shape)
        state = split_empty(r, shape, {0: 0, 2: 1})
        # [S, 2, B, H, N, N], split as r [B, S, H, N] is over batch and heads
        kept = split_empty(r, (s, 2) + shape, {0: 2, 2: 3})
        ctx.save_for_backward(r, k, v, logw, u, state0, state, kept)
        with repeat(s):
            _, last = _scan_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], u, state)
        return torch.empty_like(r), last

    @staticmethod
    def backward(ctx, gy, gstate):
        from repro_torch.parallel.cost_count import repeat, split_empty

        r, k, v, logw, u, state0, state, _ = ctx.saved_tensors
        g_state = split_empty(r, tuple(state0.shape), {0: 0, 2: 1})   # the running gradient
        with repeat(r.shape[1]):
            _scan_step_grads(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], u, state, gy[:, 0],
                             g_state)
        return tuple(torch.empty_like(t) for t in (r, k, v, logw, u, state0))


def wkv6_scan(r, k, v, logw, u, state0):
    """The recurrence of `ops.wkv6` (f32 r, k, v, logw [B,S,H,N], u [H,N],
    state0 [B,H,N,N]) token by token, out of place and differentiable:
    (y [B,S,H,N] f32, the final state, a new tensor). `repro`'s
    ``_wkv_scan``. On meta tensors it is counted, not looped
    (`_CountedScan`)."""
    if r.device.type == "meta":
        return _CountedScan.apply(r, k, v, logw, u, state0)
    return looped_scan(r, k, v, logw, u, state0)


def looped_scan(r, k, v, logw, u, state0):
    """`wkv6_scan`'s token loop. The tokens are unbound once, so backward
    stacks their gradients once; indexing ``r[:, t]`` would write a zero
    [B,S,H,N] gradient a token and add S of them (S^2 bytes)."""
    state, ys = state0, []
    for rt, kt, vt, lt in zip(r.unbind(1), k.unbind(1), v.unbind(1), logw.unbind(1)):
        y, state = _scan_step(rt, kt, vt, lt, u, state)
        ys.append(y)
    return torch.stack(ys, 1), state


def apply_rwkv6_time(p: TimeMix, spec: RWKV6Spec, x: torch.Tensor, *,
                     x_prev: torch.Tensor | None = None,
                     wkv_state: torch.Tensor | None = None):
    """Time mix over x [B,S,d]. Returns (y, (last_x, wkv_state)).

    A given ``wkv_state`` ([B,H,N,N] f32, contiguous) is updated in place and
    returned (the serving cache's layer slice); without one the recurrence
    starts from zeros. Under autograd the recurrence is `wkv6_scan`, which
    returns a new state and leaves ``wkv_state`` as it was.
    """
    b, s, d = x.shape
    h, n = spec.n_heads, spec.d_head
    xw, xk, xv, xr, xg = _ddlerp(p, x, _shift(x, x_prev))
    r = dense(p.wr, xr).reshape(b, s, h, n)
    k = dense(p.wk, xk).reshape(b, s, h, n)
    v = dense(p.wv, xv).reshape(b, s, h, n)
    g = dense(p.wg, xg)
    dw = torch.tanh((xw @ p.decay_w1).float()) @ p.decay_w2.float()
    logw = -torch.exp(p.w0 + dw).reshape(b, s, h, n)        # log decay < 0

    if wkv_state is None:
        wkv_state = torch.zeros((b, h, n, n), dtype=torch.float32, device=x.device)
    rf, kf, vf = (t.float() for t in (r, k, v))
    if ops.needs_grad(rf, kf, vf, logw, p.u):
        y, state = wkv6_scan(rf, kf, vf, logw, p.u, wkv_state)
    else:
        y, state = ops.wkv6(rf, kf, vf, logw, p.u, wkv_state)

    # per-head group norm, then silu(g) gate and output proj
    mu = torch.mean(y, dim=-1, keepdim=True)
    var = torch.mean(torch.square(y - mu), dim=-1, keepdim=True)
    y = ((y - mu) * torch.rsqrt(var + 64e-5)).reshape(b, s, h * n)
    y = y * p.ln_x.g + p.ln_x.b
    y = y.to(x.dtype) * torch.nn.functional.silu(g.float()).to(x.dtype)
    return dense(p.wo, y), (x[:, -1:], state)


def apply_rwkv6_channel(p: ChannelMix, x: torch.Tensor, *,
                        x_prev: torch.Tensor | None = None):
    """Channel mix. Returns (y, last_x)."""
    xs = _shift(x, x_prev)
    xk = x + (xs - x) * p.mu_k
    xr = x + (xs - x) * p.mu_r
    k = torch.square(torch.relu(dense(p.wk, xk).float())).to(x.dtype)
    y = torch.sigmoid(dense(p.wr, xr).float()).to(x.dtype) * dense(p.wv, k)
    return y, x[:, -1:]
