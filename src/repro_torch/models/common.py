"""Shared model primitives: parameter modules, inits, norms, rotary and
sinusoidal position embeddings, the SwiGLU activation, the training loss
(`chunked_cross_entropy`) and per-block rematerialisation (`maybe_remat`).

`repro.models.common` keeps parameters in nested dicts with a stacked
``[L, ...]`` layer axis; the port keeps them in small `nn.Module`s whose
attribute names are `repro`'s dict keys (``w``/``b``, ``g``/``b``, ``emb``),
so that a `repro` parameter tree maps onto `state_dict` names one to one
(`repro_torch.models.convert`). Dense weights are ``[d_in, d_out]`` and
applied as ``x @ w``, as in `repro`. Parameters are made with
``requires_grad=False``, so serving builds no autograd graph;
`repro_torch.train.step.train_state` turns them on
(``model.requires_grad_(True)``) for training. Serving runs under
`torch.inference_mode` either way.

Rounding points are `repro`'s: norms take f32 statistics and apply them in
the activation dtype, RoPE rotates in f32 and casts back, SiLU runs in f32
— or, under `repro`'s ``bf16_silu`` switch of the mesh context
(`repro_torch.parallel.act_sharding`), in the activation dtype with a
rounding after each step (`swiglu`).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.kernels import swiglu as _swiglu
from repro_torch.parallel.act_sharding import get_ctx


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class MetaDraws:
    """Stands in for a `torch.Generator` when a model is built on the meta
    device (the dry run, `repro_torch.parallel.cost_count`): every draw of
    an init then returns a meta tensor of the drawn shape and dtype, which
    allocates nothing and draws nothing."""

    device = torch.device("meta")


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """f32 normal draws on the generator's device, scaled, then cast; on
    the meta device (`MetaDraws`) an empty meta tensor of the dtype."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=gen.device)
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(dtype)


# --------------------------------------------------------------------------
# parameter modules and initializers
# --------------------------------------------------------------------------
class Dense(nn.Module):
    """``y = x @ w (+ b)`` with ``w`` [d_in, d_out]."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = _param(w)
        self.b = None if b is None else _param(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self, x)


class Norm(nn.Module):
    """Scale ``g`` (and, for a biased LayerNorm, shift ``b``) of `apply_norm`."""

    def __init__(self, g: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.g = _param(g)
        self.b = None if b is None else _param(b)


class Embed(nn.Module):
    """Token table ``emb`` [vocab, d]."""

    def __init__(self, emb: torch.Tensor):
        super().__init__()
        self.emb = _param(emb)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, *,
               scale: float | None = None, bias: bool = False) -> Dense:
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    w = _normal(gen, (d_in, d_out), scale, dtype)
    b = torch.zeros((d_out,), dtype=dtype, device=gen.device) if bias else None
    return Dense(w, b)


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w
    if p.b is not None:
        y = y + p.b
    return y


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype) -> Embed:
    return Embed(_normal(gen, (vocab, d), 0.02, dtype))


def norm_init(d: int, dtype, device, *, kind: str = "rms",
              bias: bool = False) -> Norm:
    g = torch.ones((d,), dtype=dtype, device=device)
    b = torch.zeros((d,), dtype=dtype, device=device) if kind == "layer" and bias else None
    return Norm(g, b)


def apply_norm(p: Norm, x: torch.Tensor, *, kind: str = "rms",
               eps: float = 1e-5) -> torch.Tensor:
    """Normalization with f32 statistics applied in the activation dtype."""
    if kind == "rms":
        ms = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
        y = x * torch.rsqrt(ms + eps).to(x.dtype)
    elif kind == "layer":
        xf = x.float()
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True) - mu * mu
        y = (x - mu.to(x.dtype)) * torch.rsqrt(var + eps).to(x.dtype)
    else:
        raise ValueError(kind)
    y = y * p.g
    if p.b is not None:
        y = y + p.b
    return y


# --------------------------------------------------------------------------
# rotary position embeddings (full or partial)
# --------------------------------------------------------------------------
def rope_freqs(d_rot: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_rot, 2, dtype=torch.float32, device=device) / d_rot
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               d_rot: int | None = None, theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, D]; positions: broadcastable to [..., S]. Rotates the
    first ``d_rot`` channels (pairwise halves convention), passthrough rest."""
    d = x.shape[-1]
    if d_rot is None:
        d_rot = d
    inv = rope_freqs(d_rot, theta, device=x.device)              # [d_rot/2]
    ang = positions[..., None].float() * inv                     # [..., S, d_rot/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x_rot, x_pass = x[..., :d_rot], x[..., d_rot:]
    x1, x2 = torch.chunk(x_rot.float(), 2, dim=-1)
    r = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([r.to(x.dtype), x_pass], dim=-1)


def sinusoid_pos(n: int, d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """[n, d] sin / cos table (Whisper's encoder positions): built in numpy
    f64 and cast once to ``dtype``, so it equals `repro`'s bit for bit."""
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    tab = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(tab).to(device=device, dtype=dtype)


# --------------------------------------------------------------------------
# activation
# --------------------------------------------------------------------------
def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SiLU(gate) * up: SiLU in f32, cast back, times up; under the mesh
    context's ``bf16_silu`` with a bf16 activation, `repro`'s chain in bf16
    (`repro_torch.kernels.swiglu`): F1 (``ops.swiglu``) outside autograd,
    its plain chain under it. An f32 activation takes the f32 path either
    way, where the two coincide."""
    ctx = get_ctx()
    if ctx is None or not ctx.bf16_silu or gate.dtype != torch.bfloat16:
        return torch.nn.functional.silu(gate.float()).to(gate.dtype) * up
    if ops.needs_grad(gate, up):
        return _swiglu.swiglu_bf16_plain(gate, up)
    return ops.swiglu(gate, up)


# --------------------------------------------------------------------------
# training: rematerialisation and the loss
# --------------------------------------------------------------------------
def maybe_remat(remat: bool, fn, *args):
    """``fn(*args)``; with ``remat`` and grad mode on, under
    `torch.utils.checkpoint` (non-reentrant), so the backward pass
    recomputes ``fn``'s activations instead of keeping them: `repro`'s
    ``jax.checkpoint`` around a block."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _ce_chunk(hc: torch.Tensor, emb: torch.Tensor, lc: torch.Tensor, logit_scale: float):
    """(sum of the chunk's unmasked NLLs f32, count of its unmasked labels)."""
    logits = (hc @ emb.T).float() * logit_scale                  # [B, c, V]
    mask = lc >= 0
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, torch.clamp(lc, min=0).long()[..., None])[..., 0]
    nll = torch.where(mask, lse - tgt, 0.0)
    return nll.sum(), mask.sum()


def chunked_cross_entropy(h: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor, *,
                          chunk: int = 256, logit_scale: float = 1.0) -> torch.Tensor:
    """Mean next-token CE without materializing [B, S, V] logits.

    h [B, S, d]; emb [V, d]; labels [B, S] int (-100 = masked). Walks
    sequence chunks (halved until the chunk divides S, as a VLM's S
    needs); each chunk's logits are ``h_chunk @ emb.T`` in the compute
    dtype, then cast to f32 and scaled by ``logit_scale``, `repro`'s
    rounding. Under grad each chunk is recomputed in backward, so no
    [B, chunk, V] f32 tensor stays alive per chunk. The count of unmasked
    labels is an integer; the loss is ``total / max(count, 1)``. `repro`'s
    one-hot contraction for the target logit (there for a vocab-sharded
    logits chunk) is a gather here: the same value.
    """
    b, s, _ = h.shape
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int64, device=h.device)
    for c0 in range(0, s, chunk):
        nll, n = maybe_remat(True, _ce_chunk, h[:, c0:c0 + chunk], emb,
                             labels[:, c0:c0 + chunk], logit_scale)
        tot = tot + nll
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1)
