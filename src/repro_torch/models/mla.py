"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

The counterpart of `repro.models.mla`. K/V are generated from a shared
low-rank latent ``c_kv`` (kv_lora_rank = 512) plus a single per-token RoPE
key shared across heads; only ``[c_kv | k_rope]`` (512 + 64 per token) is
cached at decode time.

  `apply_mla`   prefill: per-head K/V materialised from the latent, v padded
                to the query/key width ``d_qk`` so that the attention kernel
                sees square tiles, then `attention.attend` (K4 on a CUDA
                tensor, its plain version on a CPU tensor), sliced back to
                ``d_v``; returns the ``(c_kv, k_pe)`` cache pair
  `decode_mla`  the weight-absorbed one-token decode: W_UK folded into the
                query, scores taken against the latent cache in f32, the
                context expanded through W_UV once. Plain PyTorch on both
                devices, as `repro`'s is plain einsums: no kernel is
                launched. The token's cache entries are written in place.

`repro`'s ``impl`` / ``block_q`` / ``block_k`` knobs are gone: the port
routes attention by device.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.attention import attend
from repro_torch.models.common import Dense, Norm, apply_norm, apply_rope, dense, dense_init, norm_init

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class MLASpec:
    d_model: int
    n_heads: int
    q_lora_rank: int = 0        # 0 = direct q projection (V2-Lite)
    kv_lora_rank: int = 512
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128
    rope_theta: float = 10000.0

    @property
    def d_qk(self) -> int:
        return self.d_nope + self.d_rope


class MLA(nn.Module):
    """``wq`` (or the q LoRA ``wq_a``, ``q_norm``, ``wq_b``), ``wkv_a``,
    ``kv_norm``, ``wk_b``, ``wv_b`` and ``wo`` of one layer."""

    def __init__(self, wkv_a: Dense, kv_norm: Norm, wk_b: Dense, wv_b: Dense, wo: Dense, *,
                 wq: Dense | None = None, wq_a: Dense | None = None,
                 q_norm: Norm | None = None, wq_b: Dense | None = None):
        super().__init__()
        if (wq is None) == (wq_a is None or q_norm is None or wq_b is None):
            raise ValueError("MLA takes either wq or all of wq_a, q_norm and wq_b")
        self.wq, self.wq_a, self.q_norm, self.wq_b = wq, wq_a, q_norm, wq_b
        self.wkv_a, self.kv_norm, self.wk_b, self.wv_b, self.wo = wkv_a, kv_norm, wk_b, wv_b, wo


def init_mla(gen: torch.Generator, spec: MLASpec, dtype) -> MLA:
    h, dq, dev = spec.n_heads, spec.d_qk, gen.device
    q = {}
    if spec.q_lora_rank:
        q["wq_a"] = dense_init(gen, spec.d_model, spec.q_lora_rank, dtype)
        q["q_norm"] = norm_init(spec.q_lora_rank, dtype, dev)
        q["wq_b"] = dense_init(gen, spec.q_lora_rank, h * dq, dtype)
    else:
        q["wq"] = dense_init(gen, spec.d_model, h * dq, dtype)
    return MLA(dense_init(gen, spec.d_model, spec.kv_lora_rank + spec.d_rope, dtype),
               norm_init(spec.kv_lora_rank, dtype, dev),
               dense_init(gen, spec.kv_lora_rank, h * spec.d_nope, dtype),
               dense_init(gen, spec.kv_lora_rank, h * spec.d_v, dtype),
               dense_init(gen, h * spec.d_v, spec.d_model, dtype), **q)


def _rope_positions(positions: torch.Tensor) -> torch.Tensor:
    """[S] or [B, S] positions -> [B|1, 1, S], broadcasting over heads."""
    pos_b = positions if positions.dim() == 2 else positions[None]
    return pos_b[:, None, :]


def _q_proj(p: MLA, spec: MLASpec, x, positions):
    b, s, _ = x.shape
    if spec.q_lora_rank:
        q = dense(p.wq_b, apply_norm(p.q_norm, dense(p.wq_a, x)))
    else:
        q = dense(p.wq, x)
    q = q.reshape(b, s, spec.n_heads, spec.d_qk).transpose(1, 2)
    q_nope, q_pe = q[..., :spec.d_nope], q[..., spec.d_nope:]
    q_pe = apply_rope(q_pe, _rope_positions(positions), theta=spec.rope_theta)
    return q_nope, q_pe


def _latent(p: MLA, spec: MLASpec, x, positions):
    """x -> (c_kv [B,S,R] normed, k_pe [B,1,S,dr] rope'd) — the cache pair."""
    kv_a = dense(p.wkv_a, x)
    c_kv = apply_norm(p.kv_norm, kv_a[..., :spec.kv_lora_rank])
    k_pe = kv_a[..., spec.kv_lora_rank:][:, None]                 # [B,1,S,dr]
    k_pe = apply_rope(k_pe, _rope_positions(positions), theta=spec.rope_theta)
    return c_kv, k_pe


def apply_mla(p: MLA, spec: MLASpec, x, positions, *, return_cache=False):
    """Prefill over x [B, S, d]: per-head K/V materialised from the latent,
    causal attention through `attend` at head width ``d_qk``."""
    b, s, _ = x.shape
    h = spec.n_heads
    q_nope, q_pe = _q_proj(p, spec, x, positions)
    c_kv, k_pe = _latent(p, spec, x, positions)

    k_nope = dense(p.wk_b, c_kv).reshape(b, s, h, spec.d_nope).transpose(1, 2)
    v = dense(p.wv_b, c_kv).reshape(b, s, h, spec.d_v).transpose(1, 2)
    q = torch.cat([q_nope, q_pe], -1)
    k = torch.cat([k_nope, k_pe.expand(b, h, s, spec.d_rope)], -1)
    # pad v to d_qk so the attention kernel sees square tiles, slice after
    o = attend(q, k, F.pad(v, (0, spec.d_qk - spec.d_v)), causal=True)[..., :spec.d_v]
    y = dense(p.wo, o.transpose(1, 2).reshape(b, s, h * spec.d_v))
    if return_cache:
        return y, (c_kv, k_pe[:, 0])
    return y


def decode_mla(p: MLA, spec: MLASpec, x1, cache_c, cache_pe, pos):
    """Absorbed one-token decode.

    x1 [B,1,d]; cache_c [B,S,R]; cache_pe [B,S,dr]; pos [B] int32. Writes
    the token's cache entries in place (at ``min(pos, S - 1)``, as the GQA
    decode does) and returns (y [B,1,d], cache_c, cache_pe).
    """
    b = x1.shape[0]
    s_max = cache_c.shape[1]
    h, r = spec.n_heads, spec.kv_lora_rank
    q_nope, q_pe = _q_proj(p, spec, x1, pos[:, None])          # [B,H,1,*]
    c_kv, k_pe = _latent(p, spec, x1, pos[:, None])            # [B,1,R], [B,1,1,dr]

    bi = torch.arange(b, device=x1.device)
    slot = torch.clamp(pos, max=s_max - 1).long()
    cache_c[bi, slot] = c_kv[:, 0]
    cache_pe[bi, slot] = k_pe[:, 0, 0]

    # absorb W_UK: q_lat[b,h,r] = sum_n q_nope[b,h,n] * W_UK[r,h,n]
    wk_b = p.wk_b.w.reshape(r, h, spec.d_nope)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, :, 0], wk_b)
    cc = cache_c.float()
    scores = (torch.einsum("bhr,bsr->bhs", q_lat.float(), cc)
              + torch.einsum("bhe,bse->bhs", q_pe[:, :, 0].float(), cache_pe.float()))
    scores = scores / (spec.d_qk ** 0.5)
    valid = torch.arange(s_max, device=x1.device)[None, :] < (pos + 1)[:, None]
    scores = torch.where(valid[:, None], scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    ctx_lat = torch.einsum("bhs,bsr->bhr", probs, cc)
    wv_b = p.wv_b.w.reshape(r, h, spec.d_v)
    o = torch.einsum("bhr,rhv->bhv", ctx_lat, wv_b.float())
    y = dense(p.wo, o.reshape(b, 1, h * spec.d_v).to(x1.dtype))
    return y, cache_c, cache_pe
