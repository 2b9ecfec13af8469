"""GQA / MHA / sliding-window and cross attention: prefill and decode paths.

The counterpart of `repro.models.attention`, in the same [B, H, S, D]
layout. Routing is by device and by autograd, not by an ``impl`` knob:

  `attend`                  under autograd (grad mode on and an input
                            requiring grad, `ops.needs_grad`) ->
                            `flash_attention_chunked` on either device, the
                            counterpart of `repro`'s training
                            ``impl="xla"``: K4 has no backward. Else CPU ->
                            `flash_attention_plain`, CUDA -> K4
                            (`repro_torch.kernels.ops.flash_attention`);
                            self-attention and `apply_cross_attention`
  `decode_self_attention`   CPU -> `decode_attention_plain`, CUDA -> K5, for
                            a full cache and for a ring-buffer
                            (sliding-window) cache alike
  `decode_cross_attention`  the same, against a full cross cache

`naive_attention` and `flash_attention_chunked` are the plain counterparts
of `repro`'s ``impl="naive"`` and ``impl="xla"`` paths. Nothing on the
serving path calls them; the training route runs the second.

Decode keeps keys post-RoPE in a [B, Hkv, S, D] cache (or a [B, Hkv, W, D]
ring buffer) and writes the new token's k and v into it in place. A ring's
valid slots are its first min(pos + 1, W) (all W once it has wrapped), and
their order does not matter under the softmax, so its decode is K5's
function with kv_len = min(pos + 1, W): `repro`'s ring decode
(``_ring_decode_xla``), which `repro` keeps in XLA only because its Pallas
decode branch skips rings.

Cross-attention (Whisper's decoder) has no RoPE and no mask. Its prefill
runs `attend(..., causal=False)`. Its decode is one query a row against
the whole [B, Hkv, enc_seq, D] cross cache: K5's function with
kv_len = enc_seq for every row, the same function `repro` computes with
``attend(causal=False)`` at Sq = 1 (`repro/models/whisper.py:185-186`).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import position_mask
from repro_torch.models.common import apply_rope, dense, dense_init

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_q: int
    n_kv: int
    d_head: int
    causal: bool = True
    window: int | None = None          # sliding-window size (None = full)
    rope_frac: float = 1.0             # fraction of d_head rotated
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    o_bias: bool = False

    @property
    def d_rot(self) -> int:
        r = int(self.d_head * self.rope_frac)
        return r - (r % 2)


class Attention(nn.Module):
    """The ``wq``, ``wk``, ``wv``, ``wo`` projections of one layer."""

    def __init__(self, wq: nn.Module, wk: nn.Module, wv: nn.Module, wo: nn.Module):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


def init_attention(gen: torch.Generator, spec: AttnSpec, dtype) -> Attention:
    return Attention(
        dense_init(gen, spec.d_model, spec.n_q * spec.d_head, dtype, bias=spec.qkv_bias),
        dense_init(gen, spec.d_model, spec.n_kv * spec.d_head, dtype, bias=spec.qkv_bias),
        dense_init(gen, spec.d_model, spec.n_kv * spec.d_head, dtype, bias=spec.qkv_bias),
        dense_init(gen, spec.n_q * spec.d_head, spec.d_model, dtype, bias=spec.o_bias))


# --------------------------------------------------------------------------
# inner attention ([B, H, S, D] layout)
# --------------------------------------------------------------------------
def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B,Hq,Sq,D] x k [B,Hkv,Sk,D] -> [B,Hkv,G,Sq,Sk] f32, no repeat."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, sq, d)
    return torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float())


def naive_attention(q, k, v, *, causal=True, window=None, q_offset=None):
    """O(S^2)-memory masked softmax (``impl="naive"``). A row with no valid
    key averages v, as `repro`'s does."""
    b, hq, sq, d = q.shape
    sk = k.shape[2]
    if q_offset is None:
        q_offset = sk - sq
    s = _grouped_scores(q, k) * (1.0 / (d ** 0.5))
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(sk, device=q.device)[None, :]
    s = torch.where(position_mask(q_pos, k_pos, causal=causal, window=window), s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)


def flash_attention_chunked(q, k, v, *, causal=True, window=None,
                            block_q=512, block_k=1024, q_offset=None):
    """Online softmax over [block_q, block_k] tiles (``impl="xla"``); ragged
    lengths are masked, and a row with no valid key gives 0."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = 1.0 / (d ** 0.5)
    if q_offset is None:
        q_offset = sk - sq
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    qg = q.float().reshape(b, hkv, hq // hkv, sq, d)
    kf, vf = k.float(), v.float()
    out = torch.empty_like(qg)
    for q0 in range(0, sq, block_q):
        qb = qg[:, :, :, q0:q0 + block_q]
        q_pos = torch.arange(q0, q0 + qb.shape[3], device=q.device)[:, None] + q_offset
        m = torch.full(qb.shape[:-1] + (1,), _NEG, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        for k0 in range(0, sk, block_k):
            kc, vc = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
            k_pos = torch.arange(k0, k0 + kc.shape[2], device=q.device)[None, :]
            mask = position_mask(q_pos, k_pos, causal=causal, window=window)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kc) * scale
            s = torch.where(mask, s, _NEG)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(mask, torch.exp(s - m_new), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + torch.einsum("bhgqk,bhkd->bhgqd", p, vc)
            m = m_new
        out[:, :, :, q0:q0 + block_q] = acc / torch.where(l > 0, l, 1.0)
    return out.reshape(b, hq, sq, d).to(q.dtype)


def attend(q, k, v, *, causal=True, window=None):
    """[B,Hq,Sq,D] attention of right-aligned queries: under autograd the
    differentiable `flash_attention_chunked`, else K4 on a CUDA tensor and
    its plain version on a CPU tensor."""
    if ops.needs_grad(q, k, v):
        return flash_attention_chunked(q, k, v, causal=causal, window=window)
    return ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, window=window)


# --------------------------------------------------------------------------
# module-level apply: projections + rope + attention
# --------------------------------------------------------------------------
def _split_heads(x: torch.Tensor, n: int, d_head: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, d_head).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def apply_attention(p: Attention, spec: AttnSpec, x, positions, *,
                    return_kv=False):
    """Self-attention over x [B, S, d]; positions [S] (or [B, S])."""
    q = _split_heads(dense(p.wq, x), spec.n_q, spec.d_head)
    k = _split_heads(dense(p.wk, x), spec.n_kv, spec.d_head)
    v = _split_heads(dense(p.wv, x), spec.n_kv, spec.d_head)
    if spec.d_rot > 0:
        pos_b = positions if positions.dim() == 2 else positions[None]
        q = apply_rope(q, pos_b[:, None, :], d_rot=spec.d_rot, theta=spec.rope_theta)
        k = apply_rope(k, pos_b[:, None, :], d_rot=spec.d_rot, theta=spec.rope_theta)
    o = attend(q, k, v, causal=spec.causal, window=spec.window)
    y = dense(p.wo, _merge_heads(o))
    if return_kv:
        return y, (k, v)
    return y


def apply_cross_attention(p: Attention, spec: AttnSpec, x, kv_or_mem, *,
                          from_cache=False):
    """Cross-attention: queries from x [B, S, d], keys and values from the
    encoder memory [B, Sm, d] (or a precomputed (k, v) [B, Hkv, Sm, D]
    pair). No RoPE, no mask."""
    q = _split_heads(dense(p.wq, x), spec.n_q, spec.d_head)
    if from_cache:
        k, v = kv_or_mem
    else:
        k = _split_heads(dense(p.wk, kv_or_mem), spec.n_kv, spec.d_head)
        v = _split_heads(dense(p.wv, kv_or_mem), spec.n_kv, spec.d_head)
    o = attend(q, k, v, causal=False)
    return dense(p.wo, _merge_heads(o))


def decode_cross_attention(p: Attention, spec: AttnSpec, x1, cache_k, cache_v):
    """One-token cross-attention: x1 [B, 1, d] against every row of the
    cross cache [B, Hkv, Sm, D] (K5 with kv_len = Sm). Returns y [B, 1, d]."""
    q = _split_heads(dense(p.wq, x1), spec.n_q, spec.d_head)    # [B,Hq,1,D]
    kv_len = torch.full((x1.shape[0],), cache_k.shape[2], dtype=torch.int32,
                        device=x1.device)
    o = ops.decode_attention(q[:, :, 0].contiguous(), cache_k, cache_v, kv_len)
    return dense(p.wo, _merge_heads(o[:, :, None, :]))


def decode_self_attention(p: Attention, spec: AttnSpec, x1, cache_k, cache_v, pos):
    """One-token decode. x1 [B, 1, d]; cache [B, Hkv, S(|W), D]; pos [B] int32.

    Writes the token's post-RoPE k and v into the caches in place and
    returns (y [B, 1, d], cache_k, cache_v). For sliding-window specs the
    cache is a ring buffer of width W = spec.window.
    """
    b = x1.shape[0]
    s_max = cache_k.shape[2]
    q = _split_heads(dense(p.wq, x1), spec.n_q, spec.d_head)    # [B,Hq,1,D]
    k = _split_heads(dense(p.wk, x1), spec.n_kv, spec.d_head)   # [B,Hkv,1,D]
    v = _split_heads(dense(p.wv, x1), spec.n_kv, spec.d_head)
    if spec.d_rot > 0:
        q = apply_rope(q, pos[:, None, None], d_rot=spec.d_rot, theta=spec.rope_theta)
        k = apply_rope(k, pos[:, None, None], d_rot=spec.d_rot, theta=spec.rope_theta)

    ring = spec.window is not None and s_max == spec.window
    slot = pos % s_max if ring else torch.clamp(pos, max=s_max - 1)
    bi = torch.arange(b, device=x1.device)
    cache_k[bi, :, slot] = k[:, :, 0]
    cache_v[bi, :, slot] = v[:, :, 0]

    kv_len = torch.clamp(pos + 1, max=s_max) if ring else pos + 1
    o = ops.decode_attention(q[:, :, 0].contiguous(), cache_k, cache_v,
                             kv_len.to(torch.int32))               # [B, Hq, D]
    y = dense(p.wo, _merge_heads(o[:, :, None, :]))
    return y, cache_k, cache_v
