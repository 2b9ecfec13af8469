"""Whisper-style encoder-decoder (arXiv:2212.04356), backbone only.

The counterpart of `repro.models.whisper` for ``family="encdec"``. The
conv/mel frontend is a stub, as in `repro`: the caller passes precomputed
frame embeddings [B, enc_seq, d] (``batch["frontend"]``). Encoder:
sinusoidal positions, then pre-norm blocks of bidirectional MHA and a GELU
MLP, all with biases. Decoder: learned positions ``dec_pos``, then
pre-norm blocks of causal self-attention, cross-attention to the encoder
memory and a GELU MLP. The logits use the tied token embedding, unscaled.

Every attention runs through `repro_torch.models.attention`: the encoder's
and the cross prefill through `attend(causal=False)` (K4 on the card), the
decoder's self-attention prefill through K4 causal, its decode through
`decode_self_attention` (K5) and the cross decode through
`decode_cross_attention` (K5 with kv_len = enc_seq).

Kept from `repro` for parity: the k projections' bias (Whisper's own has
none) and the ``max_pos`` (36,864) rows of ``dec_pos`` (Whisper's text
context is 448).

Training (`whisper_loss`): the encoder over the stub frames, then the
decoder teacher-forced, each block of both rematerialised in backward
where ``cfg.remat``, and the mean next-token CE over the tied embedding.

Parameters: ``embed``, ``dec_pos``, ``enc_blocks`` (``ln1``, ``attn``,
``ln2``, ``mlp``), ``enc_ln``, ``dec_blocks`` (``ln1``, ``self``, ``ln2``,
``cross``, ``ln3``, ``mlp``) and ``dec_ln``: `repro`'s tree with its
stacked layer axes split (`repro_torch.models.convert`).

Serving cache, in `repro`'s keys and shapes:
  self   (k, v) [L, B, H, S, D], the decoder's self-attention
  cross  (k, v) [L, B, H, enc_seq, D], projected once from the encoder
         memory at prefill
  pos    [B] int32
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.common import (Embed, Norm, _normal, _param, apply_norm,
                                       chunked_cross_entropy, dense, embed_init, maybe_remat,
                                       norm_init, sinusoid_pos)
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import MLP, apply_mlp, init_mlp


def enc_spec(cfg: ModelConfig) -> attn.AttnSpec:
    return attn.AttnSpec(d_model=cfg.d_model, n_q=cfg.n_heads, n_kv=cfg.n_kv,
                         d_head=cfg.head_dim, causal=False, rope_frac=0.0,
                         qkv_bias=True, o_bias=True)


def dec_spec(cfg: ModelConfig) -> attn.AttnSpec:
    return attn.AttnSpec(d_model=cfg.d_model, n_q=cfg.n_heads, n_kv=cfg.n_kv,
                         d_head=cfg.head_dim, causal=True, rope_frac=0.0,
                         qkv_bias=True, o_bias=True)


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------
class EncBlock(nn.Module):
    """``h + attn(ln1(h))``, then ``+ mlp(ln2(.))``."""

    def __init__(self, ln1: Norm, attn_: attn.Attention, ln2: Norm, mlp: MLP):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn_, ln2, mlp


class DecBlock(nn.Module):
    """``h + self(ln1(h))``, ``+ cross(ln2(.), memory)``, ``+ mlp(ln3(.))``;
    the self-attention sits at ``self`` (`repro`'s key)."""

    def __init__(self, ln1: Norm, self_attn: attn.Attention, ln2: Norm,
                 cross: attn.Attention, ln3: Norm, mlp: MLP):
        super().__init__()
        self.ln1, self.ln2, self.cross, self.ln3, self.mlp = ln1, ln2, cross, ln3, mlp
        self.add_module("self", self_attn)


class Whisper(nn.Module):
    def __init__(self, embed: Embed, dec_pos: torch.Tensor, enc_blocks: list[EncBlock],
                 enc_ln: Norm, dec_blocks: list[DecBlock], dec_ln: Norm):
        super().__init__()
        self.embed = embed
        self.dec_pos = _param(dec_pos)
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.enc_ln = enc_ln
        self.dec_blocks = nn.ModuleList(dec_blocks)
        self.dec_ln = dec_ln


def _ln(cfg: ModelConfig, dev) -> Norm:
    return norm_init(cfg.d_model, cfg.pdt, dev, kind="layer", bias=True)


def _mlp(cfg: ModelConfig, gen: torch.Generator) -> MLP:
    return init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.pdt, kind="gelu", bias=True)


def init_whisper(cfg: ModelConfig, gen: torch.Generator) -> Whisper:
    """Random parameters on the generator's device, drawn in a fixed order
    (`repro`'s distributions, not its keys)."""
    dev = gen.device
    embed = embed_init(gen, cfg.vocab, cfg.d_model, cfg.pdt)
    dec_pos = _normal(gen, (cfg.max_pos, cfg.d_model), 0.01, cfg.pdt)
    enc_blocks = [EncBlock(_ln(cfg, dev), attn.init_attention(gen, enc_spec(cfg), cfg.pdt),
                           _ln(cfg, dev), _mlp(cfg, gen)) for _ in range(cfg.n_enc_layers)]
    dec_blocks = [DecBlock(_ln(cfg, dev), attn.init_attention(gen, dec_spec(cfg), cfg.pdt),
                           _ln(cfg, dev), attn.init_attention(gen, enc_spec(cfg), cfg.pdt),
                           _ln(cfg, dev), _mlp(cfg, gen)) for _ in range(cfg.n_layers)]
    return Whisper(embed, dec_pos, enc_blocks, _ln(cfg, dev), dec_blocks, _ln(cfg, dev))


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def _norm(cfg: ModelConfig, p: Norm, x: torch.Tensor) -> torch.Tensor:
    return apply_norm(p, x, kind="layer", eps=cfg.norm_eps)


def encode(model: Whisper, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames [B, enc_seq, d] (stub embeddings) -> memory [B, enc_seq, d]."""
    h = frames.to(cfg.cdt) + sinusoid_pos(frames.shape[1], cfg.d_model, cfg.cdt, frames.device)
    positions = torch.arange(h.shape[1], device=h.device)

    def block(x, blk):
        x = x + attn.apply_attention(blk.attn, enc_spec(cfg), _norm(cfg, blk.ln1, x), positions)
        return x + apply_mlp(blk.mlp, _norm(cfg, blk.ln2, x), kind="gelu")

    for blk in model.enc_blocks:
        h = maybe_remat(cfg.remat, lambda x, blk=blk: block(x, blk), h)
    return _norm(cfg, model.enc_ln, h)


def _embed_dec(cfg: ModelConfig, model: Whisper, tokens, positions) -> torch.Tensor:
    """Token embeddings plus the learned positions, in the compute dtype."""
    return (model.embed.emb[tokens.long()].to(cfg.cdt)
            + model.dec_pos[positions.long()].to(cfg.cdt))


def _logits(cfg: ModelConfig, model: Whisper, h: torch.Tensor) -> torch.Tensor:
    return (h @ model.embed.emb.T).float()


def whisper_hidden(model: Whisper, cfg: ModelConfig, tokens, frames) -> torch.Tensor:
    """tokens [B, S] and frames -> the decoder's final hidden [B, S, d]
    (the teacher-forced pass)."""
    memory = encode(model, cfg, frames)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    h = _embed_dec(cfg, model, tokens, positions)

    def block(x, mem, blk):
        x = x + attn.apply_attention(blk.self, dec_spec(cfg), _norm(cfg, blk.ln1, x), positions)
        x = x + attn.apply_cross_attention(blk.cross, enc_spec(cfg), _norm(cfg, blk.ln2, x),
                                           mem)
        return x + apply_mlp(blk.mlp, _norm(cfg, blk.ln3, x), kind="gelu")

    for blk in model.dec_blocks:
        h = maybe_remat(cfg.remat, lambda x, mem, blk=blk: block(x, mem, blk), h, memory)
    return _norm(cfg, model.dec_ln, h)


def whisper_loss(model: Whisper, cfg: ModelConfig, batch: dict):
    """batch: tokens [B,S], labels [B,S] (-100 masked), frontend [B,
    enc_seq, d] -> (loss, {"loss": loss})."""
    h = whisper_hidden(model, cfg, batch["tokens"], batch["frontend"])
    loss = chunked_cross_entropy(h, model.embed.emb, batch["labels"], chunk=cfg.logits_chunk)
    return loss, {"loss": loss}


# --------------------------------------------------------------------------
# serving: cache init / prefill / decode
# --------------------------------------------------------------------------
def whisper_init_cache(cfg: ModelConfig, batch: int, s_max: int, device) -> dict:
    """``{"self": (k, v), "cross": (k, v), "pos"}``: a self cache of
    ``s_max`` rows and a cross cache of ``enc_seq`` rows a layer, in the
    compute dtype."""
    def pair(rows):
        return tuple(torch.zeros((cfg.n_layers, batch, cfg.n_kv, rows, cfg.head_dim),
                                 dtype=cfg.cdt, device=device) for _ in range(2))

    return {"self": pair(s_max), "cross": pair(cfg.enc_seq),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def whisper_prefill(model: Whisper, cfg: ModelConfig, tokens, cache: dict, frames):
    """Encode the frames, run the decoder prompt, fill the self cache at
    positions [0, S) and the cross cache (the encoder memory's k and v
    projections, once), in place. Returns (last-position logits [B, V] f32,
    cache)."""
    if frames.shape[1] != cfg.enc_seq:
        raise ValueError(f"{cfg.name}: frames hold {frames.shape[1]} rows, the cross cache "
                         f"{cfg.enc_seq}")
    memory = encode(model, cfg, frames)
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)
    h = _embed_dec(cfg, model, tokens, positions)
    dspec, espec = dec_spec(cfg), enc_spec(cfg)
    (sk, sv), (ck, cv) = cache["self"], cache["cross"]
    for i, blk in enumerate(model.dec_blocks):
        y, (k, v) = attn.apply_attention(blk.self, dspec, _norm(cfg, blk.ln1, h),
                                         positions, return_kv=True)
        sk[i, :, :, :s] = k
        sv[i, :, :, :s] = v
        h = h + y
        ck[i] = attn._split_heads(dense(blk.cross.wk, memory), espec.n_kv, espec.d_head)
        cv[i] = attn._split_heads(dense(blk.cross.wv, memory), espec.n_kv, espec.d_head)
        h = h + attn.apply_cross_attention(blk.cross, espec, _norm(cfg, blk.ln2, h),
                                           (ck[i], cv[i]), from_cache=True)
        h = h + apply_mlp(blk.mlp, _norm(cfg, blk.ln3, h), kind="gelu")
    cache["pos"] = torch.full((tokens.shape[0],), s, dtype=torch.int32, device=h.device)
    h = _norm(cfg, model.dec_ln, h)
    return _logits(cfg, model, h[:, -1]), cache


def whisper_decode_step(model: Whisper, cfg: ModelConfig, cache: dict, token):
    """token [B] int32 -> (logits [B, V] f32, cache), at position
    ``cache["pos"]``; the self cache is written in place."""
    pos = cache["pos"]
    h = _embed_dec(cfg, model, token[:, None], pos[:, None])
    dspec, espec = dec_spec(cfg), enc_spec(cfg)
    (sk, sv), (ck, cv) = cache["self"], cache["cross"]
    for i, blk in enumerate(model.dec_blocks):
        y, _, _ = attn.decode_self_attention(blk.self, dspec,
                                             _norm(cfg, blk.ln1, h), sk[i], sv[i], pos)
        h = h + y
        h = h + attn.decode_cross_attention(blk.cross, espec, _norm(cfg, blk.ln2, h),
                                            ck[i], cv[i])
        h = h + apply_mlp(blk.mlp, _norm(cfg, blk.ln3, h), kind="gelu")
    cache["pos"] = pos + 1
    h = _norm(cfg, model.dec_ln, h)
    return _logits(cfg, model, h[:, 0]), cache
