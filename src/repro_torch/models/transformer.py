"""Decoder-only LM assembly: the dense family.

The counterpart of `repro.models.transformer` for ``family="dense"``:
blocks are `nn.Module`s in an `nn.ModuleList` walked by a Python loop (the
counterpart of `repro`'s ``lax.scan`` over a stacked ``[L, ...]`` layer
axis; `repro_torch.models.convert` splits that axis). Not ported yet, each
raising `NotImplementedError`: MoE FFNs and MLA attention (with the
``first_dense`` stack they imply), the VLM frontend and the parallel
attention/MLP block (ROADMAP queue 1 item 13). `repro`'s
``maybe_gather_hidden`` / ``maybe_shard_hidden`` are the identity on one
device and have no counterpart.

Paths:
  decoder_hidden       tokens -> final hidden (the teacher-forced pass)
  decoder_prefill      tokens -> (last-position logits, decode cache)
  decoder_decode_step  one token against the cache
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.common import Embed, Norm, apply_norm, embed_init, norm_init
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import MLP, apply_mlp, init_mlp


def check_ported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config this module cannot run."""
    unported = [(cfg.family != "dense", f"family={cfg.family!r}"),
                (cfg.moe, "moe=True"),
                (cfg.attn_kind == "mla", "attn_kind='mla'"),
                (cfg.parallel_block, "parallel_block=True")]
    for bad, what in unported:
        if bad:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported yet; it comes with ROADMAP "
                "queue 1 item 13")


def attn_spec(cfg: ModelConfig) -> attn.AttnSpec:
    return attn.AttnSpec(
        d_model=cfg.d_model, n_q=cfg.n_heads, n_kv=cfg.n_kv,
        d_head=cfg.head_dim, causal=True, window=cfg.window,
        rope_frac=cfg.rope_frac, rope_theta=cfg.rope_theta,
        qkv_bias=cfg.qkv_bias)


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------
class Block(nn.Module):
    """Pre-norm block: ``h + attn(ln1(h))``, then ``+ mlp(ln2(.))``."""

    def __init__(self, ln1: Norm, attn_: attn.Attention, ln2: Norm, mlp: MLP):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn_, ln2, mlp


def _init_block(cfg: ModelConfig, gen: torch.Generator) -> Block:
    dev = gen.device
    return Block(
        norm_init(cfg.d_model, cfg.pdt, dev, kind=cfg.norm, bias=cfg.norm_bias),
        attn.init_attention(gen, attn_spec(cfg), cfg.pdt),
        norm_init(cfg.d_model, cfg.pdt, dev, kind=cfg.norm, bias=cfg.norm_bias),
        init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.pdt, kind=cfg.mlp_kind))


def _norm(cfg: ModelConfig, p: Norm, x: torch.Tensor) -> torch.Tensor:
    return apply_norm(p, x, kind=cfg.norm, eps=cfg.norm_eps)


def _apply_block(cfg: ModelConfig, p: Block, h, positions, *, return_kv=False):
    out = attn.apply_attention(p.attn, attn_spec(cfg), _norm(cfg, p.ln1, h),
                               positions, return_kv=return_kv)
    attn_out, kv = out if return_kv else (out, None)
    h = h + attn_out
    h = h + apply_mlp(p.mlp, _norm(cfg, p.ln2, h), kind=cfg.mlp_kind)
    return (h, kv) if return_kv else h


def _decode_block(cfg: ModelConfig, p: Block, h1, cache_k, cache_v, pos):
    """One-token decode through a block; the cache is this layer's slice,
    written in place."""
    attn_out, _, _ = attn.decode_self_attention(
        p.attn, attn_spec(cfg), _norm(cfg, p.ln1, h1), cache_k, cache_v, pos)
    h1 = h1 + attn_out
    return h1 + apply_mlp(p.mlp, _norm(cfg, p.ln2, h1), kind=cfg.mlp_kind)


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------
class Decoder(nn.Module):
    """Token embedding, the block stack, the final norm and (unless tied)
    the output embedding."""

    def __init__(self, embed: Embed, blocks: list[Block], ln_f: Norm,
                 unembed: Embed | None):
        super().__init__()
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)
        self.ln_f = ln_f
        self.unembed = unembed


def init_decoder(cfg: ModelConfig, gen: torch.Generator) -> Decoder:
    """Random parameters on the generator's device, drawn in a fixed order."""
    check_ported(cfg)
    embed = embed_init(gen, cfg.vocab, cfg.d_model, cfg.pdt)
    ln_f = norm_init(cfg.d_model, cfg.pdt, gen.device, kind=cfg.norm,
                     bias=cfg.norm_bias)
    blocks = [_init_block(cfg, gen) for _ in range(cfg.n_layers)]
    unembed = None if cfg.tie_embeddings else embed_init(gen, cfg.vocab, cfg.d_model, cfg.pdt)
    return Decoder(embed, blocks, ln_f, unembed)


def _out_emb(cfg: ModelConfig, model: Decoder) -> torch.Tensor:
    return (model.embed if cfg.tie_embeddings else model.unembed).emb


def _embed_tokens(cfg: ModelConfig, model: Decoder, tokens) -> torch.Tensor:
    return model.embed.emb[tokens.long()].to(cfg.cdt)


def _logits(cfg: ModelConfig, model: Decoder, h: torch.Tensor) -> torch.Tensor:
    return (h @ _out_emb(cfg, model).T).float() * cfg.logit_scale


def decoder_hidden(model: Decoder, cfg: ModelConfig, tokens) -> torch.Tensor:
    """tokens [B,S] -> final hidden [B, S, d]."""
    h = _embed_tokens(cfg, model, tokens)
    positions = torch.arange(h.shape[1], device=h.device)
    for blk in model.blocks:
        h = _apply_block(cfg, blk, h, positions)
    return _norm(cfg, model.ln_f, h)


# --------------------------------------------------------------------------
# serving: cache init / prefill / decode
# --------------------------------------------------------------------------
def decoder_init_cache(cfg: ModelConfig, batch: int, s_max: int, device) -> dict:
    """``{"main": (k, v), "pos": [B] int32}`` with k, v
    [L, B, Hkv, S, D] in the compute dtype (S = the window for a
    sliding-window config shorter than ``s_max``: a ring buffer)."""
    check_ported(cfg)
    w = cfg.window if cfg.window and cfg.window < s_max else s_max
    shape = (cfg.n_layers, batch, cfg.n_kv, w, cfg.head_dim)
    return {"main": (torch.zeros(shape, dtype=cfg.cdt, device=device),
                     torch.zeros(shape, dtype=cfg.cdt, device=device)),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _write_prefill(cfg: ModelConfig, cache_pair, layer: int, kv, s: int) -> None:
    """Write one layer's prefill k, v [B, Hkv, s, D] into the cache at
    positions [0, s), in place (a ring buffer keeps the last slots)."""
    ck, cv = cache_pair
    k, v = kv
    s_max = ck.shape[3]
    if s_max < s:
        sl = torch.arange(s - s_max, s, device=ck.device) % s_max
        ck[layer, :, :, sl] = k[:, :, -s_max:]
        cv[layer, :, :, sl] = v[:, :, -s_max:]
    else:
        ck[layer, :, :, :s] = k
        cv[layer, :, :, :s] = v


def decoder_prefill(model: Decoder, cfg: ModelConfig, tokens, cache: dict):
    """Run the prompt, fill the cache in place, return (last-position logits
    [B, V] f32, cache)."""
    h = _embed_tokens(cfg, model, tokens)
    s_tot = h.shape[1]
    positions = torch.arange(s_tot, device=h.device)
    for i, blk in enumerate(model.blocks):
        h, kv = _apply_block(cfg, blk, h, positions, return_kv=True)
        _write_prefill(cfg, cache["main"], i, kv, s_tot)
    cache["pos"] = torch.full((tokens.shape[0],), s_tot, dtype=torch.int32,
                              device=h.device)
    h = _norm(cfg, model.ln_f, h)
    return _logits(cfg, model, h[:, -1]), cache


def decoder_decode_step(model: Decoder, cfg: ModelConfig, cache: dict, token):
    """token [B] int32 -> (logits [B, V] f32, cache), at position
    ``cache["pos"]``; the cache is written in place."""
    pos = cache["pos"]
    h = _embed_tokens(cfg, model, token[:, None])
    ck, cv = cache["main"]
    for i, blk in enumerate(model.blocks):
        h = _decode_block(cfg, blk, h, ck[i], cv[i], pos)
    cache["pos"] = pos + 1
    h = _norm(cfg, model.ln_f, h)
    return _logits(cfg, model, h[:, 0]), cache
