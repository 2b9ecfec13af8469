"""Decoder-only LM assembly: the dense, MoE and VLM families.

The counterpart of `repro.models.transformer` for ``family="dense"``,
``"moe"`` and ``"vlm"``: blocks are `nn.Module`s in an `nn.ModuleList`
walked by a Python loop (the counterpart of `repro`'s ``lax.scan`` over a
stacked ``[L, ...]`` layer axis; `repro_torch.models.convert` splits that
axis). A block's attention is GQA (`attention.Attention`) or DeepSeek-V2's
MLA (`mla.MLA`), its FFN an `MLP` or an `MoE`; ``cfg.first_dense`` leading
layers of an MoE config (DeepSeek-V2's dense layer 0) form a second stack,
``dense_blocks``, walked before ``blocks``. A sliding-window config keeps a
ring buffer of the window's width as its cache. A parallel block (Cohere's
``parallel_block``) feeds one ``ln1`` to attention and FFN alike, has no
``ln2``, and returns ``h + attn + ffn``. A VLM puts its stub patch
embeddings (``frontend`` [B, n_patches, d]) before the token embeddings;
positions count the patches, so the cache holds them and decode starts at
n_patches + P. The Mamba2 hybrid is `repro_torch.models.zamba`, the
encoder-decoder `repro_torch.models.whisper`. The teacher-forced block
calls `repro`'s sequence-parallel hooks where `repro` does
(``maybe_gather_hidden`` before attention and the FFN,
``maybe_shard_hidden`` on its output; `repro_torch.parallel.act_sharding`:
identities that only a dry run's count reads); the prefill block, which
shares its code, calls none, as `repro`'s ``_prefill_block``. Under a mesh
context an MoE block takes its expert-parallel path.

Paths:
  decoder_hidden       tokens -> final hidden (the teacher-forced pass;
                       each block rematerialised in backward where
                       ``cfg.remat``)
  decoder_loss         train: mean next-token CE over the hidden
                       (`chunked_cross_entropy`; a VLM's patch positions
                       take no loss, Cohere's ``logit_scale`` applies)
  decoder_prefill      tokens -> (last-position logits, decode cache)
  decoder_decode_step  one token against the cache
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models.common import (Embed, Norm, apply_norm, chunked_cross_entropy,
                                       embed_init, maybe_remat, norm_init)
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import MLP, apply_mlp, init_mlp
from repro_torch.models.moe import MoE, MoESpec, apply_moe, init_moe
from repro_torch.parallel.act_sharding import maybe_gather_hidden, maybe_shard_hidden


FAMILIES = ("dense", "moe", "vlm")


def check_family(cfg: ModelConfig) -> None:
    """Raise ValueError for a config of another family than this module's."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not a decoder family "
                         f"{FAMILIES}; `repro_torch.models.api` dispatches it")


def attn_spec(cfg: ModelConfig) -> attn.AttnSpec:
    return attn.AttnSpec(
        d_model=cfg.d_model, n_q=cfg.n_heads, n_kv=cfg.n_kv,
        d_head=cfg.head_dim, causal=True, window=cfg.window,
        rope_frac=cfg.rope_frac, rope_theta=cfg.rope_theta,
        qkv_bias=cfg.qkv_bias)


def mla_spec(cfg: ModelConfig) -> mla_mod.MLASpec:
    return mla_mod.MLASpec(
        d_model=cfg.d_model, n_heads=cfg.n_heads,
        q_lora_rank=cfg.q_lora_rank, kv_lora_rank=cfg.kv_lora_rank,
        d_nope=cfg.mla_d_nope, d_rope=cfg.mla_d_rope, d_v=cfg.mla_d_v,
        rope_theta=cfg.rope_theta)


def moe_spec(cfg: ModelConfig) -> MoESpec:
    return MoESpec(
        d_model=cfg.d_model, n_experts=cfg.n_experts, top_k=cfg.top_k,
        d_ff_expert=cfg.d_ff_expert, n_shared=cfg.n_shared_experts,
        capacity_factor=cfg.capacity_factor, norm_topk=cfg.norm_topk,
        routed_scale=cfg.routed_scale)


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------
class Block(nn.Module):
    """Pre-norm block: ``h + attn(ln1(h))``, then ``+ ffn(ln2(.))``, where
    ``attn`` is an `Attention` or an `MLA` and the FFN is ``mlp`` (an
    `MLP`) or ``moe`` (an `MoE`); a parallel block has no ``ln2`` and
    returns ``h + attn(a) + ffn(a)``, a = ln1(h)."""

    def __init__(self, ln1: Norm, attn_: nn.Module, ln2: Norm | None, mlp: MLP | None = None,
                 moe: MoE | None = None):
        super().__init__()
        if (mlp is None) == (moe is None):
            raise ValueError("a block takes one FFN: mlp or moe")
        self.ln1, self.attn, self.ln2, self.mlp, self.moe = ln1, attn_, ln2, mlp, moe


def _init_block(cfg: ModelConfig, moe_layer: bool, gen: torch.Generator) -> Block:
    dev = gen.device
    ln1 = norm_init(cfg.d_model, cfg.pdt, dev, kind=cfg.norm, bias=cfg.norm_bias)
    if cfg.attn_kind == "mla":
        attn_ = mla_mod.init_mla(gen, mla_spec(cfg), cfg.pdt)
    else:
        attn_ = attn.init_attention(gen, attn_spec(cfg), cfg.pdt)
    ln2 = (None if cfg.parallel_block else
           norm_init(cfg.d_model, cfg.pdt, dev, kind=cfg.norm, bias=cfg.norm_bias))
    if moe_layer:
        return Block(ln1, attn_, ln2, moe=init_moe(gen, moe_spec(cfg), cfg.pdt))
    return Block(ln1, attn_, ln2,
                 mlp=init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.pdt, kind=cfg.mlp_kind))


def _norm(cfg: ModelConfig, p: Norm, x: torch.Tensor) -> torch.Tensor:
    return apply_norm(p, x, kind=cfg.norm, eps=cfg.norm_eps)


def _ffn(cfg: ModelConfig, p: Block, x: torch.Tensor) -> torch.Tensor:
    if p.moe is not None:
        return apply_moe(p.moe, x, moe_spec(cfg))
    return apply_mlp(p.mlp, x, kind=cfg.mlp_kind)


def _apply_block(cfg: ModelConfig, p: Block, h, positions, *, return_kv=False):
    """One block over h [B, S, d]; with ``return_kv`` (prefill: no
    sequence-parallel hooks) also this layer's cache entry: (k, v) for GQA,
    (c_kv, k_pe) for MLA."""
    gather = (lambda x: x) if return_kv else maybe_gather_hidden
    a = gather(_norm(cfg, p.ln1, h))
    if cfg.attn_kind == "mla":
        out = mla_mod.apply_mla(p.attn, mla_spec(cfg), a, positions, return_cache=return_kv)
    else:
        out = attn.apply_attention(p.attn, attn_spec(cfg), a, positions, return_kv=return_kv)
    attn_out, kv = out if return_kv else (out, None)
    if cfg.parallel_block:
        h = h + attn_out + _ffn(cfg, p, a)
    else:
        h = h + attn_out
        h = h + _ffn(cfg, p, gather(_norm(cfg, p.ln2, h)))
    return (h, kv) if return_kv else maybe_shard_hidden(h)


def _decode_block(cfg: ModelConfig, p: Block, h1, cache_a, cache_b, pos):
    """One-token decode through a block; the cache pair is this layer's
    slice ((k, v) or MLA's (c_kv, k_pe)), written in place."""
    a = _norm(cfg, p.ln1, h1)
    if cfg.attn_kind == "mla":
        attn_out, _, _ = mla_mod.decode_mla(p.attn, mla_spec(cfg), a, cache_a, cache_b, pos)
    else:
        attn_out, _, _ = attn.decode_self_attention(p.attn, attn_spec(cfg), a, cache_a,
                                                    cache_b, pos)
    if cfg.parallel_block:
        return h1 + attn_out + _ffn(cfg, p, a)
    h1 = h1 + attn_out
    return h1 + _ffn(cfg, p, _norm(cfg, p.ln2, h1))


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------
class Decoder(nn.Module):
    """Token embedding, the leading dense stack (MoE configs with
    ``first_dense``; else empty), the main block stack, the final norm and
    (unless tied) the output embedding."""

    def __init__(self, embed: Embed, blocks: list[Block], ln_f: Norm,
                 unembed: Embed | None, dense_blocks: list[Block] = ()):
        super().__init__()
        self.embed = embed
        self.dense_blocks = nn.ModuleList(dense_blocks)
        self.blocks = nn.ModuleList(blocks)
        self.ln_f = ln_f
        self.unembed = unembed

    def stacks(self):
        """(cache key, blocks) for each non-empty stack, in the order the
        forward pass walks them."""
        return [(key, stack) for key, stack in (("dense", self.dense_blocks),
                                                ("main", self.blocks)) if len(stack)]


def _n_dense(cfg: ModelConfig) -> int:
    return cfg.first_dense if cfg.moe else 0


def init_decoder(cfg: ModelConfig, gen: torch.Generator) -> Decoder:
    """Random parameters on the generator's device, drawn in a fixed order."""
    check_family(cfg)
    n_dense = _n_dense(cfg)
    embed = embed_init(gen, cfg.vocab, cfg.d_model, cfg.pdt)
    ln_f = norm_init(cfg.d_model, cfg.pdt, gen.device, kind=cfg.norm,
                     bias=cfg.norm_bias)
    blocks = [_init_block(cfg, cfg.moe, gen) for _ in range(cfg.n_layers - n_dense)]
    dense_blocks = [_init_block(cfg, False, gen) for _ in range(n_dense)]
    unembed = None if cfg.tie_embeddings else embed_init(gen, cfg.vocab, cfg.d_model, cfg.pdt)
    return Decoder(embed, blocks, ln_f, unembed, dense_blocks)


def _out_emb(cfg: ModelConfig, model: Decoder) -> torch.Tensor:
    return (model.embed if cfg.tie_embeddings else model.unembed).emb


def _embed_tokens(cfg: ModelConfig, model: Decoder, tokens) -> torch.Tensor:
    return model.embed.emb[tokens.long()].to(cfg.cdt)


def _embed_inputs(cfg: ModelConfig, model: Decoder, tokens, frontend) -> torch.Tensor:
    """[B, S(+n_patches), d]: a VLM's patch embeddings, then the tokens'."""
    h = _embed_tokens(cfg, model, tokens)
    if cfg.family != "vlm":
        return h
    if frontend is None:
        raise ValueError(f"{cfg.name}: a VLM needs its patch embeddings (frontend)")
    return torch.cat([frontend.to(cfg.cdt), h], dim=1)


def _logits(cfg: ModelConfig, model: Decoder, h: torch.Tensor) -> torch.Tensor:
    return (h @ _out_emb(cfg, model).T).float() * cfg.logit_scale


def decoder_hidden(model: Decoder, cfg: ModelConfig, tokens, frontend=None) -> torch.Tensor:
    """tokens [B,S] -> final hidden [B, S(+n_patches), d]."""
    h = _embed_inputs(cfg, model, tokens, frontend)
    positions = torch.arange(h.shape[1], device=h.device)
    for _, stack in model.stacks():
        for blk in stack:
            h = maybe_remat(cfg.remat, lambda x, blk=blk: _apply_block(cfg, blk, x, positions), h)
    return _norm(cfg, model.ln_f, h)


def decoder_loss(model: Decoder, cfg: ModelConfig, batch: dict):
    """batch: tokens [B,S], labels [B,S] (-100 masked), a VLM's frontend
    -> (loss, {"loss": loss}). `repro`'s MoE adds no auxiliary loss here,
    nor does the port."""
    h = decoder_hidden(model, cfg, batch["tokens"], batch.get("frontend"))
    labels = batch["labels"]
    if cfg.family == "vlm":                       # patch positions: no loss
        pad = torch.full((labels.shape[0], cfg.n_patches), -100, dtype=labels.dtype,
                         device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    loss = chunked_cross_entropy(h, _out_emb(cfg, model), labels, chunk=cfg.logits_chunk,
                                 logit_scale=cfg.logit_scale)
    return loss, {"loss": loss}


# --------------------------------------------------------------------------
# serving: cache init / prefill / decode
# --------------------------------------------------------------------------
def decoder_init_cache(cfg: ModelConfig, batch: int, s_max: int, device) -> dict:
    """``{"main": pair, "dense": pair (MoE configs with first_dense only),
    "pos": [B] int32}``, each pair over its stack's L layers in the compute
    dtype: GQA's (k, v) [L, B, Hkv, S, D] (S = the window for a
    sliding-window config shorter than ``s_max``: a ring buffer), or MLA's
    (c_kv [L, B, S, R], k_pe [L, B, S, d_rope])."""
    check_family(cfg)
    n_dense = _n_dense(cfg)
    if cfg.attn_kind == "mla":
        shapes = ((batch, s_max, cfg.kv_lora_rank), (batch, s_max, cfg.mla_d_rope))
    else:
        w = cfg.window if cfg.window and cfg.window < s_max else s_max
        shapes = ((batch, cfg.n_kv, w, cfg.head_dim),) * 2

    def mk(n):
        return tuple(torch.zeros((n,) + sh, dtype=cfg.cdt, device=device) for sh in shapes)

    cache = {"main": mk(cfg.n_layers - n_dense),
             "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if n_dense:
        cache["dense"] = mk(n_dense)
    return cache


def _write_prefill(cfg: ModelConfig, cache_pair, layer: int, kv, s: int) -> None:
    """Write one layer's prefill cache entry into the cache at positions
    [0, s), in place: GQA's k, v [B, Hkv, s, D] (a ring buffer keeps the
    last slots) or MLA's c_kv [B, s, R], k_pe [B, s, d_rope]."""
    ck, cv = cache_pair
    k, v = kv
    if cfg.attn_kind == "mla":
        ck[layer, :, :s] = k
        cv[layer, :, :s] = v
        return
    s_max = ck.shape[3]
    if s_max < s:
        sl = torch.arange(s - s_max, s, device=ck.device) % s_max
        ck[layer, :, :, sl] = k[:, :, -s_max:]
        cv[layer, :, :, sl] = v[:, :, -s_max:]
    else:
        ck[layer, :, :, :s] = k
        cv[layer, :, :, :s] = v


def decoder_prefill(model: Decoder, cfg: ModelConfig, tokens, cache: dict, frontend=None):
    """Run the prompt (after a VLM's patches), fill the cache in place,
    return (last-position logits [B, V] f32, cache)."""
    h = _embed_inputs(cfg, model, tokens, frontend)
    s_tot = h.shape[1]
    positions = torch.arange(s_tot, device=h.device)
    for key, stack in model.stacks():
        for i, blk in enumerate(stack):
            h, kv = _apply_block(cfg, blk, h, positions, return_kv=True)
            _write_prefill(cfg, cache[key], i, kv, s_tot)
    cache["pos"] = torch.full((tokens.shape[0],), s_tot, dtype=torch.int32,
                              device=h.device)
    h = _norm(cfg, model.ln_f, h)
    return _logits(cfg, model, h[:, -1]), cache


def decoder_decode_step(model: Decoder, cfg: ModelConfig, cache: dict, token):
    """token [B] int32 -> (logits [B, V] f32, cache), at position
    ``cache["pos"]``; the cache is written in place."""
    pos = cache["pos"]
    h = _embed_tokens(cfg, model, token[:, None])
    for key, stack in model.stacks():
        ca, cb = cache[key]
        for i, blk in enumerate(stack):
            h = _decode_block(cfg, blk, h, ca[i], cb[i], pos)
    cache["pos"] = pos + 1
    h = _norm(cfg, model.ln_f, h)
    return _logits(cfg, model, h[:, 0]), cache
