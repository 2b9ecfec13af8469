"""RWKV6 full model stack (the attention-free ``ssm`` family).

The counterpart of `repro.models.rwkv_model`. Blocks = time mix + channel
mix with pre-LayerNorms; ln0 after the embedding (RWKV convention). Blocks
are `nn.Module`s in an `nn.ModuleList` walked by a Python loop, where
`repro` scans a stacked ``[L, ...]`` layer axis
(`repro_torch.models.convert` splits it). Serving state per layer: the
[B,H,N,N] wkv state plus the two token-shift buffers, O(1) in sequence
length. Prefill and decode both run the recurrence through K6 on the card,
decode with S = 1: one launch per layer and step.

Paths:
  rwkv_hidden       tokens -> final hidden (the teacher-forced pass; each
                    block rematerialised in backward where ``cfg.remat``;
                    under autograd the recurrence is the out-of-place
                    `rwkv6.wkv6_scan`)
  rwkv_loss         train: mean next-token CE over the hidden
  rwkv_prefill      tokens -> (last-position logits, cache)
  rwkv_decode_step  one token against the cache
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import (Embed, Norm, apply_norm, chunked_cross_entropy,
                                       embed_init, maybe_remat, norm_init)
from repro_torch.models.config import ModelConfig
from repro_torch.models.rwkv6 import (
    ChannelMix,
    RWKV6Spec,
    TimeMix,
    apply_rwkv6_channel,
    apply_rwkv6_time,
    init_rwkv6_channel,
    init_rwkv6_time,
)


def rwkv_spec(cfg: ModelConfig) -> RWKV6Spec:
    return RWKV6Spec(d_model=cfg.d_model, n_heads=cfg.rwkv_heads,
                     d_ffn=cfg.d_ff, mix_rank=cfg.mix_rank,
                     decay_rank=cfg.decay_rank)


class RWKVBlock(nn.Module):
    """``h + time(ln1(h))``, then ``+ chan(ln2(.))``."""

    def __init__(self, ln1: Norm, ln2: Norm, time: TimeMix, chan: ChannelMix):
        super().__init__()
        self.ln1, self.ln2, self.time, self.chan = ln1, ln2, time, chan


class RWKV(nn.Module):
    """Token embedding, ln0, the block stack, the final norm and the output
    embedding."""

    def __init__(self, embed: Embed, ln0: Norm, blocks: list[RWKVBlock],
                 ln_f: Norm, unembed: Embed):
        super().__init__()
        self.embed, self.ln0 = embed, ln0
        self.blocks = nn.ModuleList(blocks)
        self.ln_f, self.unembed = ln_f, unembed


def _layer_norm(cfg: ModelConfig, gen: torch.Generator) -> Norm:
    return norm_init(cfg.d_model, cfg.pdt, gen.device, kind="layer", bias=True)


def init_rwkv(cfg: ModelConfig, gen: torch.Generator) -> RWKV:
    """Random parameters on the generator's device, drawn in a fixed order."""
    spec = rwkv_spec(cfg)
    embed = embed_init(gen, cfg.vocab, cfg.d_model, cfg.pdt)
    blocks = [RWKVBlock(_layer_norm(cfg, gen), _layer_norm(cfg, gen),
                        init_rwkv6_time(gen, spec, cfg.pdt),
                        init_rwkv6_channel(gen, spec, cfg.pdt))
              for _ in range(cfg.n_layers)]
    unembed = embed_init(gen, cfg.vocab, cfg.d_model, cfg.pdt)
    return RWKV(embed, _layer_norm(cfg, gen), blocks, _layer_norm(cfg, gen), unembed)


def _norm(cfg: ModelConfig, p: Norm, x: torch.Tensor) -> torch.Tensor:
    return apply_norm(p, x, kind="layer", eps=cfg.norm_eps)


def _block(cfg: ModelConfig, p: RWKVBlock, h: torch.Tensor, *, states=None):
    """One block; states = (x_time, wkv, x_chan) or None (zero init). A
    given wkv state is updated in place."""
    xt, wkv, xc = states if states is not None else (None, None, None)
    y, (last_xt, wkv) = apply_rwkv6_time(p.time, rwkv_spec(cfg), _norm(cfg, p.ln1, h),
                                         x_prev=xt, wkv_state=wkv)
    h = h + y
    y2, last_xc = apply_rwkv6_channel(p.chan, _norm(cfg, p.ln2, h), x_prev=xc)
    return h + y2, (last_xt, wkv, last_xc)


def _embed(cfg: ModelConfig, model: RWKV, tokens: torch.Tensor) -> torch.Tensor:
    return _norm(cfg, model.ln0, model.embed.emb[tokens.long()].to(cfg.cdt))


def _logits(model: RWKV, h: torch.Tensor) -> torch.Tensor:
    return (h @ model.unembed.emb.T).float()


def rwkv_hidden(model: RWKV, cfg: ModelConfig, tokens) -> torch.Tensor:
    """tokens [B,S] -> final hidden [B, S, d]."""
    h = _embed(cfg, model, tokens)
    for blk in model.blocks:
        h = maybe_remat(cfg.remat, lambda x, blk=blk: _block(cfg, blk, x)[0], h)
    return _norm(cfg, model.ln_f, h)


def rwkv_loss(model: RWKV, cfg: ModelConfig, batch: dict):
    """batch: tokens [B,S], labels [B,S] (-100 masked) -> (loss, {"loss"})."""
    h = rwkv_hidden(model, cfg, batch["tokens"])
    loss = chunked_cross_entropy(h, model.unembed.emb, batch["labels"],
                                 chunk=cfg.logits_chunk)
    return loss, {"loss": loss}


# --------------------------------------------------------------------------
# serving: cache init / prefill / decode
# --------------------------------------------------------------------------
def rwkv_init_cache(cfg: ModelConfig, batch: int, s_max: int, device) -> dict:
    """``x_time``/``x_chan`` [L,B,1,d] in the compute dtype, ``wkv``
    [L,B,H,N,N] f32, ``pos`` [B] int32 (``s_max`` is not needed: the state
    does not grow)."""
    spec = rwkv_spec(cfg)
    l, d = cfg.n_layers, cfg.d_model
    return {
        "x_time": torch.zeros((l, batch, 1, d), dtype=cfg.cdt, device=device),
        "wkv": torch.zeros((l, batch, spec.n_heads, spec.d_head, spec.d_head),
                           dtype=torch.float32, device=device),
        "x_chan": torch.zeros((l, batch, 1, d), dtype=cfg.cdt, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _run_with_states(model: RWKV, cfg: ModelConfig, h: torch.Tensor, cache: dict):
    """The block stack from the cache's states, which are updated in place."""
    for i, blk in enumerate(model.blocks):
        states = (cache["x_time"][i], cache["wkv"][i], cache["x_chan"][i])
        h, (xt, _, xc) = _block(cfg, blk, h, states=states)
        cache["x_time"][i].copy_(xt)
        cache["x_chan"][i].copy_(xc)
    return h


def rwkv_prefill(model: RWKV, cfg: ModelConfig, tokens, cache: dict):
    """Run the prompt, update the cache in place, return (last-position
    logits [B, V] f32, cache)."""
    h = _run_with_states(model, cfg, _embed(cfg, model, tokens), cache)
    cache["pos"] = torch.full((tokens.shape[0],), tokens.shape[1],
                              dtype=torch.int32, device=h.device)
    return _logits(model, _norm(cfg, model.ln_f, h[:, -1])), cache


def rwkv_decode_step(model: RWKV, cfg: ModelConfig, cache: dict, token):
    """token [B] int32 -> (logits [B, V] f32, cache); the cache is updated
    in place."""
    h = _run_with_states(model, cfg, _embed(cfg, model, token[:, None]), cache)
    cache["pos"] = cache["pos"] + 1
    return _logits(model, _norm(cfg, model.ln_f, h[:, 0])), cache
