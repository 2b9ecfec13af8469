"""Zamba2-style hybrid stack: a Mamba2 backbone and one SHARED attention
block applied between groups of Mamba2 layers (arXiv:2411.15242).

The counterpart of `repro.models.zamba`. Layer layout (cfg.n_layers =
G (1 + M) + T): [shared attention, M x Mamba2] x G groups, then T trailing
Mamba2 layers. The shared block's weights are one parameter set; each of
its G applications adds its own LoRA delta on the q/k/v projections. Its
input is concat(h, h0) (2 d wide, h0 the embedding output), attention and
MLP run at 2 d, and the output is projected back to d and added to the
residual stream.

Its attention is MHA at head width 2 d / n_heads (224 at zamba2-7b): the
prefill goes through `attention.attend` (K4 on the card), the decode
through `ops.decode_attention` with kv_len = pos + 1 (K5 on the card),
the function `repro`'s masked-softmax decode computes. The Mamba2 layers
are plain PyTorch (`repro_torch.models.ssm`), as they are XLA in `repro`.
The shared block gathers its normed input and a Mamba2 block gathers its
input and splits its output under `repro`'s sequence-parallel hooks, where
`repro` calls them (`repro_torch.parallel.act_sharding`).

Parameters: ``embed``, ``shared`` (``ln1``, ``attn``, ``ln2``, ``mlp``,
``out``), ``lora`` (G `LoRASet`s), ``mamba`` (G groups of M `MambaBlock`s),
``trailing`` (T `MambaBlock`s), ``ln_f`` and the untied ``unembed``:
`repro`'s tree with its stacked axes split (`repro_torch.models.convert`).

Serving state: G KV caches (one per shared-block application: the weights
are shared, the caches are not) and each Mamba2 layer's SSM and conv
states, in `repro`'s keys, nesting and shapes:
  kv         (k, v) [G, B, H, S, D]
  ssm        (state [G, M, B, H, P, N] f32, (conv_x, conv_bc) [G, M, B, ...])
  trail_ssm  the same over [T, ...] (when T > 0)
  h0         [B, 1, d] (the last prompt token's embedding; decode reads the
             current token's)
  pos        [B] int32
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models.common import (Dense, Embed, Norm, _normal, _param, apply_norm,
                                       apply_rope, chunked_cross_entropy, dense, dense_init,
                                       embed_init, maybe_remat, norm_init)
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import MLP, apply_mlp, init_mlp
from repro_torch.models.ssm import (Mamba2, Mamba2Spec, apply_mamba2, apply_mamba2_with_state,
                                    decode_mamba2, init_mamba2, init_mamba2_state)
from repro_torch.parallel.act_sharding import maybe_gather_hidden, maybe_shard_hidden


def mamba_spec(cfg: ModelConfig) -> Mamba2Spec:
    return Mamba2Spec(d_model=cfg.d_model, d_state=cfg.ssm_state, d_head=cfg.ssm_head,
                      chunk=cfg.ssm_chunk)


def shared_attn_spec(cfg: ModelConfig) -> attn.AttnSpec:
    d2 = 2 * cfg.d_model
    return attn.AttnSpec(d_model=d2, n_q=cfg.n_heads, n_kv=cfg.n_kv, d_head=d2 // cfg.n_heads,
                         causal=True, rope_theta=cfg.rope_theta)


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------
class SharedBlock(nn.Module):
    """The shared attention block at 2 d: ``ln1``, ``attn``, ``ln2``,
    ``mlp`` and the ``out`` projection back to d."""

    def __init__(self, ln1: Norm, attn_: attn.Attention, ln2: Norm, mlp: MLP, out: Dense):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp, self.out = ln1, attn_, ln2, mlp, out


class LoRA(nn.Module):
    """A rank-r delta ``(x @ a) @ b`` beside one projection."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.a, self.b = _param(a), _param(b)


class LoRASet(nn.Module):
    """One application's LoRA pairs on the shared q, k and v projections."""

    def __init__(self, q: LoRA, k: LoRA, v: LoRA):
        super().__init__()
        self.q, self.k, self.v = q, k, v


class MambaBlock(nn.Module):
    """Pre-norm Mamba2 layer: ``h + mix(ln(h))``."""

    def __init__(self, ln: Norm, mix: Mamba2):
        super().__init__()
        self.ln, self.mix = ln, mix


class Zamba(nn.Module):
    def __init__(self, embed: Embed, shared: SharedBlock, lora: list[LoRASet],
                 mamba: list[list[MambaBlock]], trailing: list[MambaBlock], ln_f: Norm,
                 unembed: Embed):
        super().__init__()
        self.embed, self.shared = embed, shared
        self.lora = nn.ModuleList(lora)
        self.mamba = nn.ModuleList(nn.ModuleList(group) for group in mamba)
        self.trailing = nn.ModuleList(trailing)
        self.ln_f, self.unembed = ln_f, unembed


def _check_layout(cfg: ModelConfig) -> None:
    g, m, t = cfg.n_attn_groups, cfg.mamba_per_group, cfg.trailing_mamba
    if cfg.n_layers != g * (1 + m) + t:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} != {g} x (1 + {m}) + {t}")


def _init_lora(cfg: ModelConfig, gen: torch.Generator) -> LoRASet:
    """`repro`'s: a ~ N(0, 0.01^2), b = 0 (the delta starts at zero)."""
    d2, r = 2 * cfg.d_model, cfg.lora_rank
    spec = shared_attn_spec(cfg)

    def pair(d_out):
        return LoRA(_normal(gen, (d2, r), 0.01, cfg.pdt),
                    torch.zeros((r, d_out), dtype=cfg.pdt, device=gen.device))

    return LoRASet(pair(spec.n_q * spec.d_head), pair(spec.n_kv * spec.d_head),
                   pair(spec.n_kv * spec.d_head))


def _init_mamba_block(cfg: ModelConfig, gen: torch.Generator) -> MambaBlock:
    return MambaBlock(norm_init(cfg.d_model, cfg.pdt, gen.device),
                      init_mamba2(gen, mamba_spec(cfg), cfg.pdt))


def init_zamba(cfg: ModelConfig, gen: torch.Generator) -> Zamba:
    """Random parameters on the generator's device, drawn in a fixed order
    (`repro`'s distributions, not its keys)."""
    _check_layout(cfg)
    d2, dev = 2 * cfg.d_model, gen.device
    embed = embed_init(gen, cfg.vocab, cfg.d_model, cfg.pdt)
    shared = SharedBlock(norm_init(d2, cfg.pdt, dev),
                         attn.init_attention(gen, shared_attn_spec(cfg), cfg.pdt),
                         norm_init(d2, cfg.pdt, dev), init_mlp(gen, d2, cfg.d_ff, cfg.pdt),
                         dense_init(gen, d2, cfg.d_model, cfg.pdt))
    lora = [_init_lora(cfg, gen) for _ in range(cfg.n_attn_groups)]
    mamba = [[_init_mamba_block(cfg, gen) for _ in range(cfg.mamba_per_group)]
             for _ in range(cfg.n_attn_groups)]
    trailing = [_init_mamba_block(cfg, gen) for _ in range(cfg.trailing_mamba)]
    return Zamba(embed, shared, lora, mamba, trailing, norm_init(cfg.d_model, cfg.pdt, dev),
                 embed_init(gen, cfg.vocab, cfg.d_model, cfg.pdt))


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------
def _norm(cfg: ModelConfig, p: Norm, x: torch.Tensor) -> torch.Tensor:
    return apply_norm(p, x, kind=cfg.norm, eps=cfg.norm_eps)


def _shared_qkv(p: SharedBlock, lora: LoRASet, spec: attn.AttnSpec, a):
    """q, k, v [B, H, S, D] from the shared projections plus this
    application's LoRA deltas."""
    def proj(w, lr):
        return dense(w, a) + (a @ lr.a) @ lr.b

    b, s, _ = a.shape

    def heads(x, n):
        return x.reshape(b, s, n, spec.d_head).transpose(1, 2)

    return (heads(proj(p.attn.wq, lora.q), spec.n_q), heads(proj(p.attn.wk, lora.k), spec.n_kv),
            heads(proj(p.attn.wv, lora.v), spec.n_kv))


def _apply_shared(cfg: ModelConfig, p: SharedBlock, lora: LoRASet, h, h0, positions, *,
                  cache=None, pos=None):
    """The shared attention block over h [B, S, d] (prefill: returns the
    post-RoPE (k, v)), or with ``cache`` = (ck, cv) [B, H, S_max, D] one
    decode token at ``pos``, its k and v written into the caches in place.
    Returns (h + block(concat(h, h0)), (k, v) or the caches)."""
    spec = shared_attn_spec(cfg)
    xin = torch.cat([h, h0], dim=-1)
    q, k, v = _shared_qkv(p, lora, spec, maybe_gather_hidden(_norm(cfg, p.ln1, xin)))
    if cache is None:
        q = apply_rope(q, positions[None, None, :], theta=spec.rope_theta)
        k = apply_rope(k, positions[None, None, :], theta=spec.rope_theta)
        o = attn.attend(q, k, v, causal=True)
        new_kv = (k, v)
    else:
        ck, cv = cache
        q = apply_rope(q, pos[:, None, None], theta=spec.rope_theta)
        k = apply_rope(k, pos[:, None, None], theta=spec.rope_theta)
        bi = torch.arange(h.shape[0], device=h.device)
        ck[bi, :, pos] = k[:, :, 0]
        cv[bi, :, pos] = v[:, :, 0]
        o = ops.decode_attention(q[:, :, 0].contiguous(), ck, cv,
                                 (pos + 1).to(torch.int32))[:, :, None, :]
        new_kv = (ck, cv)
    b, s = h.shape[:2]
    o = o.transpose(1, 2).reshape(b, s, spec.n_q * spec.d_head)
    xin = xin + dense(p.attn.wo, o)
    xin = xin + apply_mlp(p.mlp, _norm(cfg, p.ln2, xin))
    return h + dense(p.out, xin), new_kv


def _apply_mamba_block(cfg: ModelConfig, p: MambaBlock, h):
    a = maybe_gather_hidden(_norm(cfg, p.ln, h))
    return maybe_shard_hidden(h + apply_mamba2(p.mix, mamba_spec(cfg), a))


def _prefill_mamba_block(cfg: ModelConfig, p: MambaBlock, h):
    y, state = apply_mamba2_with_state(p.mix, mamba_spec(cfg), _norm(cfg, p.ln, h))
    return h + y, state


def _decode_mamba_block(cfg: ModelConfig, p: MambaBlock, h1, ssm_state, conv_state):
    y, ssm_state, conv_state = decode_mamba2(p.mix, mamba_spec(cfg), _norm(cfg, p.ln, h1),
                                             ssm_state, conv_state)
    return h1 + y, ssm_state, conv_state


def _embed_tokens(cfg: ModelConfig, model: Zamba, tokens) -> torch.Tensor:
    return model.embed.emb[tokens.long()].to(cfg.cdt)


def _logits(model: Zamba, h: torch.Tensor) -> torch.Tensor:
    return (h @ model.unembed.emb.T).float()


def _mamba_stack(cfg: ModelConfig, blocks, h):
    """Mamba2 layers in turn, each rematerialised where ``cfg.remat``."""
    for blk in blocks:
        h = maybe_remat(cfg.remat, lambda x, blk=blk: _apply_mamba_block(cfg, blk, x), h)
    return h


def zamba_hidden(model: Zamba, cfg: ModelConfig, tokens) -> torch.Tensor:
    """tokens [B,S] -> final hidden [B, S, d] (the teacher-forced pass).
    Where ``cfg.remat``, `repro`'s nested rematerialisation: each group
    (the shared block and its Mamba2 layers) outside, each Mamba2 layer
    inside."""
    h = _embed_tokens(cfg, model, tokens)
    h0 = h
    positions = torch.arange(h.shape[1], device=h.device)

    def group_fn(x, lora, group):
        x, _ = _apply_shared(cfg, model.shared, lora, x, h0, positions)
        return _mamba_stack(cfg, group, x)

    for lora, group in zip(model.lora, model.mamba):
        h = maybe_remat(cfg.remat, lambda x, lora=lora, group=group: group_fn(x, lora, group), h)
    h = _mamba_stack(cfg, model.trailing, h)
    return _norm(cfg, model.ln_f, h)


def zamba_loss(model: Zamba, cfg: ModelConfig, batch: dict):
    """batch: tokens [B,S], labels [B,S] (-100 masked) -> (loss, {"loss"})."""
    h = zamba_hidden(model, cfg, batch["tokens"])
    loss = chunked_cross_entropy(h, model.unembed.emb, batch["labels"],
                                 chunk=cfg.logits_chunk)
    return loss, {"loss": loss}


# --------------------------------------------------------------------------
# serving: cache init / prefill / decode
# --------------------------------------------------------------------------
def _ssm_states(cfg: ModelConfig, lead: tuple, batch: int, device):
    """(state, (conv_x, conv_bc)) zeros with leading axes ``lead``."""
    state, (cx, cbc) = init_mamba2_state(mamba_spec(cfg), batch, cfg.cdt, device)
    return (state.expand(lead + state.shape).contiguous(),
            (cx.expand(lead + cx.shape).contiguous(), cbc.expand(lead + cbc.shape).contiguous()))


def zamba_init_cache(cfg: ModelConfig, batch: int, s_max: int, device) -> dict:
    """The serving cache in `repro`'s keys, nesting and shapes (module
    docstring); the KV caches in the compute dtype."""
    _check_layout(cfg)
    g, m, t = cfg.n_attn_groups, cfg.mamba_per_group, cfg.trailing_mamba
    aspec = shared_attn_spec(cfg)
    kv_shape = (g, batch, aspec.n_kv, s_max, aspec.d_head)
    cache = {
        "kv": tuple(torch.zeros(kv_shape, dtype=cfg.cdt, device=device) for _ in range(2)),
        "ssm": _ssm_states(cfg, (g, m), batch, device),
        "h0": torch.zeros((batch, 1, cfg.d_model), dtype=cfg.cdt, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if t:
        cache["trail_ssm"] = _ssm_states(cfg, (t,), batch, device)
    return cache


def _store_states(dst, idx: tuple, src) -> None:
    """Copy one layer's (state, (conv_x, conv_bc)) into a cache entry's
    stacked tensors at index ``idx``, in place."""
    state, (cx, cbc) = src
    dst[0][idx].copy_(state)
    dst[1][0][idx].copy_(cx)
    dst[1][1][idx].copy_(cbc)


def zamba_prefill(model: Zamba, cfg: ModelConfig, tokens, cache: dict):
    """Run the prompt, fill the cache in place (KV at positions [0, S), the
    final SSM and conv states), return (last-position logits [B, V] f32,
    cache)."""
    h = _embed_tokens(cfg, model, tokens)
    h0 = h
    b, s = tokens.shape
    positions = torch.arange(s, device=h.device)
    ck, cv = cache["kv"]
    for gi, (lora, group) in enumerate(zip(model.lora, model.mamba)):
        h, (k, v) = _apply_shared(cfg, model.shared, lora, h, h0, positions)
        ck[gi, :, :, :s] = k
        cv[gi, :, :, :s] = v
        for mi, blk in enumerate(group):
            h, state = _prefill_mamba_block(cfg, blk, h)
            _store_states(cache["ssm"], (gi, mi), state)
    for ti, blk in enumerate(model.trailing):
        h, state = _prefill_mamba_block(cfg, blk, h)
        _store_states(cache["trail_ssm"], (ti,), state)
    cache["h0"] = h0[:, -1:]
    cache["pos"] = torch.full((b,), s, dtype=torch.int32, device=h.device)
    h = _norm(cfg, model.ln_f, h)
    return _logits(model, h[:, -1]), cache


def zamba_decode_step(model: Zamba, cfg: ModelConfig, cache: dict, token):
    """token [B] int32 -> (logits [B, V] f32, cache), at position
    ``cache["pos"]``; the cache is written in place."""
    pos = cache["pos"]
    h = _embed_tokens(cfg, model, token[:, None])
    h0 = h              # the current token's embedding feeds the shared block
    ck, cv = cache["kv"]
    states, (conv_x, conv_bc) = cache["ssm"]
    for gi, (lora, group) in enumerate(zip(model.lora, model.mamba)):
        h, _ = _apply_shared(cfg, model.shared, lora, h, h0, None, cache=(ck[gi], cv[gi]),
                             pos=pos)
        for mi, blk in enumerate(group):
            h, st, conv = _decode_mamba_block(cfg, blk, h, states[gi, mi],
                                              (conv_x[gi, mi], conv_bc[gi, mi]))
            _store_states(cache["ssm"], (gi, mi), (st, conv))
    if model.trailing:
        t_states, (t_cx, t_cbc) = cache["trail_ssm"]
        for ti, blk in enumerate(model.trailing):
            h, st, conv = _decode_mamba_block(cfg, blk, h, t_states[ti], (t_cx[ti], t_cbc[ti]))
            _store_states(cache["trail_ssm"], (ti,), (st, conv))
    cache["pos"] = pos + 1
    h = _norm(cfg, model.ln_f, h)
    return _logits(model, h[:, 0]), cache
