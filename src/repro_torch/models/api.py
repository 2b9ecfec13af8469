"""Unified model API — dispatch on cfg.family.

  init_lm(cfg, generator, device)            -> model
  lm_loss(model, cfg, batch)                 -> (loss, metrics)   [train]
  init_cache(cfg, batch, s_max, device)      -> cache dict
  lm_prefill(model, cfg, cache, batch)       -> (logits, cache)
  lm_decode_step(model, cfg, cache, token)   -> (logits, cache)

batch = {"tokens": [B,S] int32, "labels": [B,S] int32 (-100 masked;
training only), "frontend": [B, n_patches|enc_seq, d] (the ``vlm`` and
``encdec`` families' stub embeddings only)}. Every family
of `repro` is ported: the decoder families ``dense``, ``moe`` and ``vlm``
(`transformer`: GQA, sliding-window or MLA attention, MLP or MoE FFNs,
Cohere's parallel block, a VLM's patches before the tokens), the RWKV6
``ssm`` family (`rwkv_model`), the Mamba2 ``hybrid`` family with its
shared attention block (`zamba`) and the ``encdec`` family (`whisper`).
`lm_loss` trains every family through the differentiable plain forms
(`repro_torch.kernels.ops.needs_grad`).
"""
from __future__ import annotations

import torch

from repro_torch.core.device_graph import resolve_device
from repro_torch.models import rwkv_model, transformer, whisper, zamba
from repro_torch.models.config import ModelConfig


def init_lm(cfg: ModelConfig, generator: torch.Generator, device):
    """Random parameters drawn from ``generator``, which lives on ``device``
    (default-CUDA entry points pass ``"cuda"``; the CPU path ``"cpu"``).
    With ``common.MetaDraws()`` and ``"meta"`` the parameters are meta
    tensors: shapes and dtypes, nothing allocated or drawn (the dry run)."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, expected {dev}")
    if cfg.family == "ssm":
        return rwkv_model.init_rwkv(cfg, generator)
    if cfg.family == "hybrid":
        return zamba.init_zamba(cfg, generator)
    if cfg.family == "encdec":
        return whisper.init_whisper(cfg, generator)
    return transformer.init_decoder(cfg, generator)


def lm_loss(model, cfg: ModelConfig, batch: dict):
    """Mean next-token CE of ``batch`` -> (loss 0-dim f32, {"loss": loss})."""
    if cfg.family == "ssm":
        return rwkv_model.rwkv_loss(model, cfg, batch)
    if cfg.family == "hybrid":
        return zamba.zamba_loss(model, cfg, batch)
    if cfg.family == "encdec":
        return whisper.whisper_loss(model, cfg, batch)
    return transformer.decoder_loss(model, cfg, batch)


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device) -> dict:
    dev = resolve_device(device)
    if cfg.family == "ssm":
        return rwkv_model.rwkv_init_cache(cfg, batch, s_max, dev)
    if cfg.family == "hybrid":
        return zamba.zamba_init_cache(cfg, batch, s_max, dev)
    if cfg.family == "encdec":
        return whisper.whisper_init_cache(cfg, batch, s_max, dev)
    return transformer.decoder_init_cache(cfg, batch, s_max, dev)


def lm_prefill(model, cfg: ModelConfig, cache: dict, batch: dict):
    tokens = batch["tokens"]
    if cfg.family == "ssm":
        return rwkv_model.rwkv_prefill(model, cfg, tokens, cache)
    if cfg.family == "hybrid":
        return zamba.zamba_prefill(model, cfg, tokens, cache)
    if cfg.family == "encdec":
        return whisper.whisper_prefill(model, cfg, tokens, cache, batch["frontend"])
    return transformer.decoder_prefill(model, cfg, tokens, cache,
                                       frontend=batch.get("frontend"))


def lm_decode_step(model, cfg: ModelConfig, cache: dict, token):
    if cfg.family == "ssm":
        return rwkv_model.rwkv_decode_step(model, cfg, cache, token)
    if cfg.family == "hybrid":
        return zamba.zamba_decode_step(model, cfg, cache, token)
    if cfg.family == "encdec":
        return whisper.whisper_decode_step(model, cfg, cache, token)
    return transformer.decoder_decode_step(model, cfg, cache, token)
