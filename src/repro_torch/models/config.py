"""ModelConfig — the single config surface for every architecture family.

A copy of `repro.models.config.ModelConfig` with the same fields, defaults
and `reduced()`, except that `pdt` / `cdt` return `torch.dtype`s and these
XLA execution knobs are gone:

  impl, block_q, block_k   the attention implementation and its tiles: the
                           port routes by device and by autograd instead (a
                           CPU tensor takes the plain version, a CUDA tensor
                           the hand-written kernel, which picks its own
                           tiles; a forward under autograd the chunked
                           plain form, `repro_torch.models.attention`)
  seq_chunk                mixer sequence chunking for XLA's memory planning

``remat`` (recompute each block in the backward pass,
`torch.utils.checkpoint` where `repro` wraps it in ``jax.checkpoint``) and
``logits_chunk`` (the sequence chunk of the training loss,
`repro_torch.models.common.chunked_cross_entropy`) are `repro`'s, with its
defaults and its ``reduced()`` values; serving reads neither.

Family-specific fields are kept even where the family is not ported yet
(`repro_torch.configs.registry` says which are).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int = 0
    d_head: int = 0              # 0 -> d_model // n_heads
    d_ff: int = 0
    vocab: int = 0
    norm: str = "rms"            # rms | layer
    norm_eps: float = 1e-5
    norm_bias: bool = False
    rope_theta: float = 10000.0
    rope_frac: float = 1.0       # stablelm: partial rotary
    qkv_bias: bool = False
    mlp_kind: str = "swiglu"     # swiglu | gelu
    tie_embeddings: bool = False
    parallel_block: bool = False  # cohere: attn/MLP from the same norm
    logit_scale: float = 1.0
    window: int | None = None    # sliding-window attention
    attn_kind: str = "gqa"       # gqa | mla
    # --- MLA (deepseek-v2) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 512
    mla_d_nope: int = 128
    mla_d_rope: int = 64
    mla_d_v: int = 128
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    first_dense: int = 0         # leading dense-FFN layers (deepseek: 1)
    capacity_factor: float = 1.25
    norm_topk: bool = False
    routed_scale: float = 1.0
    # --- SSM / hybrid (mamba2 / zamba2) ---
    ssm_state: int = 64
    ssm_head: int = 64
    n_attn_groups: int = 0       # zamba2: shared-attn applications
    mamba_per_group: int = 0
    trailing_mamba: int = 0
    lora_rank: int = 0           # zamba2 per-application LoRA
    # --- rwkv6 ---
    rwkv_heads: int = 0
    mix_rank: int = 32
    decay_rank: int = 64
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 0             # stubbed frame embeddings per example
    # --- vlm ---
    n_patches: int = 0           # stubbed patch embeddings per example
    # --- execution ---
    ssm_chunk: int = 128
    rwkv_chunk: int = 64
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    logits_chunk: int = 512
    max_pos: int = 1 << 20       # learned-pos table bound (whisper decoder)

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def pdt(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdt(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized sibling of this config (same family/topology
        knobs, tiny dims), as `repro`'s ``reduced()`` makes it."""
        d_head = min(self.head_dim, 16)
        n_heads = max(2, min(self.n_heads, 4))
        n_kv = max(1, min(self.n_kv or n_heads, n_heads))
        if self.n_kv and self.n_kv >= self.n_heads:   # MHA stays MHA
            n_kv = n_heads
        small = dict(
            n_layers=min(self.n_layers, 2),
            d_model=n_heads * d_head,
            n_heads=n_heads,
            n_kv=n_kv,
            d_head=d_head,
            d_ff=64,
            vocab=min(self.vocab, 128) or 0,
            q_lora_rank=min(self.q_lora_rank, 24),
            kv_lora_rank=min(self.kv_lora_rank, 16),
            mla_d_nope=16, mla_d_rope=8, mla_d_v=16,
            n_experts=min(self.n_experts, 8) if self.moe else 0,
            top_k=min(self.top_k, 2) if self.moe else 0,
            d_ff_expert=32 if self.moe else 0,
            # dropless at smoke scale: capacity drops would make
            # prefill+decode differ from the teacher-forced pass
            capacity_factor=8.0 if self.moe else self.capacity_factor,
            n_shared_experts=min(self.n_shared_experts, 1),
            ssm_state=min(self.ssm_state, 16),
            ssm_head=min(self.ssm_head, 16),
            n_attn_groups=min(self.n_attn_groups, 2),
            mamba_per_group=min(self.mamba_per_group, 2),
            trailing_mamba=min(self.trailing_mamba, 1),
            lora_rank=min(self.lora_rank, 8),
            rwkv_heads=min(self.rwkv_heads, 4) if self.rwkv_heads else 0,
            mix_rank=8, decay_rank=8,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_seq=min(self.enc_seq, 16) or 0,
            n_patches=min(self.n_patches, 8) or 0,
            window=min(self.window, 16) if self.window else None,
            ssm_chunk=8, rwkv_chunk=8,
            logits_chunk=16,
            param_dtype="float32", compute_dtype="float32",
            remat=False,
        )
        if self.family == "ssm":
            small["d_model"] = 64
            small["rwkv_heads"] = 4
            small["d_ff"] = 128
        if self.family == "hybrid":
            small["n_layers"] = (small["n_attn_groups"] * small["mamba_per_group"]
                                 + small["n_attn_groups"] + small["trailing_mamba"])
        small.update(overrides)
        return dataclasses.replace(self, **small)
