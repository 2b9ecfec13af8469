"""zamba2-7b — Mamba2 + shared attn blocks [arXiv:2411.15242; unverified].

81L d_model=3584 32H d_ff=14336 vocab=32000, ssm_state=64. Layout:
13 x [shared-attn, 5 x mamba2] + 3 trailing mamba2 = 81 layers; the
attention block runs at 2*d width on concat(h, h0) with per-application
LoRA (rank 128) on q/k/v. Hybrid => long_500k RUNS (SSM state + 13
seq-sharded KV caches).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv=32,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_head=64,
    n_attn_groups=13,
    mamba_per_group=5,
    trailing_mamba=3,
    lora_rank=128,
    rope_theta=10000.0,
)
