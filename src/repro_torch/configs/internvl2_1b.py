"""internvl2-1b — InternViT + InternLM2/Qwen2-0.5B backbone
[arXiv:2404.16821; hf]. 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655. The ViT frontend is a STUB: the caller passes 256
precomputed patch embeddings per example, merged before layer 0.

Pure full attention: long_500k skipped.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv=2,
    d_ff=4864,
    vocab=151655,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    n_patches=256,
)
