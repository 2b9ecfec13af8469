"""stablelm-1.6b — [hf:stabilityai/stablelm-2-1_6b; unverified].

24L d_model=2048 32H (MHA: kv=32) d_ff=5632 vocab=100352. LayerNorm,
partial rotary (25%), qkv bias. Pure full attention.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv=32,
    d_ff=5632,
    vocab=100352,
    norm="layer",
    norm_bias=True,
    rope_frac=0.25,
    qkv_bias=True,
    rope_theta=10000.0,
)
