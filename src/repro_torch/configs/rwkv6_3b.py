"""rwkv6-3b "Finch" — data-dependent decay, attention-free
[arXiv:2404.05892; hf]. 32L d_model=2560 d_ff=8960 vocab=65536.

Head layout (as in `repro`): upstream Finch uses 64-dim heads (40 heads at
d=2560); this config uses 32 heads x 80. The serving state is O(1) in
sequence length.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv=0,
    rwkv_heads=32,
    d_ff=8960,
    vocab=65536,
    norm="layer",
    mix_rank=32,
    decay_rank=64,
)
