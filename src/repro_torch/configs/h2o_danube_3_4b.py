"""h2o-danube-3-4b — llama+mistral mix, SWA [arXiv:2401.16818; unverified].

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, sliding window
4096. SWA makes decode cache window-bounded, so long_500k RUNS for this
arch (ring-buffer cache of 4096).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv=8,
    d_ff=10240,
    vocab=32000,
    window=4096,
    rope_theta=10000.0,
)
