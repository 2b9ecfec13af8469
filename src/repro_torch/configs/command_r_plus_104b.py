"""command-r-plus-104b — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01;
unverified]. 64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.

Cohere block structure: parallel attention+FFN from a single LayerNorm,
tied embeddings, scaled logits. Pure full attention: long_500k skipped.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv=8,
    d_ff=33792,
    vocab=256000,
    norm="layer",
    parallel_block=True,
    tie_embeddings=True,
    logit_scale=0.0625,
    rope_theta=75_000_000.0,
)
