"""whisper-base — enc-dec, conv frontend (stub) [arXiv:2212.04356;
unverified]. 6L(enc)+6L(dec) d_model=512 8H (MHA) d_ff=2048 vocab=51865.

The mel/conv frontend is a STUB: the caller passes 1500 precomputed
frame embeddings per example (``batch["frontend"]``). Shape cells apply
to the DECODER sequence. Pure full attention: long_500k skipped. (The learned decoder position
table is sized for the 32k cells — far beyond the real 448 — which is a
consequence of the assigned backbone x shape grid, not of Whisper.)
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    n_enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv=8,
    d_ff=2048,
    vocab=51865,
    norm="layer",
    norm_bias=True,
    mlp_kind="gelu",
    tie_embeddings=True,
    enc_seq=1500,
    max_pos=36864,
)
