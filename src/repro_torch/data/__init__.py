"""Deterministic synthetic data pipeline (numpy; bit-equal to `repro`'s)."""
from repro_torch.data.pipeline import DataConfig, PrefetchLoader, make_batch

__all__ = ["DataConfig", "PrefetchLoader", "make_batch"]
