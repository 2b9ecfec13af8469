"""Serving engine of the port (batched prefill + decode)."""
from repro_torch.serve.engine import Engine, GenerationResult, cache_rows

__all__ = ["Engine", "GenerationResult", "cache_rows"]
