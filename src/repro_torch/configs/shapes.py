"""Assigned input-shape set (identical for all 10 LM-family archs).

The port's copy of `repro.configs.shapes`, with the same names and numbers.
``decode_*`` / ``long_*`` run ``serve_step`` (one new token against a
seq_len-deep cache), not ``train_step``; ``long_500k`` only runs for
sub-quadratic architectures (SSM / hybrid / SWA) — the skip matrix lives
in `repro_torch.configs.registry`.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

SHAPE_NAMES = tuple(SHAPES)
