"""Seed discipline: the counterpart of `repro.utils.prng`.

`repro` folds a string tag into a JAX PRNG key; the port draws from
`torch.Generator`s seeded by integers, so `fold_in_str` derives the
integer seed of a named stream from a parent seed. Nothing in the port
calls it, as nothing in `repro` calls its own: the trainer seeds its
generator from ``--seed`` and the data pipeline seeds numpy from (seed,
host, step), so a restored run regenerates its streams and no generator
state is checkpointed.
"""
from __future__ import annotations

import hashlib

import numpy as np


def fold_in_str(seed: int, name: str) -> int:
    """A 63-bit seed for the stream ``name`` under ``seed``:
    ``torch.Generator().manual_seed(fold_in_str(seed, "data"))``. `repro`'s
    tag (the first 4 bytes of the name's SHA-256) mixed with the seed by
    numpy's `SeedSequence`."""
    tag = int.from_bytes(hashlib.sha256(name.encode("utf-8")).digest()[:4], "little")
    return int(np.random.SeedSequence([seed, tag]).generate_state(1, np.uint64)[0] >> 1)

