"""Carry `repro`'s graph layout and rule states across into the port.

This system's "weights carried across": the tests run both packages from
the same state by handing the JAX objects over as numpy arrays, e.g.
``jax.device_get(dg._asdict())`` and ``jax.device_get(state._asdict())``.
Each state converter drops the JAX PRNG key and seeds the state's
generator with ``seed`` instead; arrays are copied.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device_graph import device_graph_from_numpy, resolve_device
from repro_torch.core.restream import RestreamState
from repro_torch.core.revolver import RevolverState, make_generator
from repro_torch.core.spinner import SpinnerState

__all__ = ["device_graph_from_numpy", "restream_state_from_numpy",
           "revolver_state_from_numpy", "spinner_state_from_numpy"]


def _fields(arrays: dict, device, seed: int, names: dict) -> dict:
    """``names`` ({field: numpy dtype}) as tensors on ``device``, plus the
    fields every state carries: a seeded generator, step and score."""
    dev = resolve_device(device)
    out = {f: torch.from_numpy(np.array(arrays[f], dtype=dt)).to(dev)
           for f, dt in names.items()}
    out["score"] = torch.from_numpy(
        np.array(arrays["score"], dtype=np.float32)).to(dev).reshape(())
    return dict(out, gen=make_generator(seed, dev), step=int(arrays["step"]))


def revolver_state_from_numpy(arrays: dict, device, seed: int) -> RevolverState:
    """A port `RevolverState` on ``device`` from `repro`'s `RevolverState`
    fields as numpy arrays."""
    return RevolverState(**_fields(arrays, device, seed, {
        "labels": np.int32, "lam": np.int32, "probs": np.float32,
        "loads": np.float32}))


def spinner_state_from_numpy(arrays: dict, device, seed: int) -> SpinnerState:
    """A port `SpinnerState` on ``device`` from `repro`'s `SpinnerState`
    fields as numpy arrays."""
    return SpinnerState(**_fields(arrays, device, seed, {
        "labels": np.int32, "loads": np.float32}))


def restream_state_from_numpy(arrays: dict, device, seed: int) -> RestreamState:
    """A port `RestreamState` on ``device`` from `repro`'s `RestreamState`
    fields as numpy arrays."""
    return RestreamState(**_fields(arrays, device, seed, {
        "labels": np.int32, "loads": np.float32, "rank": np.float32,
        "used": np.int32}))
