"""Carry `repro`'s graph layout and Revolver state across into the port.

This system's "weights carried across": the tests run both packages from
the same state by handing the JAX objects over as numpy arrays, e.g.
``jax.device_get(dg._asdict())`` and ``jax.device_get(state._asdict())``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device_graph import device_graph_from_numpy, resolve_device
from repro_torch.core.revolver import RevolverState, make_generator

__all__ = ["device_graph_from_numpy", "revolver_state_from_numpy"]


def revolver_state_from_numpy(arrays: dict, device, seed: int) -> RevolverState:
    """A port `RevolverState` on ``device`` from `repro`'s `RevolverState`
    fields as numpy arrays. The JAX PRNG key is dropped; the state's
    generator is seeded with ``seed`` instead. Arrays are copied."""
    dev = resolve_device(device)

    def put(name, dtype):
        return torch.from_numpy(np.array(arrays[name], dtype=dtype)).to(dev)

    return RevolverState(
        labels=put("labels", np.int32),
        lam=put("lam", np.int32),
        probs=put("probs", np.float32),
        loads=put("loads", np.float32),
        gen=make_generator(seed, dev),
        step=int(arrays["step"]),
        score=put("score", np.float32).reshape(()),
    )
