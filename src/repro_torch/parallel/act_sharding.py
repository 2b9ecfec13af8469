"""Mesh context for model code.

The port of `repro.parallel.act_sharding`.
``use_activation_sharding(mesh, moe_shardmap=..., moe_ep2d=...)`` makes the
mesh visible to model code without threading it through every call:
``current_mesh()`` / ``get_ctx()`` let the MoE layer pick its
expert-parallel dispatch path (`repro_torch.models.moe`: each model rank's
local experts + one psum over "model", or the cross-pod path).

`repro`'s ``enabled`` / ``sp`` switches and its ``maybe_shard_hidden`` /
``maybe_gather_hidden`` hooks constrain the residual stream's layout for
XLA's SPMD partitioner; a constraint never changes a value, and the port's
mesh is driven by one process with no partitioner to instruct, so they
have no counterpart. Nor has ``bf16_silu`` (SiLU in the activation dtype),
a perf knob no path of the port sets: SiLU runs in f32.

With no context active models stay mesh-agnostic (single-device runs).
The context is thread-local, as in `repro`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

from repro_torch.parallel.sharding import dp_axes as dp_axes_of

_STATE = threading.local()


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    mesh: object
    moe_shardmap: bool = True    # expert-parallel MoE dispatch
    moe_ep2d: bool = False       # cross-pod EP (experts over pod x model)


def get_ctx() -> MeshCtx | None:
    return getattr(_STATE, "ctx", None)


def current_mesh():
    ctx = get_ctx()
    return ctx.mesh if ctx else None


@contextlib.contextmanager
def use_activation_sharding(mesh, *, moe_shardmap: bool = True, moe_ep2d: bool = False):
    """Activate a `MeshCtx` over ``mesh`` (an `LMMesh`) for the block on
    this thread; ``mesh=None`` clears any context for it."""
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = None if mesh is None else MeshCtx(mesh=mesh, moe_shardmap=moe_shardmap,
                                                   moe_ep2d=moe_ep2d)
    try:
        yield
    finally:
        _STATE.ctx = prev


__all__ = ["MeshCtx", "get_ctx", "current_mesh", "use_activation_sharding", "dp_axes_of"]
