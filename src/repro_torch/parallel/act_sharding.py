"""Mesh context and the sequence-parallel hooks for model code.

The port of `repro.parallel.act_sharding`, with its signature and rules.
``use_activation_sharding(mesh, enabled=..., sp=..., moe_shardmap=...,
bf16_silu=..., moe_ep2d=...)`` makes the mesh visible to model code
without threading it through every call:

  * ``current_mesh()`` / ``get_ctx()`` let the MoE layer pick its
    expert-parallel dispatch path (`repro_torch.models.moe`: each model
    rank's local experts + one psum over "model", or the cross-pod path);
  * ``ctx.bf16_silu`` makes `repro_torch.models.common.swiglu` compute SiLU
    in the activation dtype with `repro`'s roundings (a bf16 activation
    then takes the fused kernel F1, `repro_torch.kernels.swiglu`);
  * ``ctx.sp`` (sequence parallelism; ``sp`` defaults to ``enabled``)
    turns on ``maybe_shard_hidden`` / ``maybe_gather_hidden``, called where
    `repro` calls them: the residual stream [B, S, d] between blocks is
    split along S over "model" (`shard_spec`), and a block's compute
    consumers gather it back first (dim 1 whole again), Megatron-SP's
    discipline.

In `repro` the two hooks constrain XLA's layout. A constraint never changes
a value, and the port's mesh is driven by one process with no partitioner
to instruct, so here they are identity `torch.autograd.Function`s (a view,
never a copy) that act only while a `repro_torch.parallel.cost_count`
counter counts on the thread: there they split and gather the counted
per-rank tensors and book the collectives that Megatron-SP's plan issues
(`CostCounter.split_seq` / `gather_seq`). Anywhere else they return their
input.

With no context active models stay mesh-agnostic (single-device runs).
The context is thread-local, as in `repro`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import torch

from repro_torch.parallel.sharding import dp_axes as dp_axes_of

_STATE = threading.local()


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    mesh: object
    sp: bool = False             # sequence-parallel residual stream
    moe_shardmap: bool = True    # expert-parallel MoE dispatch
    bf16_silu: bool = False      # SiLU in the activation dtype (F1 on a bf16 card run)
    moe_ep2d: bool = False       # cross-pod EP (experts over pod x model)


def get_ctx() -> MeshCtx | None:
    return getattr(_STATE, "ctx", None)


def current_mesh():
    ctx = get_ctx()
    return ctx.mesh if ctx else None


@contextlib.contextmanager
def use_activation_sharding(mesh, *, enabled: bool = True, sp: bool | None = None,
                            moe_shardmap: bool = True, bf16_silu: bool = False,
                            moe_ep2d: bool = False):
    """Activate a `MeshCtx` over ``mesh`` (an `LMMesh`) for the block on
    this thread; ``mesh=None`` clears any context for it. ``sp`` defaults
    to ``enabled``, as in `repro`."""
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = None if mesh is None else MeshCtx(
        mesh=mesh, sp=bool(enabled if sp is None else sp), moe_shardmap=moe_shardmap,
        bf16_silu=bf16_silu, moe_ep2d=moe_ep2d)
    try:
        yield
    finally:
        _STATE.ctx = prev


def shard_spec(shape, mesh) -> tuple:
    """`repro`'s sequence-parallel layout of a [B, S, ...] (or [B, S])
    activation: dim 0 over the data axes where the batch divides by them,
    dim 1 over "model" where S divides by it; one entry a dim."""
    dp = dp_axes_of(mesh)
    dsz = math.prod(mesh.shape[a] for a in dp)
    spec = [None] * len(shape)
    if shape[0] % dsz == 0:
        spec[0] = dp
    if len(shape) >= 2 and shape[1] % int(mesh.shape.get("model", 1)) == 0:
        spec[1] = "model"
    return tuple(spec)


def _counting():
    """The counter counting on this thread while the context's ``sp`` is
    on, else None."""
    ctx = get_ctx()
    if ctx is None or not ctx.sp:
        return None
    from repro_torch.parallel import cost_count

    return cost_count.active()


class _Shard(torch.autograd.Function):
    """Identity; the counted residual stream is split along S from here, and
    so is its gradient (a partial sum arriving here is reduce-scattered)."""

    @staticmethod
    def forward(ctx, x, counter, spec):
        ctx.counter, ctx.spec = counter, spec
        y = x.view_as(x)
        counter.split_seq(y, spec)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.view_as(g)
        ctx.counter.split_seq(g, ctx.spec)
        return g, None, None


class _Gather(torch.autograd.Function):
    """Identity; a split stream is all-gathered along S here, and in backward
    the gradient, a partial sum of the consumers' products, is
    reduce-scattered back into the split."""

    @staticmethod
    def forward(ctx, x, counter, spec):
        ctx.counter, ctx.spec = counter, spec
        y = x.view_as(x)
        ctx.was_split = counter.gather_seq(y, spec)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.view_as(g)
        if ctx.was_split:
            ctx.counter.split_seq(g, ctx.spec)
        return g, None, None


def maybe_shard_hidden(x: torch.Tensor) -> torch.Tensor:
    """``x`` [B, S, d] in the sequence-parallel layout (`shard_spec`): an
    identity, counted as a split while a counter counts and ``ctx.sp``."""
    counter = _counting()
    if counter is None:
        return x
    return _Shard.apply(x, counter, shard_spec(tuple(x.shape), get_ctx().mesh))


def maybe_gather_hidden(x: torch.Tensor) -> torch.Tensor:
    """``x`` [B, S, d] with S whole (`shard_spec` without its dim-1
    split), Megatron-SP's ``g`` all-gather before attention or the FFN: an
    identity, counted while a counter counts and ``ctx.sp``."""
    counter = _counting()
    if counter is None:
        return x
    return _Gather.apply(x, counter, shard_spec(tuple(x.shape), get_ctx().mesh))


__all__ = ["MeshCtx", "get_ctx", "current_mesh", "use_activation_sharding", "dp_axes_of",
           "shard_spec", "maybe_shard_hidden", "maybe_gather_hidden"]
