"""Spinner baseline (Martella et al., ICDE'17) — eqs. (3)-(5) of the paper.

The port of `repro.core.spinner`: synchronous BSP label propagation. All
vertices score all partitions against the *previous* step's labels and
loads, pick the argmax candidate (the current label wins ties), and migrate
gated by the remaining capacity.

A **shard rule**: one BSP step over the whole graph, which the engine runs
on one shard spanning every block (the sequential schedule; its collectives
are identities). The eq.-(3) histogram is one launch of the edge-histogram
kernel (K3) over all the slabs on CUDA tensors; CPU tensors take its plain
version.

Random draws: one uniform over the full ``[n_pad]`` per superstep, from the
state's `torch.Generator`. The engine's ``draws`` hook (``step -> [n_pad]
uniform``) replaces it, which is how the tests replay `repro`'s threefry
draws.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.core import engine
from repro_torch.core.device_graph import CAPACITY_MODES, DeviceGraph
from repro_torch.core.lp import spinner_scores
from repro_torch.core.metrics import bin_sums, moved_sums
from repro_torch.core.registry import register

# `repro`'s schedules of a shard rule ("async" splits a block scan, which
# a shard rule has not)
CHUNK_SCHEDULES = ("sequential", "sharded", "halo")


def check_schedule(cls_name: str, schedule: str, valid: tuple,
                   staleness_bound: int = 0) -> None:
    """`repro`'s checks of a config's ``chunk_schedule`` (one of
    ``valid``) and ``staleness_bound`` (an int >= 0, above 0 only for
    ``"async"``); ValueError otherwise."""
    if schedule not in valid:
        raise ValueError(f"{cls_name}.chunk_schedule={schedule!r} is not one "
                         f"of {valid}")
    if not isinstance(staleness_bound, int) or staleness_bound < 0:
        raise ValueError(f"{cls_name}.staleness_bound={staleness_bound!r} must be "
                         "an int >= 0")
    if staleness_bound > 0 and schedule != "async":
        raise ValueError("staleness_bound > 0 only applies to chunk_schedule='async' "
                         f"(got chunk_schedule={schedule!r})")


@dataclasses.dataclass(frozen=True)
class SpinnerConfig:
    k: int
    epsilon: float = 0.05
    max_steps: int = 290
    patience: int = 5
    theta: float = 0.001
    capacity_mode: str = "spinner"
    chunk_schedule: str = "sequential"

    def __post_init__(self):
        if self.capacity_mode not in CAPACITY_MODES:
            raise ValueError(
                f"SpinnerConfig.capacity_mode={self.capacity_mode!r} is not "
                f"one of {CAPACITY_MODES}")
        check_schedule("SpinnerConfig", self.chunk_schedule, CHUNK_SCHEDULES)


class SpinnerState(NamedTuple):
    labels: torch.Tensor   # [n_pad] int32
    loads: torch.Tensor    # [k] f32
    gen: torch.Generator   # on the state's device; advanced in place
    step: int
    score: torch.Tensor    # 0-dim f32


def spinner_init(dg: DeviceGraph, cfg: SpinnerConfig,
                 gen: torch.Generator) -> SpinnerState:
    """Random initial labels; loads recomputed from them."""
    labels = torch.randint(0, cfg.k, (dg.n_pad,), generator=gen,
                           dtype=torch.int32, device=dg.device)
    labels = torch.where(dg.vmask, labels, 0)
    return SpinnerState(labels, engine.loads_from_labels(dg, cfg.k, labels), gen,
                        0, torch.zeros((), dtype=torch.float32, device=dg.device))


def spinner_init_from_labels(dg: DeviceGraph, cfg: SpinnerConfig,
                             gen: torch.Generator, labels) -> SpinnerState:
    """Warm start from a previous assignment; new vertices draw random
    labels (`revolver_init_from_labels` minus the LA state)."""
    lab = engine.warm_labels(dg, cfg.k, gen, labels)
    return SpinnerState(lab, engine.loads_from_labels(dg, cfg.k, lab), gen,
                        0, torch.zeros((), dtype=torch.float32, device=dg.device))


def _spinner_shard_rule(cfg: SpinnerConfig, ctx: engine.ShardContext,
                        local, loads, cap, gen) -> engine.ShardUpdate:
    """One BSP step over the shard's slabs: eq.-(3) scores against the
    previous step's configuration, capacity-gated migration. The migration
    uniforms are drawn over the full [n_pad] and sliced, so the draw a
    vertex sees does not depend on the shard layout."""
    # imported here: the kernel modules build on core.lp, so a module-level
    # import would cycle through this package's __init__
    from repro_torch.kernels import ops

    labels = local["labels"]
    k = cfg.k
    if ctx.draws is not None:
        u_full = torch.as_tensor(ctx.draws(ctx.step)).to(labels.device, torch.float32)
    else:
        u_full = torch.rand((ctx.n_pad,), generator=gen, device=labels.device)
    labels_g = ctx.gather(labels)

    # eq. (3) histogram over every slab at once (K3, one launch, the
    # neighbors' labels gathered in-kernel)
    with obs.annotate("edge-phase", kernel="edge_histogram"):
        hist = ops.edge_histogram(ctx.blk_dst, ctx.blk_row, ctx.blk_w, labels=labels_g,
                                  row_ptr=ctx.blk_row_ptr, spans=ctx.blk_spans,
                                  block_v=ctx.block_v, k=k, integer_values=True)
    scores = spinner_scores(hist.view(ctx.local_n, k), ctx.inv_wsum, loads, cap)
    # prefer the current label on ties (Spinner keeps vertices in place)
    bump = torch.nn.functional.one_hot(labels.long(), k).to(scores.dtype) * 1e-6
    cand = torch.argmax(scores + bump, dim=-1).to(torch.int32)
    best = torch.max(scores, dim=-1).values

    wants = (cand != labels) & ctx.vmask
    # m(l) and the delta: integer degree sums, taken in int64
    # (order-independent)
    demand = ctx.psum(bin_sums(cand, ctx.deg * wants, k))
    remaining = cap - loads                                               # r(l)
    p_mig = torch.where(
        demand > 0,
        torch.clamp(remaining / torch.clamp_min(demand, 1e-9), 0.0, 1.0),
        1.0)
    u = u_full[ctx.v0:ctx.v0 + ctx.local_n]
    migrate = wants & (u < p_mig[cand.long()])
    new_labels = torch.where(migrate, cand, labels)

    dmig = ctx.deg * migrate
    delta = moved_sums(labels, cand, dmig, k)
    return engine.ShardUpdate(
        vert={"labels": new_labels},
        loads_delta=delta,
        score=engine.score_sum(best, ctx.vmask),
    )


SPINNER = register(engine.Algorithm(
    name="spinner",
    config_cls=SpinnerConfig,
    state_cls=SpinnerState,
    kind="shard",
    vertex_fields=("labels",),
    wire_int8_fields=("labels",),
    init=spinner_init,
    init_from_labels=spinner_init_from_labels,
    shard_rule=_spinner_shard_rule,
))


def spinner_superstep(dg: DeviceGraph, cfg: SpinnerConfig, state: SpinnerState,
                      *, draws=None) -> SpinnerState:
    """One BSP superstep (see `engine.superstep`): labels and loads are
    updated in place. ``draws`` is the tests' replay hook:
    ``step -> uniform [n_pad]``."""
    return engine.superstep(SPINNER, dg, cfg, state, draws=draws)
