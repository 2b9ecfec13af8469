"""Degree-prioritized restreaming partitioner (the third engine rule).

The port of `repro.core.restream`. Each vertex takes the FENNEL/LDG-style
greedy argmax ``score(v,l) = tau(v,l) - gamma * b(l)/C`` against the
freshest configuration (the chunk schedule's drifting view: earlier blocks'
moves are visible to later blocks, like earlier vertices in a stream).
High-degree vertices are re-decided first: superstep t re-decides only the
top ``(t+1)/priority_ramp`` degree quantile, so hubs settle while the tail
is still frozen. A per-vertex budget (``restream_budget``, 0 = unlimited)
caps how often any vertex is re-decided across the run; an exhausted
vertex keeps its label.

A **chunk rule**: per block, the histogram is one launch of the
edge-histogram kernel (K3) on CUDA tensors; CPU tensors take its plain
version. The degree ranks are a replicated state field, the spent budget a
per-block field.

Random draws: one uniform over the block's ``[block_v]`` per block, from the
state's `torch.Generator`; the engine's ``draws`` hook (``(step, blk_idx)
-> [block_v] uniform``) replaces it, which is how the tests replay
`repro`'s threefry draws.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import engine
from repro_torch.core.device_graph import CAPACITY_MODES, DeviceGraph, scalar_device
from repro_torch.core.lp import spinner_penalty, tau_term
from repro_torch.core.metrics import bin_sums, moved_sums
from repro_torch.core.registry import register
from repro_torch.core.spinner import check_schedule

# `repro`'s schedules of a chunk rule
CHUNK_SCHEDULES = ("sequential", "sharded", "halo", "async")


@dataclasses.dataclass(frozen=True)
class RestreamConfig:
    k: int
    epsilon: float = 0.05
    max_steps: int = 290
    patience: int = 5
    theta: float = 0.001
    capacity_mode: str = "spinner"
    chunk_schedule: str = "sequential"
    gamma: float = 1.0        # load-penalty weight in the greedy objective
    priority_ramp: int = 8    # supersteps over which the degree-ordered
                              # stream unlocks (1 = no prioritization)
    restream_budget: int = 32  # max re-decisions per vertex across the run
                               # (0 = unlimited)
    staleness_bound: int = 0   # "async": supersteps a stale halo tail may be
                               # reused (0 = refresh every superstep, exact)

    def __post_init__(self):
        if self.capacity_mode not in CAPACITY_MODES:
            raise ValueError(
                f"RestreamConfig.capacity_mode={self.capacity_mode!r} is not "
                f"one of {CAPACITY_MODES}")
        if self.priority_ramp < 1:
            raise ValueError(
                f"RestreamConfig.priority_ramp must be >= 1, got "
                f"{self.priority_ramp}")
        if self.restream_budget < 0:
            raise ValueError(
                f"RestreamConfig.restream_budget must be >= 0 "
                f"(0 = unlimited), got {self.restream_budget}")
        check_schedule("RestreamConfig", self.chunk_schedule, CHUNK_SCHEDULES,
                       self.staleness_bound)


class RestreamState(NamedTuple):
    labels: torch.Tensor   # [n_pad] int32
    loads: torch.Tensor    # [k] f32
    rank: torch.Tensor     # [n_pad] f32 degree-rank percentile (1 = hub);
                           # constant across supersteps (replicated)
    used: torch.Tensor     # [n_blocks, block_v] int32 re-decisions spent
    gen: torch.Generator   # on the state's device; advanced in place
    step: int
    score: torch.Tensor    # 0-dim f32


def _degree_ranks(dg: DeviceGraph) -> torch.Tensor:
    """Percentile of each vertex in the degree order (ties broken by id so
    the gate threshold moves through vertices one at a time)."""
    pos = torch.argsort(torch.argsort(dg.deg_out, stable=True), stable=True)
    return pos.to(torch.float32) / scalar_device(max(dg.n_pad - 1, 1), dg.device)


def _unlock(step: int, ramp: int) -> float:
    """The priority gate's threshold ``1 - (step + 1) / ramp`` as `repro`'s
    f32 arithmetic gives it: XLA compiles the division by the constant ramp
    into a multiply by its f32 reciprocal, fused with the subtraction (one
    rounding). The f64 expression here is exact before that rounding, so the
    threshold, and with it ``rank >= unlock`` at the boundary vertex, match
    `repro` for every ramp."""
    return float(np.float32(1.0 - (step + 1) * float(np.float32(1.0 / ramp))))


def _state(dg: DeviceGraph, cfg: RestreamConfig, gen: torch.Generator,
           labels: torch.Tensor) -> RestreamState:
    return RestreamState(
        labels=labels,
        loads=engine.loads_from_labels(dg, cfg.k, labels),
        rank=_degree_ranks(dg),
        used=torch.zeros((dg.n_blocks, dg.block_v), dtype=torch.int32,
                         device=dg.device),
        gen=gen,
        step=0,
        score=torch.zeros((), dtype=torch.float32, device=dg.device),
    )


def restream_init(dg: DeviceGraph, cfg: RestreamConfig,
                  gen: torch.Generator) -> RestreamState:
    """Random initial labels, fresh budgets."""
    labels = torch.randint(0, cfg.k, (dg.n_pad,), generator=gen,
                           dtype=torch.int32, device=dg.device)
    return _state(dg, cfg, gen, torch.where(dg.vmask, labels, 0))


def restream_init_from_labels(dg: DeviceGraph, cfg: RestreamConfig,
                              gen: torch.Generator, labels) -> RestreamState:
    """Warm start from a previous assignment: the carried partition is the
    stream being re-streamed, so the priority ramp replays hubs against it
    first."""
    return _state(dg, cfg, gen, engine.warm_labels(dg, cfg.k, gen, labels))


def _restream_chunk_rule(cfg: RestreamConfig, ctx: engine.ChunkContext,
                         vert, block, loads, cap, gen) -> engine.ChunkUpdate:
    """Greedy restream step for one block of the (time-unrolled) stream."""
    # imported here: the kernel modules build on core.lp, so a module-level
    # import would cycle through this package's __init__
    from repro_torch.kernels import ops

    labels = vert["labels"]
    bv = ctx.vmask.shape[0]
    k = cfg.k
    if ctx.draws is not None:
        u = torch.as_tensor(ctx.draws(ctx.step, ctx.blk_idx)).to(labels.device, torch.float32)
    else:
        u = torch.rand((bv,), generator=gen, device=labels.device)
    cur = labels[ctx.v0:ctx.v0 + bv]
    rank = ctx.repl["rank"][ctx.gv0:ctx.gv0 + bv]

    # degree-priority gate: superstep t re-decides only the top
    # (t+1)/priority_ramp degree quantile; after the ramp, everyone
    active = (rank >= _unlock(ctx.step, cfg.priority_ramp)) & ctx.vmask
    # per-vertex budget: a vertex re-decided restream_budget times keeps
    # its label (0 = unlimited)
    used = block["used"]
    if cfg.restream_budget:
        active &= used < cfg.restream_budget
    used = used + active.to(used.dtype)

    # greedy objective against the freshest configuration (K3, one launch,
    # the neighbors' labels gathered in-kernel)
    with obs.annotate("edge-phase", kernel="edge_histogram"):
        hist = ops.edge_histogram(ctx.e_dst[None], ctx.e_row[None], ctx.e_w[None],
                                  labels=labels, row_ptr=ctx.row_ptr[None], spans=ctx.spans,
                                  block_v=bv, k=k, integer_values=True)[0]
    scores = tau_term(hist, ctx.inv_wsum) \
        - cfg.gamma * spinner_penalty(loads, cap)[None, :]
    bump = torch.nn.functional.one_hot(cur.long(), k).to(scores.dtype) * 1e-6
    cand = torch.argmax(scores + bump, dim=-1).to(torch.int32)
    best = torch.max(scores, dim=-1).values

    # capacity-gated migration; m(l) and the load update are integer degree
    # sums, taken in int64 (order-independent)
    wants = (cand != cur) & active
    demand = bin_sums(cand, ctx.deg * wants, k)
    remaining = ctx.shared_headroom(cap, loads)
    p_mig = torch.where(
        demand > 0,
        torch.clamp(remaining / torch.clamp_min(demand, 1e-9), 0.0, 1.0),
        1.0)
    migrate = wants & (u < p_mig[cand.long()])
    new_lbl = torch.where(migrate, cand, cur)

    dmig = ctx.deg * migrate
    loads = loads + moved_sums(cur, cand, dmig, k)
    return engine.ChunkUpdate(
        vert={"labels": new_lbl},
        block={"used": used},
        loads=loads,
        score=engine.score_sum(best, ctx.vmask),
    )


RESTREAM = register(engine.Algorithm(
    name="restream",
    config_cls=RestreamConfig,
    state_cls=RestreamState,
    kind="chunk",
    vertex_fields=("labels",),
    wire_int8_fields=("labels",),
    block_fields=("used",),
    replicated_fields=("rank",),
    init=restream_init,
    init_from_labels=restream_init_from_labels,
    chunk_rule=_restream_chunk_rule,
))


def restream_superstep(dg: DeviceGraph, cfg: RestreamConfig,
                       state: RestreamState, *, draws=None) -> RestreamState:
    """One restream pass (see `engine.superstep`): labels, loads and the
    spent budgets are updated in place. ``draws`` is the tests' replay hook:
    ``(step, blk_idx) -> uniform [block_v]``."""
    return engine.superstep(RESTREAM, dg, cfg, state, draws=draws)
