"""Revolver: the paper's partitioning superstep (Section IV-D, steps 1-9).

The port of `repro.core.revolver`: a **rule module** contributing Revolver's
per-block local rule, its config/state and its warm-start path; the
schedules (sequential, sharded, halo, async) live in
`repro_torch.core.engine`.

Per chunk, the nine steps of Section IV-D:
  1. LA action selection (roulette wheel == Gumbel-max categorical sampling)
  2. migration probability  p_mig(l) = clip((C - b(l)) / m(l), 0, 1)
  3. normalized LP scores (eq. 10) and lambda(v) = argmax_l score(v,l)
  4. gated migration (action != label and U(0,1) < p_mig(action))
  5. weight accumulation from neighbors' lambda (eq. 13)
  6. mean-split reinforcement signals + per-half normalization
  7. weighted-LA probability update (eqs. 8/9)
  8. exact load update (the chunk's migrations are applied immediately)
  9. convergence score accumulation (mean best LP score)

Steps 3+5 run through the fused edge-phase kernel (K1) and step 7 through
the LA-update kernel (K2) on CUDA tensors; CPU tensors take their plain
versions. There is no knob between the two (`repro`'s ``hist_impl`` /
``la_impl`` are gone): the device decides.

Random draws: per block the rule draws Gumbel noise [bv, k] (the action is
``argmax(log(clip(probs, 1e-30, 1)) + gumbel)``, which is what
``jax.random.categorical`` computes) and a uniform [bv], both from the
state's `torch.Generator`, with Gumbel as ``-log(-log(U))``, ``U`` in
``[tiny, 1)`` as in JAX. The engine's ``draws`` hook replaces both with
externally supplied values, which is how the tests replay `repro`'s
threefry draws.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.core import engine
from repro_torch.core.device_graph import CAPACITY_MODES, DeviceGraph
from repro_torch.core.la import split_weights_and_signals
from repro_torch.core.lp import revolver_scores
from repro_torch.core.metrics import bin_sums, moved_sums
from repro_torch.core.registry import register
from repro_torch.core.spinner import check_schedule

CHUNK_SCHEDULES = ("sequential", "sharded", "halo", "async")

# valid values per config knob
_VALID_CHOICES = {
    "weight_mode": ("self_lambda", "neighbor_lambda"),
    "capacity_mode": CAPACITY_MODES,
}
_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class RevolverConfig:
    """Hyper-parameters; defaults match Section V-F of the paper."""

    k: int
    alpha: float = 1.0            # LA reward rate
    beta: float = 0.1             # LA penalty rate
    epsilon: float = 0.05         # imbalance ratio
    max_steps: int = 290
    patience: int = 5             # consecutive non-improving steps to halt
    theta: float = 0.001          # min score improvement
    capacity_mode: str = "spinner"  # see device_graph.capacity
    renorm: bool = True           # simplex re-projection after eqs. (8)/(9)
    # eq. (13) ambiguity (DESIGN.md §10): which W slot a neighbor u reinforces.
    #   "self_lambda":     the literal LHS w(v, lambda(v)).
    #   "neighbor_lambda": slot lambda(u).
    weight_mode: str = "self_lambda"
    # superstep execution schedule (`repro_torch.core.engine`):
    #   "sequential": one device, the block loop of DESIGN.md §3;
    #   "sharded":    the Jacobi superstep over a BlocksMesh — each shard
    #                 scans its own blocks, the per-vertex fields are
    #                 gathered and the load deltas merged once a superstep;
    #   "halo":       "sharded" with the full gather replaced by the
    #                 layout's precomputed exchange (exact);
    #   "async":      "halo" with the exchange overlapped onto the interior
    #                 block scan; staleness_bound=0 is bit-identical to it.
    chunk_schedule: str = "sequential"
    # supersteps a shard may run against a stale halo tail before the
    # runner refreshes it ("async" only; 0 = refresh every superstep)
    staleness_bound: int = 0

    def __post_init__(self):
        for name, valid in _VALID_CHOICES.items():
            value = getattr(self, name)
            if value not in valid:
                raise ValueError(
                    f"RevolverConfig.{name}={value!r} is not one of {valid}")
        check_schedule("RevolverConfig", self.chunk_schedule, CHUNK_SCHEDULES,
                       self.staleness_bound)


class RevolverState(NamedTuple):
    labels: torch.Tensor   # [n_pad] int32 current partition per vertex
    lam: torch.Tensor      # [n_pad] int32 latest argmax-score label (lambda)
    probs: torch.Tensor    # [n_blocks, block_v, k] f32 LA probability vectors
    loads: torch.Tensor    # [k] f32 b(l)
    gen: torch.Generator   # on the state's device; advanced in place
    step: int
    score: torch.Tensor    # 0-dim f32 mean best LP score (convergence metric)


def make_generator(seed: int, device) -> torch.Generator:
    """A `torch.Generator` on ``device`` seeded with ``seed``. CPU and CUDA
    generators give different streams from one seed, so a fixed seed
    reproduces a run per device type."""
    return torch.Generator(device=device).manual_seed(seed)


def revolver_init(dg: DeviceGraph, cfg: RevolverConfig,
                  gen: torch.Generator) -> RevolverState:
    """Random initial labels; uniform 1/k LA probabilities (Section IV-C)."""
    labels = torch.randint(0, cfg.k, (dg.n_pad,), generator=gen,
                           dtype=torch.int32, device=dg.device)
    labels = torch.where(dg.vmask, labels, 0)
    loads = engine.loads_from_labels(dg, cfg.k, labels)
    probs = torch.full((dg.n_blocks, dg.block_v, cfg.k), 1.0 / cfg.k,
                       dtype=torch.float32, device=dg.device)
    return RevolverState(
        labels=labels,
        lam=labels.clone(),     # separate buffers: both are updated in place
        probs=probs,
        loads=loads,
        gen=gen,
        step=0,
        score=torch.zeros((), dtype=torch.float32, device=dg.device),
    )


def revolver_init_from_labels(
    dg: DeviceGraph,
    cfg: RevolverConfig,
    gen: torch.Generator,
    labels,
    probs=None,
    prob_sharpen: float = 0.0,
) -> RevolverState:
    """Warm-start state from a previous assignment.

    `labels` carries the partition of up to `len(labels)` surviving vertices
    (clipped to [0, k)); vertices beyond it draw a random label, exactly
    like a cold `revolver_init` would. `probs` optionally carries the LA
    probability tensor of a previous state ([n_blocks', block_v', k]);
    surviving vertices keep their automata, new vertices start at the
    uniform 1/k. Loads are recomputed from the degree vector. Both are
    indexed by original vertex id (row v = vertex v); on a block-permuted
    sharded layout they are scattered to each vertex's storage position.

    `prob_sharpen` in [0, 1) blends every automaton toward a one-hot on its
    carried label: p <- (1-s) p + s onehot(label).
    """
    if not 0.0 <= prob_sharpen < 1.0:
        raise ValueError(f"prob_sharpen must be in [0, 1), got {prob_sharpen}")
    lab = engine.warm_labels(dg, cfg.k, gen, labels)
    loads = engine.loads_from_labels(dg, cfg.k, lab)

    flat = torch.full((dg.n_pad, cfg.k), 1.0 / cfg.k, dtype=torch.float32,
                      device=dg.device)
    if probs is not None:
        p = torch.as_tensor(probs).to(dg.device, torch.float32)
        if p.shape[-1] != cfg.k:
            raise ValueError(
                f"carried probs have k={p.shape[-1]}, config expects k={cfg.k}")
        p = p.reshape(-1, cfg.k)
        p_keep = min(int(p.shape[0]), dg.n_pad)
        o2s = getattr(dg, "o2s_t", None)
        if o2s is None:
            flat[:p_keep] = p[:p_keep]
        else:   # carried rows are in original order: scatter to storage rows
            flat[o2s[:p_keep]] = p[:p_keep]
    if prob_sharpen > 0.0:
        onehot = torch.nn.functional.one_hot(lab.long(), cfg.k).to(torch.float32)
        flat = (1.0 - prob_sharpen) * flat + prob_sharpen * onehot
    return RevolverState(
        labels=lab,
        lam=lab.clone(),
        probs=flat.reshape(dg.n_blocks, dg.block_v, cfg.k).contiguous(),
        loads=loads,
        gen=gen,
        step=0,
        score=torch.zeros((), dtype=torch.float32, device=dg.device),
    )


def _draw(ctx: engine.ChunkContext, gen: torch.Generator, bv: int, k: int,
          device: torch.device):
    """This block's (gumbel [bv, k], uniform [bv]) — replayed through the
    engine's hook when one is set, else drawn from the state's generator."""
    if ctx.draws is not None:
        gumbel, uniform = ctx.draws(ctx.step, ctx.blk_idx)
        return (torch.as_tensor(gumbel).to(device, torch.float32),
                torch.as_tensor(uniform).to(device, torch.float32))
    u = torch.rand((bv, k), generator=gen, device=device).clamp_min_(_TINY)
    gumbel = -torch.log(-torch.log(u))
    uniform = torch.rand((bv,), generator=gen, device=device)
    return gumbel, uniform


def _revolver_chunk_rule(cfg: RevolverConfig, ctx: engine.ChunkContext,
                         vert, block, loads, cap, gen) -> engine.ChunkUpdate:
    """The nine steps of Section IV-D for one asynchronous chunk.

    `vert` holds the per-vertex tensors (labels + lambda, fresh with every
    earlier chunk's updates); `block` this chunk's LA probability tile. The
    rule returns the chunk's new label/lambda slices, its new probability
    tile, the updated loads and its score contribution; it writes nothing
    itself.
    """
    # imported here: the kernel modules build on core.lp / core.la, so a
    # module-level import would cycle through this package's __init__
    from repro_torch.kernels import ops

    labels, lam = vert["labels"], vert["lam"]
    probs = block["probs"]
    bv, k = probs.shape
    gumbel, u = _draw(ctx, gen, bv, k, probs.device)
    # a view: the engine writes this block's slices only after the rule
    cur = labels[ctx.v0:ctx.v0 + bv]

    # -- 1. LA action selection (roulette wheel) -----------------------------
    logits = torch.log(torch.clamp(probs, 1e-30, 1.0))
    action = torch.argmax(logits + gumbel, dim=-1).to(torch.int32)
    action = torch.where(ctx.vmask, action, cur)

    # -- 2. migration probability per partition ------------------------------
    wants = (action != cur) & ctx.vmask
    # m(l): integer degree sums, taken in int64 (order-independent)
    demand = bin_sums(action, ctx.deg * wants, k)
    remaining = cap - loads                                                # r(l)
    p_mig = torch.where(
        demand > 0,
        torch.clamp(remaining / torch.clamp_min(demand, 1e-9), 0.0, 1.0),
        1.0,
    )

    # -- 3. + 5. edge phase: LP-score histogram + eq.-13 accumulation --------
    # one fused slab pass (K1); for self_lambda the second output is the
    # per-row (A, N) packing, finished below once lambda(v) exists
    feasible = (p_mig > 0).to(torch.float32)
    with obs.annotate("edge-phase", kernel="fused_edge_phase"):
        hist, w_acc = ops.fused_edge_phase(
            ctx.e_dst[None], ctx.e_row[None], ctx.e_w[None], labels, lam,
            action[None], feasible[None], row_ptr=ctx.row_ptr[None],
            spans=ctx.spans, block_v=bv, k=k, weight_mode=cfg.weight_mode)
    hist, w_acc = hist[0], w_acc[0]

    scores = revolver_scores(hist, ctx.inv_wsum, loads, cap)
    lam_chunk = torch.argmax(scores, dim=-1).to(torch.int32)
    best = torch.max(scores, dim=-1).values
    score = engine.score_sum(best, ctx.vmask)

    # -- 4. gated migration ---------------------------------------------------
    migrate = wants & (u < p_mig[action.long()])
    new_lbl = torch.where(migrate, action, cur)

    # -- 8. exact load update (visible to the next chunk) --------------------
    dmig = ctx.deg * migrate
    loads = loads + moved_sums(cur, action, dmig, k)

    # -- 5. finish the eq. (13) weight accumulation ----------------------------
    if cfg.weight_mode == "self_lambda":
        # every edge of row v lands in slot lambda(v); feasibility is a
        # per-row scalar
        contrib = w_acc[:, 0] + torch.where(
            p_mig[lam_chunk.long()] > 0, w_acc[:, 1], 0.0)
        w_raw = torch.nn.functional.one_hot(
            lam_chunk.long(), k).to(torch.float32) * contrib[:, None]
    else:
        w_raw = w_acc                            # finished in-kernel

    # -- 6./7. reinforcement signals + weighted LA update ---------------------
    w_norm, r = split_weights_and_signals(w_raw)
    with obs.annotate("la-update", kernel="la_update"):
        new_probs = ops.la_update(probs, w_norm, r, cfg.alpha, cfg.beta,
                                  renorm=cfg.renorm)

    return engine.ChunkUpdate(
        vert={"labels": new_lbl, "lam": lam_chunk},
        block={"probs": new_probs},
        loads=loads,
        score=score,
    )


REVOLVER = register(engine.Algorithm(
    name="revolver",
    config_cls=RevolverConfig,
    state_cls=RevolverState,
    kind="chunk",
    vertex_fields=("labels", "lam"),
    wire_int8_fields=("labels", "lam"),   # both in [0, k)
    block_fields=("probs",),
    init=revolver_init,
    init_from_labels=revolver_init_from_labels,
    supports_probs=True,
    chunk_rule=_revolver_chunk_rule,
))


def revolver_superstep(dg: DeviceGraph, cfg: RevolverConfig,
                       state: RevolverState, *, draws=None) -> RevolverState:
    """One full superstep over all chunks (see `engine.superstep`).

    The state's labels / lam / probs / loads tensors are updated **in
    place**, and its generator advanced; the returned state carries the
    next step and the new score. ``draws`` is the tests' replay hook:
    ``(step, blk_idx) -> (gumbel [block_v, k], uniform [block_v])``.
    """
    return engine.superstep(REVOLVER, dg, cfg, state, draws=draws)
