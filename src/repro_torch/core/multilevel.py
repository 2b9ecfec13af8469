"""Multilevel V-cycle: coarsen -> partition the coarsest -> uncoarsen.

The port of `repro.core.multilevel` (METIS-style multilevel partitioning
mapped onto the engine's machinery); ``run_partitioner(mode="vcycle")``
lands here:

  1. **Coarsen** (`build_level_stack`, numpy on the host): repeated
     heavy-edge matching + contraction (`repro_torch.graphs.csr`'s copies of
     `heavy_edge_matching` / `contract_graph`) down to a ``coarse_n``-vertex
     graph. Every level keeps the fine graph's balance semantics exactly —
     aggregated vertex weights with ``m`` pinned to the fine edge count, so
     the engine's capacity ``C = (1+eps)|E|/k`` prices coarse loads in
     fine-edge units. A level's eq.-(4) weights are sums of the fine
     weights: integers past 2, inside the span kernels' weight contract
     (`repro_torch.graphs.blocking`).
  2. **Coarse solve**: the registered superstep rule runs to score-stall
     convergence on the coarsest graph, through the port's
     `run_partitioner` on the same device (K1 and K2 for Revolver, K3 for
     Spinner and restream on CUDA).
  3. **Uncoarsen**: labels project through each level's fine->coarse vertex
     map and refine with the registry's ``init_from_labels`` warm start
     under a shrinking superstep budget (`level_budgets`); probs-carrying
     rules sharpen the carried labels into LA confidence
     (``vcycle_sharpen``).

The coarse levels run the sequential schedule on one device; the finest
level takes the caller's schedule, mesh, assignment, halo and hub knobs (its
layout laid out over the mesh by the runner), as in `repro`. With ``trace=``
the V-cycle records `repro`'s spans ("coarsen", "coarse-solve",
"uncoarsen-level-<l>", each level's run nested inside), the
``level_n_vertices`` counters and ``meta["vcycle"]``; the same level sizes,
budgets and steps per level, with each level's block count (from the
layout it built) and the host seconds of the coarsening, come back in
`PartitionResult.vcycle` whether traced or not.
"""
from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.device_graph import prepare_device_graph
from repro_torch.core.registry import get_algorithm
from repro_torch.graphs.csr import Graph, contract_graph, heavy_edge_matching

_log = logging.getLogger("repro_torch.core.multilevel")

DEFAULT_COARSE_N = 512
DEFAULT_LEVEL_DECAY = 0.12
DEFAULT_VCYCLE_SHARPEN = 0.8

# stop coarsening when a matching pass shrinks the level by less than this
# factor — degenerate families (stars, already-tiny graphs) would otherwise
# stack near-identical levels
_REDUCTION_STALL = 0.95
_MAX_LEVELS = 32


def build_level_stack(
    g: Graph, coarse_n: int, max_levels: int = _MAX_LEVELS,
) -> Tuple[List[Graph], List[np.ndarray]]:
    """Coarsen `g` by repeated heavy-edge matching down to ``coarse_n``.

    Returns ``(graphs, cmaps)`` with ``graphs[0] is g`` (finest first) and
    ``cmaps[i]`` mapping level-``i`` vertices to level-``i+1`` vertices, so
    ``len(cmaps) == len(graphs) - 1``. Stops early when a matching pass
    fails to shrink the level by at least ``1 - _REDUCTION_STALL`` (the
    degenerate 1-level case: the stack is just ``[g]``).
    """
    if coarse_n < 1:
        raise ValueError(f"coarse_n must be >= 1, got {coarse_n}")
    graphs: List[Graph] = [g]
    cmaps: List[np.ndarray] = []
    while graphs[-1].n > coarse_n and len(graphs) <= max_levels:
        cur = graphs[-1]
        cmap, n_coarse = heavy_edge_matching(cur)
        if n_coarse > cur.n * _REDUCTION_STALL:
            _log.info(
                "coarsening stalled at level %d (%d -> %d vertices); "
                "keeping a %d-level stack",
                len(graphs) - 1, cur.n, n_coarse, len(graphs))
            break
        coarse, _ = contract_graph(cur, cmap, n_coarse)
        graphs.append(coarse)
        cmaps.append(cmap)
    return graphs, cmaps


def level_budgets(max_steps: int, n_levels: int, level_decay: float,
                  patience: int) -> List[int]:
    """Per-level superstep caps, finest first.

    The coarsest level gets the full ``max_steps`` (its supersteps are
    cheap and it runs from a cold start); the finest gets
    ``level_decay * max_steps``, independent of stack depth. Intermediate
    levels interpolate geometrically between the two endpoints. Every cap
    is floored at ``patience + 3`` so the score-stall halt can still fire.
    """
    if n_levels == 1:
        return [max_steps]
    span = n_levels - 1
    budgets = [max(patience + 3,
                   int(round(max_steps * level_decay ** ((span - i) / span))))
               for i in range(n_levels)]
    budgets[-1] = max_steps
    return budgets


def run_vcycle(
    algo: str,
    graph: Graph,
    k: int,
    *,
    seed: int = 0,
    n_blocks: int = 8,
    max_steps: Optional[int] = None,
    track_history: bool = True,
    mesh=None,
    assignment="contiguous",
    halo_threshold: Optional[float] = None,
    halo_granularity: str = "auto",
    hub_replication: bool = False,
    hub_quantile: float = 0.0,
    hub_target_coverage: Optional[float] = None,
    sync_every: int = 1,
    keep_probs: bool = False,
    trace=None,
    device="cuda",
    coarse_n: Optional[int] = None,
    level_decay: Optional[float] = None,
    vcycle_sharpen: Optional[float] = None,
    cfg_kwargs: Optional[dict] = None,
):
    """Drive one V-cycle. Called by ``run_partitioner(mode="vcycle")``;
    returns the finest level's `PartitionResult` (its ``steps`` are the
    fine-level supersteps), with ``vcycle`` set to the level sizes, block
    counts, budgets, steps per level and coarsening seconds. The schedule
    knobs (``cfg_kwargs``' ``chunk_schedule`` and ``staleness_bound``,
    ``mesh``, ``assignment``, the halo and hub options) apply to the finest
    level only."""
    from repro_torch.core import runner  # lazy: runner imports us the same way

    cfg_kwargs = dict(cfg_kwargs or {})
    coarse_n = DEFAULT_COARSE_N if coarse_n is None else int(coarse_n)
    level_decay = (DEFAULT_LEVEL_DECAY if level_decay is None
                   else float(level_decay))
    vcycle_sharpen = (DEFAULT_VCYCLE_SHARPEN if vcycle_sharpen is None
                      else float(vcycle_sharpen))
    if coarse_n < k:
        raise ValueError(
            f"coarse_n={coarse_n} < k={k}: the coarsest graph could not "
            "hold one vertex per partition")
    if not 0.0 < level_decay <= 1.0:
        raise ValueError(
            f"level_decay must be in (0, 1], got {level_decay}")
    if not 0.0 <= vcycle_sharpen < 1.0:
        raise ValueError(
            f"vcycle_sharpen must be in [0, 1), got {vcycle_sharpen}")
    algorithm = get_algorithm(algo)
    if algorithm.init_from_labels is None:
        raise TypeError(
            f"{algo!r} does not support warm starts; mode='vcycle' refines "
            "projected labels through init_from_labels")
    cfg = runner._make_cfg(algorithm.config_cls, k, max_steps, cfg_kwargs)
    budget_base = cfg.max_steps
    patience = cfg.patience
    tracer = trace if trace is not None else obs.NULL_TRACER

    t = time.perf_counter()
    with tracer.span("coarsen", coarse_n=coarse_n, n=graph.n):
        graphs, cmaps = build_level_stack(graph, coarse_n)
    coarsen_s = time.perf_counter() - t
    n_levels = len(graphs)
    if tracer.enabled:
        for lvl, g in enumerate(graphs):
            tracer.counter("level_n_vertices", g.n, step=lvl)
    # schedule knobs apply to the finest level only; the coarse levels run
    # the sequential schedule
    coarse_cfg = {f: v for f, v in cfg_kwargs.items()
                  if f not in ("chunk_schedule", "staleness_bound")}
    common = dict(seed=seed, sync_every=sync_every, device=device, trace=trace)
    fine = dict(track_history=track_history, keep_probs=keep_probs, mesh=mesh,
                assignment=assignment, halo_granularity=halo_granularity,
                hub_replication=hub_replication, hub_quantile=hub_quantile,
                hub_target_coverage=hub_target_coverage, **cfg_kwargs)
    if halo_threshold is not None:
        fine["halo_threshold"] = halo_threshold
    n_shards = 1
    if cfg_kwargs.get("chunk_schedule", "sequential") != "sequential":
        if mesh is None:
            from repro_torch.launch.mesh import make_blocks_mesh

            mesh = fine["mesh"] = make_blocks_mesh(device=device)
        n_shards = mesh.n_shards
    level_blocks = {}

    def layout(lvl: int):
        # the finest level's layout is laid out over the mesh by the runner:
        # at least a block a shard, as `prepare_sharded_device_graph` asks
        nb = max(n_blocks, n_shards) if lvl == 0 else n_blocks
        dg = prepare_device_graph(graphs[lvl], n_blocks=nb, device=device)
        aligned = -(-dg.n_blocks // n_shards) * n_shards if lvl == 0 else dg.n_blocks
        level_blocks[lvl] = aligned
        return dg

    if n_levels == 1:
        # degenerate stack (graph already at/below coarse_n, or matching
        # stalled immediately): a V-cycle is just the flat run
        _log.info("graph has %d vertices (<= coarse_n=%d or matching "
                  "stalled); running flat", graph.n, coarse_n)
        res = runner.run_partitioner(algo, graph, k, max_steps=budget_base,
                                     dg=layout(0), **fine, **common)
        budgets = [budget_base]
    else:
        budgets = level_budgets(budget_base, n_levels, level_decay, patience)
        with tracer.span("coarse-solve", level=n_levels - 1, n=graphs[-1].n,
                         budget=budgets[-1]):
            res = runner.run_partitioner(algo, graphs[-1], k, max_steps=budgets[-1],
                                         dg=layout(n_levels - 1), track_history=False,
                                         **coarse_cfg, **common)
        steps = {n_levels - 1: res.steps}
        sharpen = vcycle_sharpen if algorithm.supports_probs else 0.0
        for lvl in range(n_levels - 2, -1, -1):
            projected = np.asarray(res.labels)[cmaps[lvl]]
            with tracer.span(f"uncoarsen-level-{lvl}", n=graphs[lvl].n,
                             budget=budgets[lvl]):
                res = runner.run_partitioner(
                    algo, graphs[lvl], k, max_steps=budgets[lvl], dg=layout(lvl),
                    init_labels=projected, init_sharpen=sharpen,
                    **(fine if lvl == 0 else dict(track_history=False, **coarse_cfg)),
                    **common)
            steps[lvl] = res.steps
    res.vcycle = {
        "level_n_vertices": [g.n for g in graphs],
        "level_n_blocks": [level_blocks[i] for i in range(n_levels)],
        "budgets": budgets,
        "steps_per_level": [res.steps] if n_levels == 1 else [steps[i] for i in range(n_levels)],
        "coarsen_s": coarsen_s,
    }
    if tracer.enabled and n_levels > 1:
        tracer.meta.setdefault("vcycle", []).append({
            "algo": algo, "k": k,
            "level_n_vertices": res.vcycle["level_n_vertices"],
            "budgets": budgets,
            "steps_per_level": res.vcycle["steps_per_level"],
        })
    return res
