"""Host-side convergence loop (Section IV-D step 9) and `run_partitioner`.

The port of `repro.core.runner` for the flat, sequential path: supersteps
run until the LP score fails to improve by `theta` for `patience`
consecutive steps (paper settings: theta=0.001, patience=5, max 290 steps).

Host/device synchronization: reading a CUDA score as a Python float blocks
on the device every superstep. The loop instead buffers the per-step score
tensors and fetches them with one ``.tolist()`` every `sync_every`
supersteps; with `track_history=True` the per-step `local_edges` /
`max_norm_load` tensors are buffered and drained on the same window.
Convergence is then detected up to `sync_every - 1` steps late;
`sync_every=1` (the default) is exactly synchronous.

``mode="vcycle"`` runs the multilevel V-cycle (`repro_torch.core.multilevel`).

What waits for later slices, and raises NotImplementedError when asked
for: mesh / halo / hub / assignment knobs and non-sequential schedules
(ROADMAP queue 1 item 9), tracing, checkpoints and the state guard
(item 8).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.device_graph import DeviceGraph, prepare_device_graph, resolve_device
from repro_torch.core.metrics import local_edges, max_normalized_load
from repro_torch.core.registry import StaticAlgorithm, get_algorithm
from repro_torch.core.revolver import make_generator
from repro_torch.graphs.csr import Graph

# run_partitioner keywords of `repro` that are not ported yet:
# name -> (the value that means "off", the ROADMAP queue item that ports it)
_UNPORTED = {
    "chunk_schedule": ("sequential", "queue 1 item 9 (multi-GPU schedules)"),
    "mesh": (None, "queue 1 item 9 (multi-GPU schedules)"),
    "assignment": ("contiguous", "queue 1 item 9 (multi-GPU schedules)"),
    "halo_threshold": (None, "queue 1 item 9 (multi-GPU schedules)"),
    "halo_granularity": ("auto", "queue 1 item 9 (multi-GPU schedules)"),
    "hub_replication": (False, "queue 1 item 9 (multi-GPU schedules)"),
    "hub_quantile": (0.0, "queue 1 item 9 (multi-GPU schedules)"),
    "hub_target_coverage": (None, "queue 1 item 9 (multi-GPU schedules)"),
    "staleness_bound": (0, "queue 1 item 9 (multi-GPU schedules)"),
    "trace": (None, "queue 1 item 8 (observability)"),
    "checkpoint_dir": (None, "queue 1 item 8 (checkpoints)"),
    "checkpoint_every": (0, "queue 1 item 8 (checkpoints)"),
    "resume": (False, "queue 1 item 8 (checkpoints)"),
    "keep_checkpoints": (2, "queue 1 item 8 (checkpoints)"),
    "guard": ("off", "queue 1 item 8 (state guards)"),
}


def reject_unported(kwargs: dict, unported: dict, where: str) -> None:
    """Pop every key of ``unported`` ({name: (off value, ROADMAP item)})
    from ``kwargs``; raise NotImplementedError for one not at its "off"
    value."""
    for name in sorted(set(kwargs) & set(unported)):
        off, item = unported[name]
        value = kwargs.pop(name)
        if value != off:
            raise NotImplementedError(
                f"{where}({name}={value!r}) is not ported yet; it comes with "
                f"ROADMAP {item}")


@dataclasses.dataclass
class PartitionResult:
    algo: str
    k: int
    labels: np.ndarray                 # [n] final partition per vertex
    steps: int
    converged: bool
    local_edges: float
    max_norm_load: float
    history: Dict[str, List[float]]
    wall_s: float
    probs: Optional[np.ndarray] = None  # [n_blocks, block_v, k] final LA state
                                        # (keep_probs=True only; feeds warm
                                        # restarts)
    vcycle: Optional[dict] = None       # mode="vcycle": level sizes, budgets,
                                        # steps per level, coarsening seconds


def run_convergence_loop(
    step_fn: Callable,
    state,
    *,
    max_steps: int,
    patience: int,
    theta: float,
    sync_every: int = 1,
    on_step=None,
    on_score=None,
    on_drain=None,
    prev_score: float = -np.inf,
    stall: int = 0,
):
    """Drive `step_fn` with the paper's score-stall halting (Section IV-D
    step 9): stop after `patience` consecutive steps whose score improves by
    less than `theta`. Scores are fetched in `sync_every`-sized windows (see
    module docstring).

    `on_step(state)` fires after every superstep; `on_score(float)` for
    every fetched score, in step order (including the steps past the
    detected convergence point within the window); `on_drain(state, steps,
    prev_score, stall)` once per fetched window, after its scores. It may
    return a dict with any of ``state`` / ``prev_score`` / ``stall`` to
    replace the loop's state (which also clears a convergence detected in
    that window).

    Returns (state, steps_executed, converged).
    """
    converged = False
    steps = 0
    pending: list = []
    for step in range(max_steps):
        state = step_fn(state)
        steps = step + 1
        pending.append(state.score)
        if on_step is not None:
            on_step(state)
        if len(pending) < sync_every and steps < max_steps:
            continue
        scores = torch.stack(pending).tolist()     # one host sync per window
        for score in scores:
            if on_score is not None:
                on_score(score)
            if converged:
                continue  # window tail past the detection point
            if score - prev_score < theta:
                stall += 1
                if stall >= patience:
                    converged = True
            else:
                stall = 0
            prev_score = score
        pending = []
        if on_drain is not None:
            replace = on_drain(state, steps, prev_score, stall)
            if replace is not None:
                state = replace.get("state", state)
                prev_score = replace.get("prev_score", prev_score)
                stall = replace.get("stall", stall)
                converged = False
        if converged:
            break
    return state, steps, converged


def _make_cfg(cls, k: int, max_steps: Optional[int], cfg_kwargs: dict):
    """Build an algorithm config, rejecting unknown keys loudly."""
    valid = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(cfg_kwargs) - valid)
    if unknown:
        raise TypeError(
            f"unknown config kwargs for {cls.__name__}: {unknown}; "
            f"valid keys: {sorted(valid - {'k'})}"
        )
    cfg = cls(k=k, **cfg_kwargs)
    if max_steps is not None:
        cfg = dataclasses.replace(cfg, max_steps=max_steps)
    return cfg


def _run_static(algorithm: StaticAlgorithm, graph: Graph, k: int,
                dg: DeviceGraph, t0: float) -> PartitionResult:
    """A static baseline: no supersteps; the metrics on the padded labels,
    as `repro` computes them."""
    labels = torch.zeros((dg.n_pad,), dtype=torch.int32, device=dg.device)
    labels[:graph.n] = algorithm.partition(graph.n, k, dg.device)
    le = float(local_edges(labels, dg.dir_src, dg.dir_dst))
    ml = float(max_normalized_load(labels[:graph.n], dg.deg_out[:graph.n], k))
    return PartitionResult(
        algo=algorithm.name, k=k, labels=labels[:graph.n].cpu().numpy(),
        steps=0, converged=True, local_edges=le, max_norm_load=ml,
        history={"local_edges": [le], "max_norm_load": [ml], "score": [0.0]},
        wall_s=time.time() - t0)


def _check_vcycle_args(algo, static, cfg_kwargs, dg, init_labels, init_probs,
                       init_sharpen, draws) -> None:
    """`repro`'s argument errors of ``mode="vcycle"``."""
    if static:
        raise TypeError(
            f"{algo!r} runs no supersteps; mode='vcycle' refines through "
            "warm starts")
    if (cfg_kwargs.get("checkpoint_dir") is not None or cfg_kwargs.get("resume", False)
            or cfg_kwargs.get("guard", "off") != "off"):
        raise ValueError(
            "mode='vcycle' is incompatible with checkpointing/resume/"
            "guard; its per-level runs are short — checkpoint a flat "
            "refinement from init_labels instead")
    if init_labels is not None or init_probs is not None or init_sharpen:
        raise ValueError(
            "mode='vcycle' derives its warm starts from the coarse "
            "levels; init_labels/init_probs/init_sharpen cannot be "
            "passed in")
    if dg is not None or draws is not None:
        raise ValueError(
            "mode='vcycle' builds its own per-level device layouts and "
            "draws; dg=/draws= cannot be passed in")


def run_partitioner(
    algo: str,
    graph: Graph,
    k: int,
    *,
    seed: int = 0,
    n_blocks: int = 8,
    max_steps: Optional[int] = None,
    track_history: bool = True,
    dg: Optional[DeviceGraph] = None,
    sync_every: int = 1,
    init_labels: Optional[np.ndarray] = None,
    init_probs: Optional[np.ndarray] = None,
    init_sharpen: float = 0.0,
    keep_probs: bool = False,
    device="cuda",
    draws=None,
    mode: str = "flat",
    coarse_n: Optional[int] = None,
    level_decay: Optional[float] = None,
    vcycle_sharpen: Optional[float] = None,
    **cfg_kwargs,
) -> PartitionResult:
    """Partition `graph` into `k` parts with the named algorithm, on
    ``device`` (default CUDA; raises when it is unavailable — pass
    ``device="cpu"`` for the plain PyTorch path).

    The flat, sequential path of `repro.core.runner.run_partitioner`: extra
    kwargs flow into the algorithm's config dataclass (unknown keys raise
    TypeError; `repro` options that are not ported yet raise
    NotImplementedError unless they carry their "off" value). `dg` reuses a
    prepared layout on the same device. `sync_every` batches device->host
    score fetches. `init_labels` (and `init_probs` / `init_sharpen`)
    warm-start the state from a previous assignment; `keep_probs=True`
    returns the final LA probability tensor. `draws` replays external random
    draws into every superstep (tests only; each rule module states its
    hook's signature). A fixed seed reproduces the labels bit for
    bit on one device type.

    The static baselines (``"hash"``, ``"range"``) run no supersteps: they
    take no config kwargs and no warm-start arguments (TypeError).

    ``mode="vcycle"`` runs the multilevel V-cycle
    (`repro_torch.core.multilevel`): coarsen by heavy-edge matching down to
    `coarse_n` vertices, partition the coarsest graph to score-stall
    convergence, then uncoarsen level by level with `init_from_labels` warm
    starts under shrinking per-level superstep budgets (the finest level is
    capped at `level_decay * max_steps`; probs-carrying rules sharpen the
    projected labels by `vcycle_sharpen`). It builds its own per-level
    layouts, so it is incompatible with a passed `dg`, warm-start args,
    checkpointing, the state guard and `draws`.
    """
    t0 = time.time()
    algorithm = get_algorithm(algo)
    static = isinstance(algorithm, StaticAlgorithm)
    # chunk_schedule is a config kwarg in `repro`, the other unported
    # options are run_partitioner keywords
    config_keys = set(cfg_kwargs) - (set(_UNPORTED) - {"chunk_schedule"})
    if static and config_keys:
        raise TypeError(f"{algo!r} runs no supersteps; it takes no config "
                        f"kwargs (got {sorted(config_keys)})")
    if mode not in ("flat", "vcycle"):
        raise ValueError(f"mode={mode!r} is not one of ('flat', 'vcycle')")
    if mode != "vcycle" and (coarse_n is not None or level_decay is not None
                             or vcycle_sharpen is not None):
        raise ValueError(
            "coarse_n/level_decay/vcycle_sharpen are only meaningful with "
            "mode='vcycle'")
    if mode == "vcycle":
        _check_vcycle_args(algo, static, cfg_kwargs, dg, init_labels,
                           init_probs, init_sharpen, draws)
    reject_unported(cfg_kwargs, _UNPORTED, "run_partitioner")
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    dev = resolve_device(device)
    if mode == "vcycle":
        from repro_torch.core import multilevel

        return multilevel.run_vcycle(
            algo, graph, k, seed=seed, n_blocks=n_blocks, max_steps=max_steps,
            track_history=track_history, sync_every=sync_every,
            keep_probs=keep_probs, device=dev, coarse_n=coarse_n,
            level_decay=level_decay, vcycle_sharpen=vcycle_sharpen,
            cfg_kwargs=cfg_kwargs)
    if not static:
        cfg = _make_cfg(algorithm.config_cls, k, max_steps, cfg_kwargs)
    elif init_labels is not None or init_probs is not None or init_sharpen:
        raise TypeError(f"{algo!r} is stateless; warm-start args are meaningless")
    if dg is None:
        dg = prepare_device_graph(graph, n_blocks=n_blocks, device=dev)
    elif dg.device.type != dev.type:
        raise ValueError(f"dg lives on {dg.device}, but device={device!r}")
    if static:
        return _run_static(algorithm, graph, k, dg, t0)

    if not algorithm.supports_probs and (init_probs is not None or init_sharpen):
        raise TypeError(
            f"{algo!r} has no LA state; init_probs/init_sharpen are meaningless")
    gen = make_generator(seed, dg.device)
    if init_labels is not None:
        if algorithm.init_from_labels is None:
            raise TypeError(f"{algo!r} does not support warm starts")
        if algorithm.supports_probs:
            state = algorithm.init_from_labels(dg, cfg, gen, init_labels,
                                               probs=init_probs,
                                               prob_sharpen=init_sharpen)
        else:
            state = algorithm.init_from_labels(dg, cfg, gen, init_labels)
    else:
        if init_probs is not None:
            raise TypeError("init_probs requires init_labels")
        if init_sharpen:
            raise TypeError("init_sharpen requires init_labels")
        state = algorithm.init(dg, cfg, gen)

    history: Dict[str, List[float]] = {"local_edges": [], "max_norm_load": [], "score": []}
    # per-step metric tensors stay on the device and are drained on the
    # same sync_every window as the scores
    pending_le: List[torch.Tensor] = []
    pending_ml: List[torch.Tensor] = []

    def step_fn(s):
        return engine.superstep(algorithm, dg, cfg, s, draws=draws)

    def on_step(s):
        pending_le.append(local_edges(s.labels, dg.dir_src, dg.dir_dst))
        pending_ml.append(max_normalized_load(s.labels, dg.deg_out, k))

    def on_drain(s, loop_steps, prev_score, stall):
        history["local_edges"].extend(torch.stack(pending_le).tolist())
        history["max_norm_load"].extend(torch.stack(pending_ml).tolist())
        pending_le.clear()
        pending_ml.clear()

    state, steps, converged = run_convergence_loop(
        step_fn, state,
        max_steps=cfg.max_steps, patience=cfg.patience, theta=cfg.theta,
        sync_every=sync_every,
        on_step=on_step if track_history else None,
        on_score=history["score"].append if track_history else None,
        on_drain=on_drain if track_history else None,
    )

    if track_history and history["local_edges"]:
        le, ml = history["local_edges"][-1], history["max_norm_load"][-1]
    else:
        le = float(local_edges(state.labels, dg.dir_src, dg.dir_dst))
        ml = float(max_normalized_load(state.labels, dg.deg_out, k))
    probs = None
    if keep_probs and algorithm.supports_probs:
        probs = state.probs.cpu().numpy()
    return PartitionResult(
        algo=algo, k=k, labels=state.labels[: graph.n].cpu().numpy(),
        steps=steps, converged=converged, local_edges=le, max_norm_load=ml,
        history=history, wall_s=time.time() - t0, probs=probs,
    )
