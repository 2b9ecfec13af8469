"""Host-side convergence loop (Section IV-D step 9) and `run_partitioner`.

The port of `repro.core.runner` for the flat, sequential path: supersteps
run until the LP score fails to improve by `theta` for `patience`
consecutive steps (paper settings: theta=0.001, patience=5, max 290 steps).

Host/device synchronization: reading a CUDA score as a Python float blocks
on the device every superstep. The loop instead buffers the per-step score
tensors and fetches them with one `fetch` every `sync_every` supersteps;
with `track_history=True` the per-step `local_edges` / `max_norm_load`
tensors are buffered and drained on the same window, in one more `fetch`.
Convergence is then detected up to `sync_every - 1` steps late;
`sync_every=1` (the default) is exactly synchronous.

Crash safety and observability ride those windows (see `run_partitioner`):
tracing (`repro_torch.obs`), drain-window checkpoints and resume
(`repro_torch.checkpoint`), the state guard, and the fault-injection hook
(`repro_torch.faults`). With all of them on, a run issues exactly as many
blocking fetches as with them off.

``mode="vcycle"`` runs the multilevel V-cycle (`repro_torch.core.multilevel`).

``chunk_schedule="sharded" | "halo" | "async"`` (a config knob) runs the
superstep over a `BlocksMesh` (`repro_torch.launch.mesh`): the runner lays
the graph out over it (assignment, halo plan with hub replication, the
async schedule's interior-first order), records the plan's counters when
tracing, drives the async schedule's staleness bound, and returns labels
and probabilities in original vertex order whatever the assignment;
checkpoints are taken in original order too, so a run resumes on any shard
count (elastic restore). Hub replication on the sequential schedule runs
`repro`'s 1-shard hub oracle.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import faults, obs
from repro_torch.checkpoint import store as ckpt_store
from repro_torch.core import engine
from repro_torch.core.device_graph import (
    DeviceGraph,
    ShardedDeviceGraph,
    attach_halo,
    device_halo_spec,
    hub_oracle_slabs,
    prepare_device_graph,
    prepare_sharded_device_graph,
    resolve_device,
    shard_device_graph,
    vertices_to_original,
)
from repro_torch.core.halo import DEFAULT_HALO_THRESHOLD, HubConfig
from repro_torch.core.metrics import local_edges, max_normalized_load
from repro_torch.core.registry import StaticAlgorithm, get_algorithm
from repro_torch.core.revolver import make_generator
from repro_torch.graphs.csr import Graph

_log = logging.getLogger("repro_torch.core.runner")

_SHARDED_SCHEDULES = ("sharded", "halo", "async")


class PartitionStateError(RuntimeError):
    """The drain-window state guard found corrupt partitioner state
    (non-finite LA probabilities or out-of-range labels) under the
    ``guard="raise"`` policy, or a recovery policy could not be applied
    (e.g. rollback with no usable checkpoint)."""


def fetch(groups: Dict[str, List[torch.Tensor]]) -> Dict[str, List[float]]:
    """One blocking device->host transfer: every 0-dim tensor of every
    group, as Python floats per group (f32 scores and metrics, counts and
    booleans are exact as f64). The convergence loop and the drain make
    every window fetch through here, so counting its calls counts the
    run's blocking fetches."""
    names = [n for n, ts in groups.items() if ts]
    values = torch.cat([torch.stack(groups[n]).reshape(-1).to(torch.float64)
                        for n in names]).tolist()
    out, i = {}, 0
    for n in names:
        out[n] = values[i:i + len(groups[n])]
        i += len(groups[n])
    return out


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
    resumed_from: int = 0               # global superstep of the checkpoint
                                        # this run resumed from (0 = fresh);
                                        # `steps` counts from superstep 0
                                        # either way
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
    tracer=None,
    step0: int = 0,
    prev_score: float = -np.inf,
    stall: int = 0,
):
    """Drive `step_fn` with the paper's score-stall halting (Section IV-D
    step 9): stop after `patience` consecutive steps whose score improves by
    less than `theta`. Scores are fetched in `sync_every`-sized windows (see
    module docstring). Shared by `run_partitioner` and the streaming
    `StreamRunner` so the halting semantics cannot drift.

    `on_step(state)` fires after every superstep; `on_score(float)` for
    every fetched score, in step order (including the steps past the
    detected convergence point within the window); `on_drain(state, steps,
    prev_score, stall)` once per fetched window, after its scores, with the
    loop's halting state (so a checkpoint written there resumes exactly).
    It may return a dict with any of ``state`` / ``prev_score`` / ``stall``
    to replace the loop's state (the guard's recovery; it also clears a
    convergence detected in that window).

    `prev_score` / `stall` seed the halting state (a resumed run passes what
    its checkpoint recorded); `step0` offsets the superstep numbering of the
    spans and the fault-injection points to the global step index.

    Fault injection (`repro_torch.faults`): after each superstep the loop
    checks the ``superstep`` point with the global step index — a kill plan
    SIGKILLs here, a poison plan corrupts the state (for guard testing).
    One early-returning call when no plan is active.

    `tracer` (a `repro_torch.obs.Tracer`; default no-op) records one
    "superstep" span per executed step (its dispatch) and a "device-sync"
    span per window fetch, which is where the device time of a window
    accrues. Tracing changes no fetch cadence.

    Returns (state, steps_executed, converged).
    """
    tracer = tracer if tracer is not None else obs.NULL_TRACER
    converged = False
    steps = 0
    pending: list = []
    for step in range(max_steps):
        with tracer.span("superstep", step=step0 + step):
            state = step_fn(state)
        act = faults.fire("superstep", step0 + step)
        if act is not None:
            state = faults.poison(state, act)
        steps = step + 1
        pending.append(state.score)
        if on_step is not None:
            on_step(state)
        if len(pending) < sync_every and steps < max_steps:
            continue
        with tracer.span("device-sync", steps=len(pending), what="scores"):
            scores = fetch({"score": pending})["score"]
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
                converged = False   # scores from corrupt state don't count
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
                dg: DeviceGraph, t0: float, tracer) -> PartitionResult:
    """A static baseline: no supersteps; the metrics on the padded labels,
    as `repro` computes them."""
    labels = torch.zeros((dg.n_pad,), dtype=torch.int32, device=dg.device)
    labels[:graph.n] = algorithm.partition(graph.n, k, dg.device)
    le = float(local_edges(labels, dg.dir_src, dg.dir_dst))
    ml = float(max_normalized_load(labels[:graph.n], dg.deg_out[:graph.n], k))
    if tracer.enabled:
        tracer.counter("local_edges", le, step=0)
        tracer.counter("max_norm_load", ml, step=0)
    return PartitionResult(
        algo=algorithm.name, k=k, labels=labels[:graph.n].cpu().numpy(),
        steps=0, converged=True, local_edges=le, max_norm_load=ml,
        history={"local_edges": [le], "max_norm_load": [ml], "score": [0.0]},
        wall_s=time.time() - t0)


# ---------------------------------------------------------------------------
# crash safety: checkpointed resume (`repro`'s docs/fault-tolerance.md)
# ---------------------------------------------------------------------------
def _is_vertex_field(algo, dg, name, value) -> bool:
    return ((name in algo.vertex_fields or name in algo.replicated_fields)
            and value.ndim >= 1 and value.shape[0] == dg.n_pad)


def _reindex(algo, dg, name, value, index):
    """``value`` reindexed along its vertex axis by ``index`` (per-block
    fields through their flat ``[n_pad, ...]`` view), or as it is."""
    if name in algo.block_fields:
        flat = value.reshape((dg.n_pad,) + tuple(value.shape[2:]))
        return flat.index_select(0, index.to(value.device)).reshape(value.shape)
    if _is_vertex_field(algo, dg, name, value):
        return value.index_select(0, index.to(value.device))
    return value


def _state_to_original(algo, state, dg) -> dict:
    """Checkpoint view of a state: every field by name, the per-vertex and
    per-block fields in original vertex order (a device gather on a
    block-permuted sharded layout, else the tensors as they are), so a
    checkpoint does not depend on the layout. The generator is state too:
    its ``get_state()`` bytes (CPU ``uint8``; 16 bytes for a CUDA
    generator, whose Philox offset advances when a draw is enqueued, so the
    bytes taken at a window drain match the draws already enqueued), and
    the step a 0-dim int64."""
    o2s = getattr(dg, "o2s_t", None)
    out = {name: getattr(state, name) for name in state._fields
           if name not in ("gen", "step")}
    if o2s is not None:
        out = {name: _reindex(algo, dg, name, v, o2s) for name, v in out.items()}
    out["gen"] = state.gen.get_state()
    out["step"] = torch.tensor(state.step, dtype=torch.int64)
    return out


def _state_from_original(algo, tree: dict, dg):
    """Inverse of `_state_to_original`: a state NamedTuple in the layout's
    storage order with a fresh generator on the layout's device set to the
    saved bytes."""
    s2o = getattr(dg, "s2o_t", None)
    out = {name: (_reindex(algo, dg, name, v, s2o) if s2o is not None else v)
           for name, v in tree.items() if name not in ("gen", "step")}
    gen = torch.Generator(device=dg.device)
    gen.set_state(tree["gen"])
    out["gen"] = gen
    out["step"] = int(tree["step"])
    return algo.state_cls(**out)


class _CheckpointManager:
    """Drain-window checkpointing for `run_partitioner`.

    Saves ride the existing ``sync_every`` drain windows: the state is
    snapshotted into pinned host buffers by non-blocking copies enqueued
    just before the window's bundled `fetch`, whose sync covers them (zero
    additional blocking fetches), then written by an async writer thread
    while the loop keeps dispatching. Waiting on the previous handles
    before a new save is due (at most two in flight) and at run end both
    orders the atomic renames and re-raises write failures.
    """

    def __init__(self, ckpt_dir, every, keep, algorithm, dg, meta, tracer):
        # dg: the run's layout; a `ShardedDeviceGraph`'s restores are placed
        # onto it, whatever shard count wrote the checkpoint
        self.dir = ckpt_dir
        self.every = every
        self.keep = keep
        self.algorithm = algorithm
        self.dg = dg
        self.meta = meta
        self.tracer = tracer
        self.last_saved = 0
        self.saved = 0
        self._handles: list = []

    def _reap(self, block: bool = False):
        """Collect finished writer threads, re-raising any write failure.
        Non-blocking unless `block` — the loop must never stall on an
        fsync."""
        alive = []
        for h in self._handles:
            if block or h.done():
                h.wait()
                if self.tracer.enabled:
                    self.tracer.counter("checkpoint_wait_s", h.wait_s)
                    self.tracer.counter("checkpoint_write_s", h.write_s)
            else:
                alive.append(h)
        self._handles = alive

    def busy(self) -> bool:
        """True when the disk is falling behind (two writes already in
        flight); the due save is skipped rather than blocking the loop —
        the next drain window picks it up."""
        self._reap()
        return len(self._handles) >= 2

    def due(self, global_steps: int) -> bool:
        return self.every > 0 and global_steps - self.last_saved >= self.every

    def snapshot(self, state) -> ckpt_store.Snapshot:
        return ckpt_store.Snapshot(_state_to_original(self.algorithm, state, self.dg))

    def save(self, global_steps: int, snap, prev_score, stall):
        meta = dict(self.meta, steps=global_steps,
                    prev_score=float(prev_score), stall=int(stall),
                    converged=bool(stall >= self.meta.get("patience", 1 << 30)))
        with self.tracer.span("checkpoint-save", step=global_steps, bytes=snap.nbytes):
            self._handles.append(ckpt_store.save_checkpoint(
                self.dir, global_steps, snap, async_save=True,
                meta=meta, keep=self.keep))
        self.last_saved = global_steps
        self.saved += 1
        if self.tracer.enabled:
            self.tracer.counter("checkpoints_saved", float(self.saved),
                                step=global_steps)

    def finish(self):
        self._reap(block=True)

    # -- restore ---------------------------------------------------------- #

    def restore_latest(self, like_state):
        """Restore the newest usable checkpoint, falling back past corrupt
        or incompatible ones. Returns ``(state, steps, prev_score, stall,
        converged)`` or None when no checkpoint is usable. Saves still in
        flight are waited for first: the newest clean state may be one the
        writer has not yet renamed into place."""
        self._reap(block=True)
        for step in reversed(ckpt_store.all_steps(self.dir)):
            try:
                return self._restore(step, like_state)
            except (ckpt_store.CheckpointError, ValueError, KeyError) as e:
                _log.warning(
                    "checkpoint step %d in %s unusable (%s); trying the "
                    "previous one", step, self.dir, e)
        return None

    def _restore(self, step, like_state):
        manifest = ckpt_store.load_manifest(self.dir, step)
        meta = manifest.get("meta", {})
        for field in ("algo", "k", "n", "m"):
            if field in meta and field in self.meta \
                    and meta[field] != self.meta[field]:
                raise ValueError(
                    f"checkpoint step {step} was written by a different run: "
                    f"{field}={meta[field]!r} vs this run's "
                    f"{self.meta[field]!r}")
        # the random state is not shared across device types (nor with
        # `repro`, whose checkpoints carry a threefry key and no device_type)
        if meta.get("device_type") != self.meta["device_type"]:
            raise ValueError(
                f"checkpoint step {step} was written by a different run: "
                f"device_type={meta.get('device_type')!r} vs this run's "
                f"{self.meta['device_type']!r}")
        # the checkpoint is in original vertex order, so it lands on this
        # layout whatever shard count or assignment wrote it (elastic
        # restore); the shapes must match (ValueError otherwise)
        like = _state_to_original(self.algorithm, like_state, self.dg)
        with self.tracer.span("checkpoint-restore", step=step,
                              saved_shards=int(meta.get("n_shards", 1))):
            tree = ckpt_store.restore_checkpoint(self.dir, step, like)
            state = _state_from_original(self.algorithm, tree, self.dg)
            if isinstance(self.dg, ShardedDeviceGraph):
                state = engine.place_state(self.algorithm, state, self.dg)
        if self.tracer.enabled:
            self.tracer.instant("resumed", step=step)
        return (state, int(meta.get("steps", step)),
                float(meta.get("prev_score", -np.inf)),
                int(meta.get("stall", 0)), bool(meta.get("converged", False)))


_GUARD_POLICIES = ("off", "raise", "rollback", "reinit")
_GUARD_ALIASES = {"rollback-to-last-checkpoint": "rollback",
                  "reinit-affected-vertices": "reinit"}


def _check_vcycle_args(algo, static, dg, init_labels, init_probs,
                       init_sharpen, draws, checkpoint_dir, resume, guard) -> None:
    """`repro`'s argument errors of ``mode="vcycle"``."""
    if static:
        raise TypeError(
            f"{algo!r} runs no supersteps; mode='vcycle' refines through "
            "warm starts")
    if checkpoint_dir is not None or resume or guard != "off":
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
    mesh=None,
    assignment="contiguous",
    halo_threshold: float = DEFAULT_HALO_THRESHOLD,
    halo_granularity: str = "auto",
    hub_replication: bool = False,
    hub_quantile: float = 0.0,
    hub_target_coverage: Optional[float] = None,
    sync_every: int = 1,
    init_labels: Optional[np.ndarray] = None,
    init_probs: Optional[np.ndarray] = None,
    init_sharpen: float = 0.0,
    keep_probs: bool = False,
    trace=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    keep_checkpoints: int = 2,
    guard: str = "off",
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

    `repro.core.runner.run_partitioner`: extra kwargs flow into the
    algorithm's config dataclass (unknown keys raise TypeError). `dg` reuses
    a prepared layout on the same device. `sync_every` batches device->host
    score fetches.

    ``chunk_schedule="sharded"`` (a config knob of every superstep
    algorithm) runs the Jacobi superstep over a `BlocksMesh` — ``mesh``
    selects it (default `make_blocks_mesh` on ``device``: one shard per
    visible CUDA device, or one CPU shard; ``BlocksMesh([dev] * n)`` runs n
    shards on one device); a passed plain `DeviceGraph` is laid out over
    it, a `ShardedDeviceGraph` is used as it is. ``"halo"`` replaces the
    full gather with the layout's precomputed exchange
    (`repro_torch.core.halo`; ``halo_threshold`` is the coverage above
    which it falls back to the full gather, ``halo_granularity``
    "auto" | "block" | "vertex" the exchange unit). ``assignment`` maps
    blocks to shards ("contiguous" | "locality" | "vcycle" | an explicit
    permutation). ``"async"`` (chunk rules only) overlaps the exchange with
    each shard's interior blocks, on a layout ordered interior-first;
    ``staleness_bound=0`` (config) refreshes the exchange every superstep
    and is bit-identical to "halo", ``s > 0`` reuses a tail up to s
    supersteps old (refreshed at every checkpoint window, so resume stays
    bit-identical). Labels and probs come back in original vertex order. `init_labels` (and `init_probs` / `init_sharpen`)
    warm-start the state from a previous assignment; `keep_probs=True`
    returns the final LA probability tensor. `draws` replays external random
    draws into every superstep (tests only; each rule module states its
    hook's signature). A fixed seed reproduces the labels bit for
    bit on one device type.

    ``hub_replication=True`` mirrors the top-degree vertices into every
    shard's buffer and reconciles their labels each superstep by a global
    weighted vote (``hub_quantile`` / ``hub_target_coverage`` size the hub
    set, see `HubConfig`; the reconcile is the H1 kernel on CUDA). On the
    halo and async schedules it rides the halo plan (a plan that falls back
    to the full gather has no hubs); on the sequential schedule it runs the
    same plan on one shard, `repro`'s oracle trajectory, which a 1-shard hub
    run equals bit for bit. It is incompatible with
    ``chunk_schedule="sharded"`` (the full gather already replicates every
    vertex).

    The static baselines (``"hash"``, ``"range"``) run no supersteps: they
    take no config kwargs, no warm-start arguments and neither checkpoints
    nor the guard (TypeError).

    `trace` (a `repro_torch.obs.Tracer`; default off) records the run into a
    perfetto-exportable trace: a "run-partitioner" root span, the layout
    build, one span per superstep, the rules' "edge-phase" / "la-update"
    dispatch spans, the window fetches, kernel builds, and per-superstep
    counter series (`local_edges`, `max_norm_load`, `migrations`) that ride
    the existing fetch windows. With tracing off results are bit-identical.

    Crash safety (`repro`'s docs/fault-tolerance.md): `checkpoint_dir` +
    `checkpoint_every=N` snapshot the whole algorithm state (every field,
    the generator's state included, plus the host-side score-stall
    counters) at the first drain window N or more supersteps after the
    last save; the snapshot's copies ride the window's fetch and the disk
    write is async. `resume=True` restores the newest usable checkpoint
    (corrupt ones, and ones written by another run or on another device
    type, are skipped; none at all is a fresh run) and continues: a killed
    and resumed run is bit-identical to an uninterrupted one with the same
    arguments on the same device type. A checkpoint is in original vertex
    order, so it restores onto a layout of another shard count or
    assignment (elastic restore; its shapes must match): the sequential
    schedule then resumes bit-identically, while the sharded trajectory is
    specific to the shard count, so there the restored state equals the
    checkpointed one bit for bit and the run continues from it on the new
    count. `keep_checkpoints` bounds the
    checkpoints on disk. `guard` checks state sanity (finite probs,
    in-range labels) at each drain window: "off" (default) | "raise" |
    "rollback"/"rollback-to-last-checkpoint" (the generator rewinds with
    the rest of the state) | "reinit"/"reinit-affected-vertices".

    ``mode="vcycle"`` runs the multilevel V-cycle
    (`repro_torch.core.multilevel`): coarsen by heavy-edge matching down to
    `coarse_n` vertices, partition the coarsest graph to score-stall
    convergence, then uncoarsen level by level with `init_from_labels` warm
    starts under shrinking per-level superstep budgets (the finest level is
    capped at `level_decay * max_steps`; probs-carrying rules sharpen the
    projected labels by `vcycle_sharpen`). The schedule, mesh, assignment,
    halo and hub knobs apply to the finest level only; the coarser levels
    run the sequential schedule. It builds its own per-level layouts, so it
    is incompatible with a passed `dg`, warm-start args, checkpointing, the
    state guard and `draws`.
    """
    t0 = time.time()
    algorithm = get_algorithm(algo)
    static = isinstance(algorithm, StaticAlgorithm)
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    guard = _GUARD_ALIASES.get(guard, guard)
    if guard not in _GUARD_POLICIES:
        raise ValueError(
            f"unknown guard policy {guard!r}; expected one of "
            f"{_GUARD_POLICIES} (or a long alias {tuple(_GUARD_ALIASES)})")
    if checkpoint_every < 0:
        raise ValueError(
            f"checkpoint_every must be >= 0, got {checkpoint_every}")
    if checkpoint_dir is None and (checkpoint_every > 0 or resume):
        raise ValueError("checkpoint_every/resume need a checkpoint_dir")
    if guard == "rollback" and checkpoint_dir is None:
        raise ValueError("guard='rollback' needs a checkpoint_dir")
    if static and cfg_kwargs:
        raise TypeError(f"{algo!r} runs no supersteps; it takes no config "
                        f"kwargs (got {sorted(cfg_kwargs)})")
    if static and (checkpoint_dir is not None or guard != "off"):
        raise TypeError(
            f"{algo!r} runs no supersteps; checkpointing and the state guard "
            "are meaningless")
    if mode not in ("flat", "vcycle"):
        raise ValueError(f"mode={mode!r} is not one of ('flat', 'vcycle')")
    if mode != "vcycle" and (coarse_n is not None or level_decay is not None
                             or vcycle_sharpen is not None):
        raise ValueError(
            "coarse_n/level_decay/vcycle_sharpen are only meaningful with "
            "mode='vcycle'")
    schedule = cfg_kwargs.get("chunk_schedule", "sequential")
    sharded = schedule in _SHARDED_SCHEDULES
    _check_schedule_args(sharded, schedule, mesh, assignment, halo_granularity)
    if not hub_replication and (hub_quantile or hub_target_coverage is not None):
        raise ValueError("hub_quantile/hub_target_coverage need hub_replication=True")
    if hub_replication and schedule == "sharded":
        raise ValueError(
            "hub_replication is incompatible with chunk_schedule='sharded' (the full "
            "gather already replicates every vertex); use chunk_schedule='halo' or the "
            "sequential schedule")
    hubs = (HubConfig(quantile=hub_quantile, target_coverage=hub_target_coverage)
            if hub_replication else None)
    if mode == "vcycle":
        _check_vcycle_args(algo, static, dg, init_labels, init_probs,
                           init_sharpen, draws, checkpoint_dir, resume, guard)
    dev = resolve_device(device)
    if mesh is not None and mesh.home.type != dev.type:
        raise ValueError(f"mesh {mesh} is not on device={device!r}")
    if mode == "vcycle":
        from repro_torch.core import multilevel

        return multilevel.run_vcycle(
            algo, graph, k, seed=seed, n_blocks=n_blocks, max_steps=max_steps,
            track_history=track_history, mesh=mesh, assignment=assignment,
            halo_threshold=halo_threshold, halo_granularity=halo_granularity,
            hub_replication=hub_replication, hub_quantile=hub_quantile,
            hub_target_coverage=hub_target_coverage, sync_every=sync_every,
            keep_probs=keep_probs, trace=trace, device=dev, coarse_n=coarse_n,
            level_decay=level_decay, vcycle_sharpen=vcycle_sharpen,
            cfg_kwargs=cfg_kwargs)
    tracer = trace if trace is not None else obs.NULL_TRACER
    with obs.use(tracer), \
            tracer.span("run-partitioner", algo=algo, k=k, schedule=schedule,
                        n=graph.n, m=graph.m):
        result = _run_partitioner_traced(
            tracer, algorithm, static, schedule, algo, graph, k, t0, dev,
            seed=seed, n_blocks=n_blocks, max_steps=max_steps,
            track_history=track_history, dg=dg, mesh=mesh, assignment=assignment,
            halo_threshold=halo_threshold, halo_granularity=halo_granularity, hubs=hubs,
            sync_every=sync_every,
            init_labels=init_labels, init_probs=init_probs,
            init_sharpen=init_sharpen, keep_probs=keep_probs, draws=draws,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            resume=resume, keep_checkpoints=keep_checkpoints, guard=guard,
            cfg_kwargs=cfg_kwargs)
    if tracer.enabled:
        # run manifest: trace_report --validate checks one superstep span
        # per executed step against this (resumed steps ran in an earlier
        # process — only the steps executed here have spans)
        tracer.meta.setdefault("runs", []).append({
            "algo": algo, "k": k, "schedule": schedule,
            "steps": result.steps - result.resumed_from})
    return result


def _check_schedule_args(sharded, schedule, mesh, assignment, halo_granularity) -> None:
    """`repro`'s argument errors of the schedule knobs."""
    if mesh is not None and not sharded:
        raise ValueError("mesh is only meaningful with chunk_schedule='sharded'/'halo'/"
                         "'async'")
    if not sharded and not (isinstance(assignment, str) and assignment == "contiguous"):
        raise ValueError("assignment is only meaningful with chunk_schedule="
                         "'sharded'/'halo'/'async'")
    if halo_granularity not in ("auto", "block", "vertex"):
        raise ValueError(f"halo_granularity={halo_granularity!r} is not one of "
                         "('auto', 'block', 'vertex')")
    if halo_granularity != "auto" and schedule not in ("halo", "async"):
        raise ValueError("halo_granularity is only meaningful with chunk_schedule="
                         "'halo'/'async'")


def _prepare_layout(graph, schedule, dev, *, dg, mesh, n_blocks, assignment, halo_threshold,
                    halo_granularity, hubs):
    """The run's layout: a `ShardedDeviceGraph` for the sharded schedules
    (built, laid out from a passed `DeviceGraph`, or a passed one with a
    halo plan, and the hubs asked for, attached where it lacks one), else a
    `DeviceGraph`."""
    if schedule not in _SHARDED_SCHEDULES:
        if dg is None:
            return prepare_device_graph(graph, n_blocks=n_blocks, device=dev)
        if dg.device.type != dev.type:
            raise ValueError(f"dg lives on {dg.device}, but device={dev.type!r}")
        return dg
    halo = schedule in ("halo", "async")
    if mesh is None and isinstance(dg, ShardedDeviceGraph):
        mesh = dg.mesh
    if mesh is None:
        from repro_torch.launch.mesh import make_blocks_mesh

        mesh = make_blocks_mesh(device=dev)
    knobs = dict(assignment=assignment, halo=halo, halo_threshold=halo_threshold,
                 halo_granularity=halo_granularity, hubs=hubs if halo else None,
                 interior_first=schedule == "async")
    if dg is None:
        return prepare_sharded_device_graph(graph, mesh, n_blocks=n_blocks, **knobs)
    if not isinstance(dg, ShardedDeviceGraph):
        return shard_device_graph(dg, mesh, **knobs)
    if not (isinstance(assignment, str) and assignment == "contiguous"):
        # a laid-out layout's assignment is its storage order
        raise ValueError(
            "assignment cannot be applied to a pre-built ShardedDeviceGraph; pass "
            "assignment= to shard_device_graph / prepare_sharded_device_graph")
    if dg.mesh != mesh:
        raise ValueError(f"dg is laid out over {dg.mesh}, not the mesh passed ({mesh})")
    if halo and dg.halo is None:
        dg = attach_halo(dg, halo_threshold, halo_granularity=halo_granularity, hubs=hubs)
    return dg


def halo_counters(tracer, algorithm, spec, k, step: Optional[int] = None) -> None:
    """`repro`'s gauges of a halo plan (what each superstep's exchange and
    hub votes move a device), without touching the device; the flat runner
    records them once a run, `StreamRunner` once a delta (``step``)."""
    n_fields = len(algorithm.vertex_fields)
    wire_sum = sum(spec.wire_bytes_per_elem(k, f in algorithm.wire_int8_fields)
                   for f in algorithm.vertex_fields)
    tracer.counter("halo_b_max", spec.b_max, step=step)
    tracer.counter("halo_h_max", spec.h_max, step=step)
    tracer.counter("halo_coverage", spec.coverage, step=step)
    tracer.counter("gathered_bytes_halo", spec.gathered_elems_per_device() * wire_sum, step=step)
    tracer.counter("gathered_bytes_full", spec.full_gather_elems_per_device() * 4 * n_fields,
                   step=step)
    if spec.granularity == "vertex" and not spec.fallback:
        tracer.counter("pervertex_halo_bytes", spec.gathered_elems_per_device() * wire_sum,
                       step=step)
    tracer.counter("hub_count", spec.n_hubs, step=step)
    if spec.n_hubs:
        tracer.counter("replica_vote_bytes", spec.hub_sync_elems_per_device(k, n_fields) * 4,
                       step=step)


def _plan_counters(tracer, algorithm, schedule, sdg, k) -> None:
    """The layout's static per-run gauges: the halo plan's
    (`halo_counters`), the async schedule's interior split, or the full
    gather's bytes without a plan."""
    spec = sdg.halo
    if spec is None:
        per_dev = (sdg.n_shards - 1) * sdg.blocks_per_shard * sdg.block_v
        tracer.counter("gathered_bytes_full", per_dev * 4 * len(algorithm.vertex_fields))
        return
    if schedule == "async":
        # trace_report --validate requires the overlap span pair for async
        # runs unless the plan fell back to the full gather
        if spec.fallback:
            tracer.meta["async_fallback"] = True
        tracer.counter("interior_split", spec.interior_split)
    halo_counters(tracer, algorithm, spec, k)


class AsyncStaleness:
    """The async schedule's staleness policy, shared by `run_partitioner`
    and `StreamRunner`: the engine only tells a fresh exchange (cache None)
    from a reused tail; this decides. ``g`` counts supersteps from ``g0``
    (a resumed run's global step). The tail is refreshed when the bound
    expires (``g % (s + 1) == 0`` keeps any tail at most ``staleness_bound``
    supersteps old), when the layout object changes (the tail indexes one
    layout's slabs: a stream's every delta), after `drop` (a rollback or
    reinit discarded the trajectory it was read from) and, with ``window``,
    on every checkpoint window (``g % window == 0``), so a snapshot is taken
    downstream of a fresh exchange and a resumed run, which starts with no
    tail, replays bit-identically. Each superstep records the
    ``halo_staleness`` counter."""

    def __init__(self, algorithm, cfg, *, g0: int = 0, window: int = 0, draws=None,
                 tracer=None):
        self.algorithm, self.cfg, self.draws = algorithm, cfg, draws
        self.bound = cfg.staleness_bound
        self.window = window
        self.tracer = tracer if tracer is not None else obs.NULL_TRACER
        self.g = self.last_refresh = g0
        self.cache = None
        self.layout = None

    def drop(self) -> None:
        self.cache = None

    def step(self, layout, state):
        if layout is not self.layout:
            self.layout, self.cache = layout, None
        g = self.g
        if (self.cache is None or self.bound == 0 or g % (self.bound + 1) == 0
                or (self.window and g % self.window == 0)):
            self.cache = None
            self.last_refresh = g
        state, self.cache = engine.async_superstep(self.algorithm, layout, self.cfg, state,
                                                   cache=self.cache, draws=self.draws)
        if self.tracer.enabled:
            self.tracer.counter("halo_staleness", float(g - self.last_refresh), step=g)
        self.g = g + 1
        return state


def _run_partitioner_traced(
    tracer, algorithm, static, schedule, algo: str, graph: Graph, k: int, t0: float, dev,
    *, seed, n_blocks, max_steps, track_history, dg, mesh, assignment, halo_threshold,
    halo_granularity, hubs, sync_every, init_labels, init_probs, init_sharpen, keep_probs, draws,
    checkpoint_dir, checkpoint_every, resume, keep_checkpoints, guard, cfg_kwargs,
) -> PartitionResult:
    """Body of `run_partitioner`, running under `obs.use(tracer)` inside the
    root span (split out so the traced scope covers every early return)."""
    if not static:
        cfg = _make_cfg(algorithm.config_cls, k, max_steps, cfg_kwargs)
    elif init_labels is not None or init_probs is not None or init_sharpen:
        raise TypeError(f"{algo!r} is stateless; warm-start args are meaningless")
    with tracer.span("prepare-layout", schedule=schedule):
        dg = _prepare_layout(graph, schedule, dev, dg=dg, mesh=mesh, n_blocks=n_blocks,
                             assignment=assignment, halo_threshold=halo_threshold,
                             halo_granularity=halo_granularity, hubs=hubs)
        seq_hub = None
        if hubs is not None and not static and schedule not in _SHARDED_SCHEDULES:
            # `repro`'s sequential hub oracle: the same hub plan on one shard
            # (quantile hub selection is shard-count independent), uploaded
            # once
            seq_hub = hub_oracle_slabs(dg, device_halo_spec(dg, 1, halo_threshold, hubs=hubs))
    sharded = isinstance(dg, ShardedDeviceGraph) and schedule in _SHARDED_SCHEDULES
    if tracer.enabled and sharded:
        _plan_counters(tracer, algorithm, schedule, dg, k)
    if static:
        return _run_static(algorithm, graph, k, dg, t0, tracer)

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
    if sharded:
        state = engine.place_state(algorithm, state, dg)

    # ---- crash safety: checkpoint manager + resume -----------------------
    ckpt = None
    if checkpoint_dir is not None:
        run_meta = {"kind": "partition", "algo": algo, "k": k, "n": graph.n,
                    "m": graph.m, "schedule": schedule, "seed": seed,
                    "sync_every": sync_every, "patience": cfg.patience,
                    "device_type": dg.device.type,
                    "n_shards": dg.n_shards if sharded else 1}
        ckpt = _CheckpointManager(checkpoint_dir, checkpoint_every,
                                  keep_checkpoints, algorithm, dg, run_meta,
                                  tracer)
    start_step, start_prev_score, start_stall = 0, -np.inf, 0
    resumed_converged = False
    if resume:
        restored = ckpt.restore_latest(state)
        if restored is not None:
            (state, start_step, start_prev_score, start_stall,
             resumed_converged) = restored
            ckpt.last_saved = start_step
        # no checkpoint yet -> a fresh run (so the same command line works
        # for the first launch and every relaunch)

    history: Dict[str, List[float]] = {"local_edges": [], "max_norm_load": [], "score": []}
    # per-step metric tensors stay on the device and are drained on the
    # same sync_every window as the scores
    pending_le: List[torch.Tensor] = []
    pending_ml: List[torch.Tensor] = []
    pending_mig: List[torch.Tensor] = []
    step_ts: List[float] = []    # dispatch timestamp per buffered step, so
                                 # drained counters are back-dated to the
                                 # superstep that produced them
    drained = [start_step]       # global index of the next drained step

    async_policy = None
    if schedule == "async":
        ckpt_windows = checkpoint_dir is not None and checkpoint_every > 0
        async_policy = AsyncStaleness(algorithm, cfg, g0=start_step,
                                      window=sync_every if ckpt_windows else 0,
                                      draws=draws, tracer=tracer)

        def base_step(s):
            return async_policy.step(dg, s)
    else:
        def base_step(s):
            return engine.superstep(algorithm, dg, cfg, s, draws=draws, halo=seq_hub)

    if tracer.enabled:
        def step_fn(s):
            # the superstep updates labels in place: clone them before the
            # dispatch to count migrations as a device-side reduction,
            # drained with the window
            prev = s.labels.clone()
            s2 = base_step(s)
            pending_mig.append(((s2.labels != prev) & dg.vmask).sum())
            return s2
    else:
        step_fn = base_step

    collect = track_history or tracer.enabled

    def on_step(s):
        pending_le.append(local_edges(s.labels, dg.dir_src, dg.dir_dst))
        pending_ml.append(max_normalized_load(s.labels, dg.deg_out, k))
        if tracer.enabled:
            step_ts.append(tracer.now_us())

    def drain_metrics(dstate, loop_steps, prev_score, stall):
        # one bundled fetch per window, traced or not; the guard's checks
        # ride it, and the snapshot's copies are enqueued before it, so
        # crash safety adds no blocking fetch
        gsteps = start_step + loop_steps
        groups = {"le": pending_le, "ml": pending_ml, "mig": pending_mig}
        checks = []
        if guard != "off":
            lab = dstate.labels
            checks.append(("labels", torch.all(torch.where(
                dg.vmask, (lab >= 0) & (lab < cfg.k), True))))
            if algorithm.supports_probs:
                checks.append(("probs", torch.isfinite(dstate.probs).all()))
            groups["guard"] = [c for _, c in checks]
        save_due = ckpt is not None and ckpt.due(gsteps) and not ckpt.busy()
        snap = None
        if save_due:
            with tracer.span("checkpoint-snapshot", step=gsteps):
                snap = ckpt.snapshot(dstate)
        fetched = {}
        if any(groups.values()):
            with tracer.span("device-sync", steps=len(pending_le), what="metrics"):
                fetched = fetch(groups)
        le_v, ml_v = fetched.get("le", []), fetched.get("ml", [])
        mig_v = fetched.get("mig", [])
        if track_history:
            history["local_edges"].extend(le_v)
            history["max_norm_load"].extend(ml_v)
        if tracer.enabled:
            for i in range(len(le_v)):
                step = drained[0] + i
                ts = step_ts[i] if i < len(step_ts) else None
                tracer.counter("local_edges", le_v[i], step=step, ts=ts)
                tracer.counter("max_norm_load", ml_v[i], step=step, ts=ts)
                if i < len(mig_v):
                    tracer.counter("migrations", mig_v[i], step=step, ts=ts)
        drained[0] += len(le_v)
        pending_le.clear()
        pending_ml.clear()
        pending_mig.clear()
        step_ts.clear()

        bad = [name for (name, _), ok in zip(checks, fetched.get("guard", []))
               if not ok]
        if bad:
            return _handle_guard_violation(bad, gsteps)
        if save_due:
            ckpt.save(gsteps, snap, prev_score, stall)
        return None

    def _handle_guard_violation(bad, gsteps):
        # never checkpoint a corrupt state — the save for this window is
        # skipped no matter which recovery policy runs
        desc = ("non-finite probs" if "probs" in bad
                else "out-of-range labels")
        tracer.instant("guard-violation", step=gsteps, checks=",".join(bad))
        tracer.counter("guard_violations", 1)
        _log.warning("state guard tripped at step %d: %s", gsteps, desc)
        if guard == "raise":
            raise PartitionStateError(
                f"state guard tripped at step {gsteps}: {desc}")
        if guard == "rollback":
            restored = ckpt.restore_latest(state)
            if restored is None:
                raise PartitionStateError(
                    f"state guard tripped at step {gsteps} ({desc}) and no "
                    f"usable checkpoint exists in {checkpoint_dir} to roll "
                    f"back to")
            r_state, r_step, r_prev, r_stall, _ = restored
            tracer.instant("rollback", from_step=gsteps, to_step=r_step)
            _log.warning("rolled back to checkpoint step %d", r_step)
            # loop step counting continues forward; only the halting state
            # and the state (its generator included) rewind; a cached halo
            # tail was read from the discarded trajectory
            if async_policy is not None:
                async_policy.drop()
            return {"state": r_state, "prev_score": r_prev, "stall": r_stall}
        # reinit-affected-vertices: repair on the device — clamp labels into
        # range, rebuild loads from the repaired labels, and reset any
        # non-finite prob rows to uniform
        s = state_box[0]
        labels = torch.clamp(s.labels, 0, cfg.k - 1)
        fix = {"labels": labels, "loads": engine.loads_from_labels(dg, cfg.k, labels)}
        if algorithm.supports_probs:
            flat = s.probs.reshape(dg.n_pad, cfg.k)
            row_ok = torch.isfinite(flat).all(dim=1, keepdim=True)
            uniform = torch.full_like(flat, 1.0 / cfg.k)
            fix["probs"] = torch.where(row_ok, flat, uniform).reshape(s.probs.shape)
        tracer.instant("reinit", step=gsteps)
        _log.warning("reinitialized affected vertices at step %d", gsteps)
        if async_policy is not None:
            async_policy.drop()      # the tail may carry the corrupt labels
        return {"state": s._replace(**fix), "prev_score": -np.inf, "stall": 0}

    # the reinit path needs the loop's current state object (drain_metrics
    # receives it); a one-slot box keeps the closure simple
    state_box = [state]

    def on_drain(dstate, loop_steps, prev_score, stall):
        state_box[0] = dstate
        return drain_metrics(dstate, loop_steps, prev_score, stall)

    need_drain = collect or ckpt is not None or guard != "off"
    remaining = cfg.max_steps - start_step
    if resumed_converged or remaining <= 0:
        # nothing left to run: the checkpoint already recorded the outcome
        # (hitting max_steps without a stall is converged=False, same as an
        # uninterrupted run)
        loop_steps, converged = 0, resumed_converged
    else:
        state, loop_steps, converged = run_convergence_loop(
            step_fn, state,
            max_steps=remaining, patience=cfg.patience, theta=cfg.theta,
            sync_every=sync_every,
            on_step=on_step if collect else None,
            on_score=history["score"].append if track_history else None,
            on_drain=on_drain if need_drain else None,
            tracer=tracer,
            step0=start_step, prev_score=start_prev_score, stall=start_stall,
        )
    if ckpt is not None:
        ckpt.finish()
    steps = start_step + loop_steps

    # the final step's local_edges / max_norm_load already came back through
    # the windowed drain when history or tracing is on
    with tracer.span("device-sync", what="result"):
        if track_history and history["local_edges"]:
            le, ml = history["local_edges"][-1], history["max_norm_load"][-1]
        elif tracer.enabled and tracer.series.get("local_edges"):
            le = tracer.series["local_edges"][-1][1]
            ml = tracer.series["max_norm_load"][-1][1]
        else:
            le = float(local_edges(state.labels, dg.dir_src, dg.dir_dst))
            ml = float(max_normalized_load(state.labels, dg.deg_out, k))
        # labels and probs cross the API boundary in original vertex order
        # (the identity on an unpermuted layout)
        probs = None
        if keep_probs and algorithm.supports_probs:
            flat = state.probs.reshape(dg.n_pad, cfg.k)
            probs = vertices_to_original(dg, flat).reshape(state.probs.shape).cpu().numpy()
        labels = vertices_to_original(dg, state.labels)[: graph.n].cpu().numpy()
    return PartitionResult(
        algo=algo, k=k, labels=labels, steps=steps, converged=converged,
        local_edges=le, max_norm_load=ml, history=history,
        wall_s=time.time() - t0, probs=probs, resumed_from=start_step,
    )
