"""StreamRunner: ingest -> warm-start refine -> metrics, per delta.

The port of `repro.streaming.runner`. The streaming lifecycle:

  1. an `EdgeDelta` arrives (from a `StreamBuffer` or `stream_from_graph`);
  2. `IncrementalDeviceGraph.apply` merges it — sorted-key splice on the
     host, dirty-block slab rewrite on the host and the device;
  3. the refine algorithm is warm-started from the previous assignment
     through the registry's ``init_from_labels`` (surviving vertices keep
     their labels — and, for probs-carrying algorithms like Revolver, their
     learned LA probabilities — new vertices start cold) and refined for a
     handful of supersteps with the paper's score-stall halting
     (`run_convergence_loop`);
  4. quality metrics are reported per delta (`DeltaReport`).

The refine algorithm is any engine-driven entry in the algorithm registry
(``algo="revolver"`` by default; "spinner" and "restream" run unchanged).
On CUDA tensors the rules refine through the hand-written kernels: K1 and
K2 for Revolver, K3 for Spinner and restream.

Random state: one `torch.Generator` (`make_generator(seed, device)`) is
carried across the whole stream in place of `repro`'s per-delta
``jax.random.split``; the same seed on the same device type gives a
bit-identical stream.

Observability and crash safety as in `repro`: ``trace=`` records one
"delta" span per ingest (merge / warm-start / supersteps numbered across
deltas) and per-delta counters; ``checkpoint_dir`` saves every
``checkpoint_every`` deltas the host-side edge arrays and slabs, the
carried labels and LA probabilities and the generator's state, written
async; ``resume=True`` restores the newest usable one (the row pointer,
span plan and device slabs rebuilt from the saved slabs) and `run` skips
the deltas already ingested, so the resumed stream is bit-identical to an
uninterrupted one on the same device type.

Restream mode (`StreamConfig.restream=True`) follows the prioritized
restreaming idea (Awadelkarim & Ugander): after each merge the
highest-degree vertices are replayed in priority-ordered chunks. Replaying
a chunk resets its vertices' LA probabilities to uniform and runs a couple
of supersteps before the next chunk; then the normal refine loop finishes
the pass. (It requires a probs-carrying algorithm; with
``algo="restream"`` the degree-priority ramp is built into the rule
itself.)

The sharded schedules (``chunk_schedule="sharded" | "halo" | "async"``, a
config knob) refine over a `BlocksMesh` (``mesh=``; default
`make_blocks_mesh` on ``device``): the incremental layout is mesh-aligned
up front and may be stored in a permuted block->shard order
(``assignment=``: "contiguous", "locality" — decided once, from the first
merged delta — or an explicit permutation), so each delta's dirty slabs
land on the shard that owns them. ``"halo"`` and ``"async"`` rebuild the
exchange plan every delta (``halo_threshold``, ``halo_granularity`` and
the hub knobs as in `run_partitioner`) under monotonic shape floors:
growth of ``b_max`` / ``h_max`` is a "halo-widen" event, of the hub region
a "hub-promote" one, and promoted hubs stay replicated. ``"async"`` keeps
a tail up to ``staleness_bound`` supersteps old (`AsyncStaleness`; a new
delta's layout always refreshes it). Carried labels and probabilities stay
in original vertex order whatever the assignment; the floors, the hub set
and the permutation ride the stream checkpoints.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import faults, obs
from repro_torch.checkpoint import store as ckpt_store
from repro_torch.core import engine
from repro_torch.core.device_graph import resolve_device, vertices_to_original
from repro_torch.core.halo import DEFAULT_HALO_THRESHOLD, HubConfig
from repro_torch.core.metrics import local_edges, max_normalized_load
from repro_torch.core.registry import Algorithm, get_algorithm
from repro_torch.core.revolver import make_generator
from repro_torch.core.runner import (
    _SHARDED_SCHEDULES,
    AsyncStaleness,
    halo_counters,
    run_convergence_loop,
)
from repro_torch.streaming.delta_graph import IncrementalDeviceGraph
from repro_torch.streaming.stream import EdgeDelta

_log = logging.getLogger("repro_torch.streaming")


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Knobs for the incremental repartitioning loop."""

    k: int
    n_blocks: int = 8
    refine_max_steps: int = 40      # superstep budget per delta
    refine_patience: int = 3        # score-stall halting within a delta
    theta: float = 0.001
    sync_every: int = 4             # device->host score fetch window
    restream: bool = False          # prioritized high-degree replay per delta
    restream_frac: float = 0.25     # fraction of vertices replayed
    restream_chunks: int = 4        # priority chunks per replay pass
    restream_steps_per_chunk: int = 2
    warm_sharpen: float = 0.0       # blend carried LA probs toward carried
                                    # labels (see revolver_init_from_labels)
    e_headroom: float = 1.5         # slack factor when a block re-pads


@dataclasses.dataclass
class DeltaReport:
    """Per-delta outcome: merge stats + refinement cost + partition quality."""

    delta_idx: int
    m: int                   # |E| after the merge
    added: int
    deleted: int
    steps: int               # supersteps spent refining this delta
    converged: bool
    local_edges: float
    max_norm_load: float
    dirty_blocks: int
    repadded: bool
    wall_s: float
    merge_s: float = 0.0     # host seconds of the merge and the uploads
    plan_s: float = 0.0      # host seconds of `as_sharded` (plan + uploads)
    upload_bytes: int = 0    # bytes the delta moved host -> device


class StreamRunner:
    """Keeps a partition fresh over an edge stream, on ``device`` (default
    CUDA; raises when it is unavailable — pass ``device="cpu"`` for the
    plain PyTorch path).

    The runner owns the incremental graph state plus the carried assignment
    (labels, and LA probabilities when the algorithm has them, in original
    vertex order on the host). Each `ingest(delta)` returns a
    `DeltaReport`; `run(stream)` drains an iterator of deltas. It holds
    only the latest delta's layout, whose slabs the next delta rewrites in
    place.

    `algo` names any engine-driven algorithm in the registry;
    `**algo_kwargs` flow into its config dataclass (unknown keys raise
    TypeError), ``chunk_schedule`` and ``staleness_bound`` among them.
    ``mesh``, ``assignment``, ``halo_threshold``, ``halo_granularity``,
    ``hub_replication``, ``hub_quantile`` and ``hub_target_coverage`` are
    `repro`'s (see the module docstring), with its argument errors.

    `trace`, `checkpoint_dir`, `checkpoint_every` (deltas), `resume` and
    `keep_checkpoints` are `repro`'s (see the module docstring).
    """

    def __init__(self, n: int, cfg: StreamConfig, *, algo: str = "revolver",
                 seed: int = 0, device="cuda", mesh=None, assignment="contiguous",
                 halo_threshold: float = DEFAULT_HALO_THRESHOLD,
                 halo_granularity: str = "auto", hub_replication: bool = False,
                 hub_quantile: float = 0.0, hub_target_coverage: Optional[float] = None,
                 trace=None, checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1,
                 resume: bool = False, keep_checkpoints: int = 2, **algo_kwargs):
        self.cfg = cfg
        self.tracer = trace if trace is not None else obs.NULL_TRACER
        self.algo = get_algorithm(algo)
        if not isinstance(self.algo, Algorithm):
            raise ValueError(
                f"{algo!r} runs no supersteps; streaming refinement needs an "
                "engine-driven algorithm")
        if self.algo.init_from_labels is None:
            raise ValueError(f"{algo!r} does not support warm starts")
        if cfg.restream and not self.algo.supports_probs:
            raise ValueError(
                "StreamConfig.restream replays vertices by resetting their LA "
                f"probabilities, which {algo!r} does not carry (use "
                "algo='restream' for a rule with a built-in priority ramp)")
        if cfg.warm_sharpen and not self.algo.supports_probs:
            raise ValueError(
                f"StreamConfig.warm_sharpen needs LA state; {algo!r} has none")
        self.rcfg = self.algo.config_cls(
            k=cfg.k,
            max_steps=cfg.refine_max_steps,
            patience=cfg.refine_patience,
            theta=cfg.theta,
            **algo_kwargs,
        )
        dev = resolve_device(device)
        schedule = getattr(self.rcfg, "chunk_schedule", "sequential")
        sharded = schedule in _SHARDED_SCHEDULES
        if sharded and mesh is None:
            from repro_torch.launch.mesh import make_blocks_mesh

            mesh = make_blocks_mesh(device=dev)
        if mesh is not None and not sharded:
            raise ValueError(
                "mesh is only meaningful with chunk_schedule='sharded'/'halo'/'async'")
        if not sharded and not (isinstance(assignment, str) and assignment == "contiguous"):
            raise ValueError(
                "assignment is only meaningful with chunk_schedule='sharded'/'halo'/'async'")
        if mesh is not None and mesh.home.type != dev.type:
            raise ValueError(f"mesh {mesh} is not on device={device!r}")
        self.mesh = mesh
        self._halo = schedule in ("halo", "async")
        self._halo_threshold = halo_threshold
        if halo_granularity not in ("auto", "block", "vertex"):
            raise ValueError(
                f"halo_granularity={halo_granularity!r} is not one of "
                "('auto', 'block', 'vertex')")
        if halo_granularity != "auto" and not self._halo:
            raise ValueError(
                "halo_granularity is only meaningful with chunk_schedule='halo'")
        if not hub_replication and (hub_quantile or hub_target_coverage is not None):
            raise ValueError("hub_quantile/hub_target_coverage need hub_replication=True")
        if hub_replication and not self._halo:
            raise ValueError(
                "streaming hub replication rides the halo exchange plan; "
                "use chunk_schedule='halo'")
        self._halo_granularity = halo_granularity
        self._hubs = (HubConfig(quantile=hub_quantile, target_coverage=hub_target_coverage)
                      if hub_replication else None)
        self.idg = IncrementalDeviceGraph(
            n, n_blocks=cfg.n_blocks, e_headroom=cfg.e_headroom, mesh=mesh,
            assignment=assignment, device=dev)
        self._gen = make_generator(seed, self.idg.device)
        self.labels: Optional[np.ndarray] = None   # [n] carried labels
        self.probs: Optional[np.ndarray] = None    # carried LA probabilities
        self.reports: List[DeltaReport] = []
        if checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1 (deltas), got {checkpoint_every}")
        if checkpoint_dir is None and resume:
            raise ValueError("resume needs a checkpoint_dir")
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.keep_checkpoints = keep_checkpoints
        self._ckpt_handle: Optional[ckpt_store.Handle] = None
        self.delta_base = 0      # deltas ingested by earlier processes
        self._steps_base = 0     # their supersteps (keeps span numbering and
                                 # total_steps monotonic across a resume)
        if resume:
            self._restore_latest()
        # the async schedule's staleness policy counts supersteps across the
        # stream (from the resumed step count: a resumed runner starts with
        # no tail, and so does every delta's new layout)
        self._async = (AsyncStaleness(self.algo, self.rcfg, g0=self._steps_base,
                                      tracer=self.tracer)
                       if schedule == "async" else None)

    @property
    def schedule(self) -> str:
        return getattr(self.rcfg, "chunk_schedule", "sequential")

    @property
    def total_steps(self) -> int:
        """Supersteps across the whole stream, including deltas ingested
        before a resume (their reports live with the runner that ran them;
        only the counters survive)."""
        return self._steps_base + sum(r.steps for r in self.reports)

    @property
    def deltas_ingested(self) -> int:
        return self.delta_base + len(self.reports)

    def ingest(
        self,
        delta: EdgeDelta,
        *,
        max_steps: Optional[int] = None,
        patience: Optional[int] = None,
    ) -> DeltaReport:
        """Merge one delta and refine. `max_steps` / `patience` override the
        config for this delta only — callers that know the stream's shape
        (e.g. a quiet period ahead, or the initial bulk load) can spend
        their superstep budget unevenly."""
        tracer = self.tracer
        with obs.use(tracer), tracer.span("delta", idx=self.deltas_ingested):
            try:
                return self._ingest(delta, max_steps=max_steps, patience=patience)
            finally:
                # a noted cause no compile consumed must not mis-attribute a
                # later, unrelated one
                tracer.clear_recompile_cause()

    def _layout(self, idx: int):
        """The delta's layout for the configured schedule: the incremental
        layout wrapped by `as_sharded` on a mesh (its plan rebuilt, growth
        past a floor noted as its cause), else as it is. Returns (layout,
        host seconds of the wrap)."""
        idg, tracer = self.idg, self.tracer
        if self.mesh is None:
            return idg.device_graph, 0.0
        t = time.perf_counter()
        prev_b, prev_h, prev_hub = idg.b_max_floor, idg.h_max_floor, idg.hub_pad_floor
        dg = idg.as_sharded(halo=self._halo, halo_threshold=self._halo_threshold,
                            halo_granularity=self._halo_granularity, hubs=self._hubs)
        widened = 0 < prev_b < idg.b_max_floor or 0 < prev_h < idg.h_max_floor
        if self._halo and 0 < prev_hub < idg.hub_pad_floor:
            # the hub region outgrew its padding: new hubs were promoted
            # into every shard's replicated buffer
            tracer.note_recompile_cause("hub-promote")
        elif self._halo and widened:
            tracer.note_recompile_cause("halo-widen")
        return dg, time.perf_counter() - t

    def _ingest(self, delta: EdgeDelta, *, max_steps: Optional[int],
                patience: Optional[int]) -> DeltaReport:
        t0 = time.perf_counter()
        cfg = self.cfg
        tracer = self.tracer
        idx = self.deltas_ingested   # global index across resumes
        faults.fire("delta", idx)
        step0 = self.total_steps     # superstep spans numbered across deltas
        max_steps = cfg.refine_max_steps if max_steps is None else max_steps
        patience = cfg.refine_patience if patience is None else patience
        with tracer.span("merge", idx=idx):
            _, info = self.idg.apply(delta)
            if info.repadded and idx > 0:
                # new device slabs; no kernel is rebuilt for a shape, so the
                # cause attaches only to a kernel build falling in this delta
                tracer.note_recompile_cause("e_max-repad")
            merge_s = time.perf_counter() - t0
            dg, plan_s = self._layout(idx)
        if tracer.enabled:
            tracer.counter("delta_m", info.m, step=idx)
            tracer.counter("delta_added_edges", info.added, step=idx)
            tracer.counter("delta_deleted_edges", info.deleted, step=idx)
            tracer.counter("delta_dirty_blocks", info.dirty_blocks, step=idx)
            if self._halo and dg.halo is not None:
                halo_counters(tracer, self.algo, dg.halo, cfg.k, step=idx)

        gen = self._gen
        with tracer.span("warm-start", idx=idx, cold=self.labels is None):
            if self.labels is None:
                state = self.algo.init(dg, self.rcfg, gen)
            elif self.algo.supports_probs:
                state = self.algo.init_from_labels(
                    dg, self.rcfg, gen, self.labels, probs=self.probs,
                    prob_sharpen=cfg.warm_sharpen)
            else:
                state = self.algo.init_from_labels(dg, self.rcfg, gen, self.labels)
            if self.mesh is not None:
                state = engine.place_state(self.algo, state, dg)

        steps = 0
        if cfg.restream and self.labels is not None:
            state, steps = self._replay_prioritized(dg, state, step0)
        state, refine_steps, converged = run_convergence_loop(
            lambda s: self._superstep(dg, s), state,
            max_steps=max_steps, patience=patience, theta=self.rcfg.theta,
            sync_every=cfg.sync_every, tracer=tracer, step0=step0 + steps)
        steps += refine_steps

        # the carried state crosses the delta boundary in original vertex
        # order (the identity on an unpermuted layout); the metrics read the
        # storage space the labels and dir_* / deg_out share
        self.labels = vertices_to_original(dg, state.labels)[: dg.n].cpu().numpy()
        if self.algo.supports_probs:
            flat = state.probs.reshape(dg.n_pad, cfg.k)
            self.probs = vertices_to_original(dg, flat).reshape(state.probs.shape).cpu().numpy()
        le = float(local_edges(state.labels, dg.dir_src, dg.dir_dst))
        ml = float(max_normalized_load(state.labels, dg.deg_out, cfg.k))
        if tracer.enabled:
            tracer.counter("delta_local_edges", le, step=idx)
            tracer.counter("delta_max_norm_load", ml, step=idx)
            tracer.counter("delta_steps", steps, step=idx)
        report = DeltaReport(
            delta_idx=idx,
            m=info.m,
            added=info.added,
            deleted=info.deleted,
            steps=steps,
            converged=converged,
            local_edges=le,
            max_norm_load=ml,
            dirty_blocks=info.dirty_blocks,
            repadded=info.repadded,
            wall_s=time.perf_counter() - t0,
            merge_s=merge_s,
            plan_s=plan_s,
            upload_bytes=self.idg.upload_bytes,
        )
        self.reports.append(report)
        if tracer.enabled:
            # run manifest: trace_report --validate checks one superstep span
            # per executed step against this
            tracer.meta.setdefault("runs", []).append({
                "algo": self.algo.name, "k": cfg.k, "schedule": self.schedule,
                "delta": idx, "steps": steps})
        if (self.checkpoint_dir is not None
                and self.deltas_ingested % self.checkpoint_every == 0):
            self._save_checkpoint()
        return report

    def run(self, stream: Iterable[EdgeDelta]) -> List[DeltaReport]:
        """Drain an iterator of deltas. On a resumed runner the first
        `delta_base` deltas are skipped — callers replay the *source* stream
        from the top and the runner fast-forwards past what an earlier
        runner already ingested and checkpointed."""
        reports = []
        for i, delta in enumerate(stream):
            if i < self.delta_base:
                continue
            reports.append(self.ingest(delta))
        return reports

    def finish(self):
        """Block until the in-flight async checkpoint write (if any) is
        durable; re-raises writer failures."""
        if self._ckpt_handle is not None:
            self._ckpt_handle.wait()
            self._ckpt_handle = None

    # -- durability ---------------------------------------------------- #

    def _ckpt_meta(self) -> dict:
        idg = self.idg
        return {
            "kind": "stream", "algo": self.algo.name, "k": self.cfg.k,
            "n": idg.n, "m": idg.inc.m,
            "deltas": self.deltas_ingested, "steps": self.total_steps,
            "e_max": idg.e_max, "b_max_floor": idg.b_max_floor,
            "h_max_floor": idg.h_max_floor, "hub_pad_floor": idg.hub_pad_floor,
            "he_max_floor": idg.he_max_floor, "hub_ids": [int(h) for h in idg.hub_ids],
            "perm_decided": idg.perm_decided,
            "n_blocks": idg.n_blocks, "block_v": idg.block_v,
            "device_type": idg.device.type,
        }

    def _save_checkpoint(self):
        """One durable snapshot per `checkpoint_every` deltas: the host-side
        sorted edge arrays, the host copies of the padded block slabs (in
        storage order) and the block permutation, the carried assignment
        (labels + LA probs, original vertex order) and the generator's
        state; the halo plan's floors and hub set ride the metadata.
        Written async (atomic rename underneath); one writer in flight at a
        time."""
        self.finish()
        idg = self.idg
        tree = {
            "gen": self._gen.get_state(),
            "dir_keys": idg.inc.dir_keys,
            "sym_keys": idg.inc.sym_keys,
            "sym_w": idg.inc.sym_w,
            "blk_dst": idg._blk_dst,
            "blk_row": idg._blk_row,
            "blk_w": idg._blk_w,
        }
        if self.labels is not None:
            tree["labels"] = self.labels
        if self.probs is not None:
            tree["probs"] = self.probs
        if idg.block_perm is not None:
            tree["block_perm"] = idg.block_perm
        with self.tracer.span("checkpoint-save", delta=self.deltas_ingested):
            self._ckpt_handle = ckpt_store.save_checkpoint(
                self.checkpoint_dir, self.deltas_ingested, tree,
                async_save=True, meta=self._ckpt_meta(),
                keep=self.keep_checkpoints)
        if self.tracer.enabled:
            self.tracer.counter("stream_checkpoints_saved",
                                float(self.deltas_ingested))

    def _restore_latest(self):
        """Resume from the newest usable checkpoint (corrupt ones and ones
        of another stream skipped). No checkpoint at all -> a fresh stream,
        so the same construction works for the first launch and every
        relaunch."""
        for step in reversed(ckpt_store.all_steps(self.checkpoint_dir)):
            try:
                self._restore(step)
                return
            except (ckpt_store.CheckpointError, ValueError, KeyError) as e:
                _log.warning(
                    "stream checkpoint delta %d in %s unusable (%s); trying "
                    "the previous one", step, self.checkpoint_dir, e)

    def _restore(self, step: int):
        arrays, manifest = ckpt_store.load_checkpoint_arrays(
            self.checkpoint_dir, step)
        meta = manifest.get("meta", {})
        idg = self.idg
        for field, mine in (("algo", self.algo.name), ("k", self.cfg.k),
                            ("n", idg.n), ("n_blocks", idg.n_blocks),
                            ("block_v", idg.block_v)):
            if field in meta and meta[field] != mine:
                raise ValueError(
                    f"stream checkpoint delta {step} belongs to a different "
                    f"stream: {field}={meta[field]!r} vs this runner's {mine!r}")
        # the random state is not shared across device types (nor with
        # `repro`, whose checkpoints carry a threefry key)
        if meta.get("device_type") != idg.device.type:
            raise ValueError(
                f"stream checkpoint delta {step} was written on device type "
                f"{meta.get('device_type')!r}, this runner runs on "
                f"{idg.device.type!r}")
        required = ("gen", "dir_keys", "sym_keys", "sym_w",
                    "blk_dst", "blk_row", "blk_w")
        missing = [k for k in required if k not in arrays]
        if missing:
            raise KeyError(f"stream checkpoint missing arrays: {missing}")
        with self.tracer.span("checkpoint-restore", delta=step):
            deltas = int(meta.get("deltas", step))
            idg.restore(arrays["dir_keys"], arrays["sym_keys"], arrays["sym_w"],
                        arrays["blk_dst"], arrays["blk_row"], arrays["blk_w"],
                        deltas_applied=deltas, block_perm=arrays.get("block_perm"),
                        perm_decided=bool(meta.get("perm_decided", True)),
                        floors={f: meta.get(f"{f}_floor", 0)
                                for f in ("b_max", "h_max", "hub_pad", "he_max")},
                        hub_ids=meta.get("hub_ids", ()))
            gen = torch.Generator(device=idg.device)
            gen.set_state(torch.from_numpy(arrays["gen"].copy()))
            self._gen = gen
            self.labels = arrays["labels"].copy() if "labels" in arrays else None
            self.probs = arrays["probs"].copy() if "probs" in arrays else None
            self.delta_base = deltas
            self._steps_base = int(meta.get("steps", 0))
        if self.tracer.enabled:
            self.tracer.instant("resumed", delta=self.delta_base)
        _log.info("resumed stream at delta %d (%d supersteps) from %s",
                  self.delta_base, self._steps_base, self.checkpoint_dir)

    def _superstep(self, dg, state):
        """One refine superstep under the configured schedule (the async
        one through the stream's staleness policy)."""
        if self._async is not None:
            return self._async.step(dg, state)
        return engine.superstep(self.algo, dg, self.rcfg, state)

    def _replay_prioritized(self, dg, state, step0: int = 0) -> Tuple[object, int]:
        """Restream pass: reset the LA state of high-degree vertices in
        priority-ordered chunks, letting each chunk re-decide before the
        next is released (high-degree-first, per the restreaming paper)."""
        cfg = self.cfg
        n_replay = int(cfg.restream_frac * dg.n)
        if n_replay == 0:
            return state, 0
        # the priority order as `repro` takes it: a stable sort of the whole
        # padded degree vector in storage order (real vertices are not a
        # prefix under a permuted assignment; padding has degree 0), from
        # the layout's host copy; the picks are storage ids, as the probs'
        order = np.argsort(-self.idg.deg_host, kind="stable")[:n_replay]
        chunks = np.array_split(order, min(cfg.restream_chunks, n_replay))
        steps = 0
        for chunk in chunks:
            # in place: the rule updates the state's probs tensor in place too
            state.probs.view(dg.n_pad, cfg.k)[torch.from_numpy(chunk).to(dg.device)] = 1.0 / cfg.k
            for _ in range(cfg.restream_steps_per_chunk):
                with self.tracer.span("superstep", step=step0 + steps, replay=True):
                    state = self._superstep(dg, state)
                steps += 1
        return state, steps
