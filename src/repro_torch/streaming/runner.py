"""StreamRunner: ingest -> warm-start refine -> metrics, per delta.

The port of `repro.streaming.runner` for the sequential schedule on one
device. The streaming lifecycle:

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

What waits for a later slice, and raises NotImplementedError when asked
for: the mesh, assignment, halo and hub options and every schedule but the
sequential one (ROADMAP queue 1 item 9, slice B: the stream's sharded
layouts).
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
from repro_torch.core.metrics import local_edges, max_normalized_load
from repro_torch.core.registry import Algorithm, get_algorithm
from repro_torch.core.revolver import make_generator
from repro_torch.core.runner import reject_unported, run_convergence_loop
from repro_torch.streaming.delta_graph import IncrementalDeviceGraph
from repro_torch.streaming.stream import EdgeDelta

_log = logging.getLogger("repro_torch.streaming")

_ITEM9 = "queue 1 item 9, slice B (the stream's sharded layouts)"
# StreamRunner options of `repro` that are not ported yet (the stream's
# sharded, halo, locality and hub layouts come with item 9's slice B):
# name -> (the value that means "off", the ROADMAP queue item that ports it)
_UNPORTED = {
    "chunk_schedule": ("sequential", _ITEM9),
    "mesh": (None, _ITEM9),
    "assignment": ("contiguous", _ITEM9),
    "halo_threshold": (None, _ITEM9),
    "halo_granularity": ("auto", _ITEM9),
    "hub_replication": (False, _ITEM9),
    "hub_quantile": (0.0, _ITEM9),
    "hub_target_coverage": (None, _ITEM9),
    "staleness_bound": (0, _ITEM9),
}


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


class StreamRunner:
    """Keeps a partition fresh over an edge stream, on ``device`` (default
    CUDA; raises when it is unavailable — pass ``device="cpu"`` for the
    plain PyTorch path).

    The runner owns the incremental graph state plus the carried assignment
    (labels, and LA probabilities when the algorithm has them, in vertex
    order on the host). Each `ingest(delta)` returns a `DeltaReport`;
    `run(stream)` drains an iterator of deltas. It holds only the latest
    delta's `DeviceGraph`, whose slabs the next delta rewrites in place.

    `algo` names any engine-driven algorithm in the registry;
    `**algo_kwargs` flow into its config dataclass (unknown keys raise
    TypeError; `repro`'s options that are not ported yet raise
    NotImplementedError unless they carry their "off" value).

    `trace`, `checkpoint_dir`, `checkpoint_every` (deltas), `resume` and
    `keep_checkpoints` are `repro`'s (see the module docstring).
    """

    def __init__(self, n: int, cfg: StreamConfig, *, algo: str = "revolver",
                 seed: int = 0, device="cuda", trace=None,
                 checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1,
                 resume: bool = False, keep_checkpoints: int = 2, **algo_kwargs):
        # the schedule knobs are config kwargs in `repro`, the others
        # StreamRunner keywords
        reject_unported(algo_kwargs, _UNPORTED, "StreamRunner")
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
        self.idg = IncrementalDeviceGraph(
            n, n_blocks=cfg.n_blocks, e_headroom=cfg.e_headroom, device=device)
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
            dg, info = self.idg.apply(delta)
            if info.repadded and idx > 0:
                # new device slabs; no kernel is rebuilt for a shape, so the
                # cause attaches only to a kernel build falling in this delta
                tracer.note_recompile_cause("e_max-repad")
        merge_s = time.perf_counter() - t0
        if tracer.enabled:
            tracer.counter("delta_m", info.m, step=idx)
            tracer.counter("delta_added_edges", info.added, step=idx)
            tracer.counter("delta_deleted_edges", info.deleted, step=idx)
            tracer.counter("delta_dirty_blocks", info.dirty_blocks, step=idx)

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

        steps = 0
        if cfg.restream and self.labels is not None:
            state, steps = self._replay_prioritized(dg, state, step0)
        state, refine_steps, converged = run_convergence_loop(
            lambda s: engine.superstep(self.algo, dg, self.rcfg, s), state,
            max_steps=max_steps, patience=patience, theta=self.rcfg.theta,
            sync_every=cfg.sync_every, tracer=tracer, step0=step0 + steps)
        steps += refine_steps

        self.labels = state.labels[: dg.n].cpu().numpy()
        if self.algo.supports_probs:
            self.probs = state.probs.cpu().numpy()
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
        )
        self.reports.append(report)
        if tracer.enabled:
            # run manifest: trace_report --validate checks one superstep span
            # per executed step against this
            tracer.meta.setdefault("runs", []).append({
                "algo": self.algo.name, "k": cfg.k, "schedule": "sequential",
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
            "e_max": idg.e_max, "n_blocks": idg.n_blocks, "block_v": idg.block_v,
            "device_type": idg.device.type,
        }

    def _save_checkpoint(self):
        """One durable snapshot per `checkpoint_every` deltas: the host-side
        sorted edge arrays, the host copies of the padded block slabs, the
        carried assignment (labels + LA probs) and the generator's state.
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
                        deltas_applied=deltas)
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

    def _replay_prioritized(self, dg, state, step0: int = 0) -> Tuple[object, int]:
        """Restream pass: reset the LA state of high-degree vertices in
        priority-ordered chunks, letting each chunk re-decide before the
        next is released (high-degree-first, per the restreaming paper)."""
        cfg = self.cfg
        n_replay = int(cfg.restream_frac * dg.n)
        if n_replay == 0:
            return state, 0
        # the priority order as `repro` takes it: a stable sort on the host
        order = np.argsort(-dg.deg_out.cpu().numpy(), kind="stable")[:n_replay]
        chunks = np.array_split(order, min(cfg.restream_chunks, n_replay))
        steps = 0
        for chunk in chunks:
            # in place: the rule updates the state's probs tensor in place too
            state.probs.view(dg.n_pad, cfg.k)[torch.from_numpy(chunk).to(dg.device)] = 1.0 / cfg.k
            for _ in range(cfg.restream_steps_per_chunk):
                with self.tracer.span("superstep", step=step0 + steps, replay=True):
                    state = engine.superstep(self.algo, dg, self.rcfg, state)
                steps += 1
        return state, steps
