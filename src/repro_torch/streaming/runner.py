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

Restream mode (`StreamConfig.restream=True`) follows the prioritized
restreaming idea (Awadelkarim & Ugander): after each merge the
highest-degree vertices are replayed in priority-ordered chunks. Replaying
a chunk resets its vertices' LA probabilities to uniform and runs a couple
of supersteps before the next chunk; then the normal refine loop finishes
the pass. (It requires a probs-carrying algorithm; with
``algo="restream"`` the degree-priority ramp is built into the rule
itself.)

What waits for later slices, and raises NotImplementedError when asked for:
tracing, stream checkpoints and resume (ROADMAP queue 1 item 8, which also
brings `repro`'s fault-injection hook), and the mesh, assignment, halo and
hub options and every schedule but the sequential one (item 9).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.metrics import local_edges, max_normalized_load
from repro_torch.core.registry import Algorithm, get_algorithm
from repro_torch.core.revolver import make_generator
from repro_torch.core.runner import _UNPORTED, reject_unported, run_convergence_loop
from repro_torch.streaming.delta_graph import IncrementalDeviceGraph
from repro_torch.streaming.stream import EdgeDelta

_ITEM8 = "queue 1 item 8 (observability and checkpoints)"
# StreamRunner keywords of `repro` that are not ported yet: name -> (the
# value that means "off", the ROADMAP queue item that ports it); the
# schedule knobs are config kwargs there
_STREAM_UNPORTED = {
    **{f: _UNPORTED[f] for f in (
        "chunk_schedule", "staleness_bound", "mesh", "assignment", "halo_threshold",
        "halo_granularity", "hub_replication", "hub_quantile", "hub_target_coverage")},
    "trace": (None, _ITEM8),
    "checkpoint_dir": (None, _ITEM8),
    "checkpoint_every": (1, _ITEM8),
    "resume": (False, _ITEM8),
    "keep_checkpoints": (2, _ITEM8),
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
    """

    def __init__(self, n: int, cfg: StreamConfig, *, algo: str = "revolver",
                 seed: int = 0, device="cuda", **algo_kwargs):
        reject_unported(algo_kwargs, _STREAM_UNPORTED, "StreamRunner")
        self.cfg = cfg
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

    @property
    def total_steps(self) -> int:
        """Supersteps across the whole stream."""
        return sum(r.steps for r in self.reports)

    @property
    def deltas_ingested(self) -> int:
        return len(self.reports)

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
        t0 = time.perf_counter()
        cfg = self.cfg
        max_steps = cfg.refine_max_steps if max_steps is None else max_steps
        patience = cfg.refine_patience if patience is None else patience
        dg, info = self.idg.apply(delta)
        merge_s = time.perf_counter() - t0

        gen = self._gen
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
            state, steps = self._replay_prioritized(dg, state)
        state, refine_steps, converged = run_convergence_loop(
            lambda s: engine.superstep(self.algo, dg, self.rcfg, s), state,
            max_steps=max_steps, patience=patience, theta=self.rcfg.theta,
            sync_every=cfg.sync_every)
        steps += refine_steps

        self.labels = state.labels[: dg.n].cpu().numpy()
        if self.algo.supports_probs:
            self.probs = state.probs.cpu().numpy()
        report = DeltaReport(
            delta_idx=self.deltas_ingested,
            m=info.m,
            added=info.added,
            deleted=info.deleted,
            steps=steps,
            converged=converged,
            local_edges=float(local_edges(state.labels, dg.dir_src, dg.dir_dst)),
            max_norm_load=float(max_normalized_load(state.labels, dg.deg_out, cfg.k)),
            dirty_blocks=info.dirty_blocks,
            repadded=info.repadded,
            wall_s=time.perf_counter() - t0,
            merge_s=merge_s,
        )
        self.reports.append(report)
        return report

    def run(self, stream: Iterable[EdgeDelta]) -> List[DeltaReport]:
        """Drain an iterator of deltas."""
        return [self.ingest(delta) for delta in stream]

    def _replay_prioritized(self, dg, state) -> Tuple[object, int]:
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
                state = engine.superstep(self.algo, dg, self.rcfg, state)
                steps += 1
        return state, steps
