"""Deterministic synthetic data pipeline (per-host sharded, prefetched).

The port's own copy of `repro.data.pipeline` (numpy only): its batches are
bit-equal to `repro`'s for the same (seed, host_id, step). The trainer
moves them to its device.

Tokens follow a noisy affine bigram process: next = (a*prev + b + U[0,K))
mod V_eff. A model that learns the bigram structure reaches ~log(K) CE,
far below the log(V_eff) unigram floor — so example training runs show
real learning without any external corpus.

Determinism & fault tolerance: a batch is a pure function of
(seed, host_id, step); recovery after preemption needs no pipeline
state — the trainer just re-asks for step s.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    batch_per_host: int
    seed: int = 0
    v_eff: int = 4096            # active vocabulary subset
    noise_k: int = 8             # bigram fan-out (CE floor = log(noise_k))
    frontend: tuple | None = None  # (n, d) stub patch/frame embeddings


def _rng(cfg: DataConfig, host_id: int, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, host_id, step]))


def make_batch(cfg: DataConfig, step: int, host_id: int = 0) -> dict:
    """{"tokens": [B,S] i32, "labels": [B,S] i32, ("frontend": [B,n,d])}."""
    rng = _rng(cfg, host_id, step)
    v = min(cfg.v_eff, cfg.vocab)
    b, s = cfg.batch_per_host, cfg.seq_len
    a_mul = 31
    toks = np.empty((b, s + 1), np.int64)
    toks[:, 0] = rng.integers(0, v, size=b)
    noise = rng.integers(0, cfg.noise_k, size=(b, s))
    for t in range(s):
        toks[:, t + 1] = (a_mul * toks[:, t] + 7 + noise[:, t]) % v
    out = {"tokens": toks[:, :-1].astype(np.int32),
           "labels": toks[:, 1:].astype(np.int32)}
    if cfg.frontend is not None:
        n, d = cfg.frontend
        out["frontend"] = rng.standard_normal((b, n, d), dtype=np.float32)
    return out


class PrefetchLoader:
    """Iterator yielding (step, batch) with a background prefetch thread."""

    def __init__(self, cfg: DataConfig, *, host_id: int = 0,
                 start_step: int = 0, prefetch: int = 2):
        self.cfg = cfg
        self.host_id = host_id
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = make_batch(self.cfg, step, self.host_id)
            self._q.put((step, batch))
            step += 1

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
