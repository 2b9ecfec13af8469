"""Edge-stream ingestion: timestamped arrivals batched into fixed-size deltas.

The port's copy of `repro.streaming.stream` (numpy only, unchanged but for
the `Graph` it imports).

The cloud workload the ROADMAP targets does not hand us a finished graph: it
hands us an unbounded sequence of edge events (a follow, a hyperlink, a new
RPC dependency), occasionally retractions. This module is the thin front door
of the streaming subsystem:

  * `EdgeDelta` — one immutable batch of insertions (+ optional deletions),
    the unit everything downstream consumes;
  * `StreamBuffer` — accumulates arriving events and emits a delta every
    `delta_size` insertions (cloud ingestion loops call `push` from their
    event source and drain `pop_delta`);
  * `stream_from_graph` — replays a static benchmark graph as a timestamped
    stream (each directed edge gets a pseudo-arrival time), so any Table-I
    dataset doubles as a streaming workload.
"""
from __future__ import annotations

from typing import Iterator, List, NamedTuple, Optional

import numpy as np

from repro_torch.graphs.csr import Graph


class EdgeDelta(NamedTuple):
    """One batch of edge events. Arrays are int32 vertex ids, equal lengths
    within each (add, delete) pair; deletions may be empty."""

    add_src: np.ndarray
    add_dst: np.ndarray
    del_src: np.ndarray
    del_dst: np.ndarray

    @property
    def n_add(self) -> int:
        return int(self.add_src.shape[0])

    @property
    def n_del(self) -> int:
        return int(self.del_src.shape[0])

    @staticmethod
    def inserts(src: np.ndarray, dst: np.ndarray) -> "EdgeDelta":
        empty = np.empty(0, dtype=np.int32)
        return EdgeDelta(
            add_src=np.asarray(src, dtype=np.int32),
            add_dst=np.asarray(dst, dtype=np.int32),
            del_src=empty,
            del_dst=empty,
        )


class StreamBuffer:
    """Accumulate edge events; emit an `EdgeDelta` per `delta_size` inserts.

    Events are kept in arrival order, and emission preserves per-edge
    event order. `EdgeDelta` semantics apply deletions before insertions,
    so a delta must never contain a deletion of an edge inserted *earlier
    in the same window* (the pair would resolve present instead of absent)
    — when such a conflict arises the window is cut short and the deletion
    (plus everything after it) waits for the next delta. A delta may
    therefore carry fewer than `delta_size` insertions; `flush` drains the
    longest order-preserving prefix and is called repeatedly until None.
    """

    def __init__(self, delta_size: int, *, n: Optional[int] = None):
        if delta_size <= 0:
            raise ValueError(f"delta_size must be positive, got {delta_size}")
        if n is not None and n <= 0:
            raise ValueError(f"vertex space must be positive, got {n}")
        self.delta_size = delta_size
        self.n = n          # optional vertex-space bound checked at push
        # arrival-ordered (src, dst, is_delete) chunks
        self._events: List[tuple] = []
        self._n_add = 0
        self._pushed = 0    # events accepted so far (error attribution)

    def _as_ids(self, name: str, a) -> np.ndarray:
        """Validate one endpoint array at the front door. A stream source
        feeding garbage (sensor NaNs, floats, ids outside the declared
        vertex space) should fail loudly here, at the event that carried
        it, not as a corrupt partition three subsystems later."""
        a = np.atleast_1d(np.asarray(a))
        where = f"{name} in push #{self._pushed}"
        if a.dtype.kind == "f":
            if not np.isfinite(a).all():
                raise ValueError(f"{where} contains NaN/inf edge data")
            if np.any(a != np.floor(a)):
                raise ValueError(
                    f"{where} has non-integral float vertex ids")
        elif a.dtype.kind not in "iu":
            raise ValueError(
                f"{where} has non-numeric dtype {a.dtype} for vertex ids")
        if a.size and int(a.min()) < 0:
            raise ValueError(
                f"{where} contains negative vertex ids (min {int(a.min())})")
        if self.n is not None and a.size and int(a.max()) >= self.n:
            raise ValueError(
                f"{where} contains vertex ids >= n={self.n} "
                f"(max {int(a.max())})")
        return a.astype(np.int32)

    def push(self, src, dst, *, delete: bool = False) -> None:
        """Buffer one event or a vector of events. Malformed events —
        shape or dtype-kind mismatch between src and dst, NaN/inf data,
        negative or (when `n` was declared) out-of-range vertex ids —
        raise ValueError naming the offending push."""
        src_raw = np.atleast_1d(np.asarray(src))
        dst_raw = np.atleast_1d(np.asarray(dst))
        if src_raw.dtype.kind != dst_raw.dtype.kind:
            raise ValueError(
                f"src/dst dtype mismatch in push #{self._pushed}: "
                f"{src_raw.dtype} vs {dst_raw.dtype}")
        src = self._as_ids("src", src_raw)
        dst = self._as_ids("dst", dst_raw)
        if src.shape != dst.shape:
            raise ValueError(
                f"src/dst shape mismatch in push #{self._pushed}: "
                f"{src.shape} vs {dst.shape}")
        self._pushed += 1
        if src.shape[0] == 0:
            return
        self._events.append((src, dst, delete))
        if not delete:
            self._n_add += src.shape[0]

    def ready(self) -> bool:
        return self._n_add >= self.delta_size

    def pop_delta(self) -> Optional[EdgeDelta]:
        """Emit up to the oldest `delta_size` insertions (+ the deletions
        interleaved with them), or None if fewer insertions are buffered.
        May emit fewer insertions when an insert/delete conflict cuts the
        window (see class docstring)."""
        if not self.ready():
            return None
        return self._emit(self.delta_size)

    def flush(self) -> Optional[EdgeDelta]:
        """Emit the longest order-preserving prefix of what is buffered
        (end-of-stream); call repeatedly until it returns None."""
        if not self._events:
            return None
        return self._emit(None)

    @staticmethod
    def _pack(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        return (src.astype(np.int64) << 32) | dst.astype(np.int64)

    def _emit(self, take: Optional[int]) -> EdgeDelta:
        """Drain events in arrival order until `take` insertions are
        consumed (None = drain everything), cutting the window before any
        deletion that targets an edge inserted earlier in it."""
        adds: List[tuple] = []
        dels: List[tuple] = []
        taken = 0
        rest: List[tuple] = []
        for i, (src, dst, is_del) in enumerate(self._events):
            if take is not None and taken >= take:
                rest = self._events[i:]
                break
            if is_del:
                if adds and np.isin(
                    self._pack(src, dst),
                    np.concatenate([self._pack(a[0], a[1]) for a in adds]),
                ).any():
                    rest = self._events[i:]
                    break
                dels.append((src, dst))
                continue
            need = src.shape[0] if take is None else min(src.shape[0], take - taken)
            adds.append((src[:need], dst[:need]))
            taken += need
            if need < src.shape[0]:
                rest = [(src[need:], dst[need:], False)] + self._events[i + 1:]
                break
        self._events = rest
        self._n_add -= taken

        empty = np.empty(0, dtype=np.int32)
        return EdgeDelta(
            add_src=np.concatenate([a[0] for a in adds]) if adds else empty,
            add_dst=np.concatenate([a[1] for a in adds]) if adds else empty,
            del_src=np.concatenate([d[0] for d in dels]) if dels else empty,
            del_dst=np.concatenate([d[1] for d in dels]) if dels else empty,
        )


def stream_from_graph(
    g: Graph,
    n_deltas: int,
    *,
    order: str = "timestamp",
    seed: int = 0,
) -> Iterator[EdgeDelta]:
    """Replay a static graph's directed edges as `n_deltas` insertion batches.

    order:
      "timestamp" — edges get a random pseudo-arrival time (the usual model
                    for benchmark graphs without real timestamps);
      "arrival"   — CSR order (all of vertex 0's out-edges first, ...), a
                    pathological best case for locality;
    """
    src = np.repeat(
        np.arange(g.n, dtype=np.int32), np.diff(g.row_ptr).astype(np.int64)
    )
    dst = g.col_idx.astype(np.int32, copy=True)
    if order == "timestamp":
        perm = np.random.default_rng(seed).permutation(g.m)
        src, dst = src[perm], dst[perm]
    elif order != "arrival":
        raise ValueError(f"unknown stream order {order!r}")

    n_deltas = max(1, min(n_deltas, max(g.m, 1)))
    bounds = np.linspace(0, g.m, n_deltas + 1).astype(np.int64)
    for i in range(n_deltas):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        yield EdgeDelta.inserts(src[lo:hi], dst[lo:hi])
