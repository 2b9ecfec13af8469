"""Host-side tracing + metrics for the port's partitioner engine.

The port of `repro.obs.tracer`. The engine dispatches supersteps without
blocking and fetches scores in `sync_every`-sized windows, so the honest
places to *measure* are the host-visible boundaries — superstep dispatch,
the windowed fetch, layout builds, kernel builds — plus per-superstep
scalars that ride the existing fetch windows. This module records exactly
those:

  * **Spans** — nested wall-clock regions (`Tracer.span`) emitted as
    Chrome/perfetto trace-event JSON (`Tracer.save`, load the file at
    https://ui.perfetto.dev). Spans opened with `annotate` around a
    kernel's call (edge-phase, la-update) time its host *dispatch*: on
    CUDA the launch returns before the kernel runs, so they are tagged
    ``during="dispatch"``. `annotate` also opens a
    `torch.profiler.record_function` and, on a CUDA machine, an NVTX range,
    so the same names line up in a `torch.profiler` or Nsight trace, where
    the *device* time of the region lives.
  * **Counters** — per-superstep series (`Tracer.counter`) emitted as
    trace-event counter tracks and retained in `Tracer.series`.
  * **Compile events** — the port compiles nothing per shape; its one
    compile is a kernel's first-use ``nvcc`` build
    (`repro_torch.kernels._build`), which calls `record_compile` with the
    kernel's name. The cause attribution is `repro`'s: ``first-compile``
    per region, a pre-registered cause (`note_recompile_cause`), or the
    diff of the arguments against the region's previous event.

Overhead contract: the default `NULL_TRACER` leaves every instrumented path
bit-identical and adds no work — `span` / `annotate` return a shared no-op
context manager and every recording method is a pass. An enabled tracer
adds host timestamps, one device comparison per superstep for the
migration counter, and counter values that ride the *existing* fetch
windows. Nothing here synchronizes the device or reads a tensor.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

_NULL_CTX = contextlib.nullcontext()


class NullTracer:
    """Default tracer: records nothing, costs (almost) nothing.

    Kept API-compatible with `Tracer` so instrumented code never branches
    on the tracer kind — it just calls the method.
    """

    enabled = False

    def span(self, name: str, **args):
        return _NULL_CTX

    def annotate(self, name: str, **args):
        return _NULL_CTX

    def instant(self, name: str, **args) -> None:
        pass

    def counter(self, name: str, value, step: Optional[int] = None,
                ts: Optional[float] = None) -> None:
        pass

    def compile_event(self, region: str, **args) -> None:
        pass

    def note_recompile_cause(self, cause: str) -> None:
        pass

    def clear_recompile_cause(self) -> None:
        pass

    def now_us(self) -> float:
        return 0.0


NULL_TRACER = NullTracer()


class Tracer:
    """Collects spans/counters/events and exports perfetto-loadable JSON.

    One `Tracer` spans one logical run (a `run_partitioner` call, a whole
    stream, a CLI invocation with several algorithms); pass it via
    ``run_partitioner(trace=...)`` / ``StreamRunner(trace=...)`` /
    ``launch partition --trace PATH`` and call `save(path)` at the end.

    `xprof=True` (default) additionally opens
    `torch.profiler.record_function` (and, where CUDA is available, an NVTX
    range) inside `annotate`, so span names appear in `torch.profiler` and
    Nsight traces.
    """

    enabled = True

    def __init__(self, *, xprof: bool = True):
        self.events: List[Dict[str, Any]] = []
        # counter name -> [(step, value)]; step is None for run-level gauges
        self.series: Dict[str, List[Tuple[Optional[int], float]]] = {}
        self.recompiles: List[Dict[str, Any]] = []
        self.meta: Dict[str, Any] = {}
        self._pid = os.getpid()
        self._t0 = time.perf_counter_ns()
        self._pending_causes: List[str] = []
        self._last_compile_args: Dict[str, Dict[str, Any]] = {}
        self._xprof = xprof
        self._nvtx = xprof and torch.cuda.is_available()

    # ------------------------------------------------------------------ #
    # clocks / event plumbing
    # ------------------------------------------------------------------ #
    def now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    def _emit(self, ev: Dict[str, Any]) -> None:
        ev.setdefault("pid", self._pid)
        ev.setdefault("tid", threading.get_ident() & 0xFFFF)
        self.events.append(ev)

    # ------------------------------------------------------------------ #
    # spans
    # ------------------------------------------------------------------ #
    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Record a complete ("X") span around the enclosed block."""
        ts = self.now_us()
        try:
            yield self
        finally:
            self._emit({"ph": "X", "name": name, "ts": ts,
                        "dur": self.now_us() - ts,
                        "args": args or {}})

    @contextlib.contextmanager
    def annotate(self, name: str, **args):
        """Span around a kernel's call (or any region of a rule).

        On CUDA the call returns once the kernel is enqueued, so the span
        is the host *dispatch* time (tagged ``during="dispatch"``); the
        `record_function` / NVTX side makes the same name show up in
        profiler traces, where the region's device time lives.
        """
        args = dict(args, during="dispatch")
        if not self._xprof:
            with self.span(name, **args):
                yield self
            return
        if self._nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            with torch.profiler.record_function(name), self.span(name, **args):
                yield self
        finally:
            if self._nvtx:
                torch.cuda.nvtx.range_pop()

    def instant(self, name: str, **args) -> None:
        self._emit({"ph": "i", "s": "t", "name": name, "ts": self.now_us(),
                    "args": args or {}})

    # ------------------------------------------------------------------ #
    # counters
    # ------------------------------------------------------------------ #
    def counter(self, name: str, value, step: Optional[int] = None,
                ts: Optional[float] = None) -> None:
        """Record one point of a counter track.

        `step` indexes the superstep (or delta) the value belongs to and is
        retained in `series`; `ts` back-dates the trace event to when the
        value was *produced* (the superstep's dispatch), not when it was
        drained — counters ride the windowed sync, so the two differ by up
        to `sync_every` supersteps.
        """
        value = float(value)
        self.series.setdefault(name, []).append((step, value))
        ev: Dict[str, Any] = {"ph": "C", "name": name,
                              "ts": self.now_us() if ts is None else ts,
                              "args": {"value": value}}
        self._emit(ev)

    # ------------------------------------------------------------------ #
    # recompile events
    # ------------------------------------------------------------------ #
    def note_recompile_cause(self, cause: str) -> None:
        """Pre-register the semantic cause of the *next* compile event —
        callers that change shapes knowingly (streaming `e_max` re-pad)
        call this right before dispatching on the new layout. Consumed by the next `compile_event`; cleared by
        `clear_recompile_cause` if no compile fired (a stale cause must not
        mis-attribute a later, unrelated recompile)."""
        if cause not in self._pending_causes:
            self._pending_causes.append(cause)

    def clear_recompile_cause(self) -> None:
        self._pending_causes = []

    def compile_event(self, region: str, **args) -> None:
        """Called (via `obs.record_compile`) once per compile — in the port,
        a kernel's first use in a process. Attributes a cause:
        pre-registered > first-compile > inferred argument diff."""
        prev = self._last_compile_args.get(region)
        if self._pending_causes:
            cause = "+".join(self._pending_causes)
            self._pending_causes = []
        elif prev is None:
            cause = "first-compile"
        else:
            changed = sorted(k for k in set(prev) | set(args)
                             if prev.get(k) != args.get(k))
            cause = ("shape-change(" + ",".join(changed) + ")"
                     if changed else "unattributed")
        self._last_compile_args[region] = dict(args)
        rec = {"region": region, "cause": cause, **args}
        self.recompiles.append(rec)
        self.instant("recompile", **rec)
        self.counter("recompiles", len(self.recompiles))

    # ------------------------------------------------------------------ #
    # export / summaries
    # ------------------------------------------------------------------ #
    def to_dict(self) -> Dict[str, Any]:
        return {
            "traceEvents": self.events,
            "displayTimeUnit": "ms",
            "otherData": dict(self.meta),
        }

    def save(self, path: str) -> str:
        """Write perfetto/chrome trace-event JSON (open at ui.perfetto.dev
        or chrome://tracing)."""
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
        return path

    def summary(self) -> Dict[str, Any]:
        """Aggregates for bench artifacts: per-span totals, counter
        min/max/last, recompile causes. No raw series (those stay in
        `series` / the saved trace)."""
        spans: Dict[str, Dict[str, float]] = {}
        for ev in self.events:
            if ev.get("ph") != "X":
                continue
            agg = spans.setdefault(ev["name"], {"count": 0, "total_ms": 0.0})
            agg["count"] += 1
            agg["total_ms"] += ev.get("dur", 0.0) / 1e3
        counters = {
            name: {
                "points": len(pts),
                "last": pts[-1][1],
                "min": min(v for _, v in pts),
                "max": max(v for _, v in pts),
            }
            for name, pts in self.series.items() if pts
        }
        causes: Dict[str, int] = {}
        for rec in self.recompiles:
            causes[rec["cause"]] = causes.get(rec["cause"], 0) + 1
        return {
            "spans": {k: {"count": v["count"],
                          "total_ms": round(v["total_ms"], 3)}
                      for k, v in sorted(spans.items())},
            "counters": counters,
            "recompiles": len(self.recompiles),
            "recompile_causes": causes,
        }


# ---------------------------------------------------------------------------
# current-tracer plumbing (module-global, as in `repro`: the rule modules and
# the kernel builder take no tracer argument)
# ---------------------------------------------------------------------------
_current: Any = NULL_TRACER


def current():
    """The active tracer (`NULL_TRACER` unless inside a `use` block)."""
    return _current


@contextlib.contextmanager
def use(tracer):
    """Install `tracer` as the current tracer for the enclosed block (pass
    None for the no-op tracer). Entry points (`run_partitioner`,
    `StreamRunner.ingest`) wrap their whole body in this so engine- and
    rule-level instrumentation sees the caller's tracer."""
    global _current
    prev = _current
    _current = tracer if tracer is not None else NULL_TRACER
    try:
        yield _current
    finally:
        _current = prev


def annotate(name: str, **args):
    """`current().annotate(...)` — the form the rule modules use."""
    return _current.annotate(name, **args)


def record_compile(region: str = "superstep", **args) -> None:
    """Record a compile event with attributed cause (the kernel builder
    calls it once per kernel and process). No-op when tracing is off."""
    if _current.enabled:
        _current.compile_event(region, **args)
