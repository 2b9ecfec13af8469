"""Observability of the port: superstep tracing, engine counters, perfetto
export (the port of `repro.obs`; the span taxonomy, counter names and the
JSON layout are `repro`'s, so `tools/trace_report.py` reads both)."""
from repro_torch.obs.tracer import (
    NULL_TRACER,
    NullTracer,
    Tracer,
    annotate,
    current,
    record_compile,
    use,
)

__all__ = [
    "NULL_TRACER",
    "NullTracer",
    "Tracer",
    "annotate",
    "current",
    "record_compile",
    "use",
]
