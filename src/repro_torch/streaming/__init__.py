"""Streaming graph ingestion + incremental repartitioning (the port of
`repro.streaming`, sequential schedule on one device).

Lifecycle: **delta -> merge -> warm-start -> refine**.

  * `stream` — `EdgeDelta` batches, the `StreamBuffer` front door, and
    `stream_from_graph` to replay any static dataset as a timestamped stream;
  * `delta_graph` — `IncrementalGraph` (sorted-key CSR maintenance, O(m + d
    log m) per delta) and `IncrementalDeviceGraph` (device-resident slabs,
    dirty-block rewrites with their row pointers and span plan, headroom
    re-pads);
  * `runner` — `StreamRunner`, which warm-starts any registered engine
    algorithm (`algo="revolver"` default) from the carried labels — plus LA
    probabilities where the rule has them — after each merge and refines
    for a handful of supersteps, with an optional prioritized
    (high-degree-first) restream pass.
"""
from repro_torch.streaming.stream import EdgeDelta, StreamBuffer, stream_from_graph
from repro_torch.streaming.delta_graph import (
    IncrementalDeviceGraph,
    IncrementalGraph,
    MergeInfo,
)
from repro_torch.streaming.runner import DeltaReport, StreamConfig, StreamRunner

__all__ = [
    "EdgeDelta",
    "StreamBuffer",
    "stream_from_graph",
    "IncrementalGraph",
    "IncrementalDeviceGraph",
    "MergeInfo",
    "StreamConfig",
    "StreamRunner",
    "DeltaReport",
]
