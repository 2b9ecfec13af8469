"""Minimal structured logger (stdout CSV/JSONL) used by trainer & benchmarks."""
from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Optional, TextIO


class MetricLogger:
    """Append-only JSONL metric logger with wall-clock stamps.

    Used by the trainer, the partitioner runner, and the benchmark harness so
    every experiment leaves a machine-readable trace.
    """

    def __init__(self, path: Optional[str] = None, stream: Optional[TextIO] = None):
        self._fh = open(path, "a") if path else None
        self._stream = stream if stream is not None else sys.stdout
        self._t0 = time.time()

    def log(self, tag: str, **metrics: Any) -> Dict[str, Any]:
        rec = {"tag": tag, "t": round(time.time() - self._t0, 4), **metrics}
        line = json.dumps(rec, default=float)
        if self._fh is not None:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._stream is not None:
            print(line, file=self._stream, flush=True)
        return rec

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
