"""Reading a `torch.profiler` trace of whole jobs: device busy time, device
time by kernel, and the longest idle gaps with what the host was doing.

The busy time is the union of the device's operation spans (kernels,
copies, fills), so overlapping operations count once; it is measured
against the host wall of the profiled jobs, each of which ends with its
labels on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

NAME_CHARS = 100     # templated kernel names run to kilobytes


def _is_transfer(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def raw_events(prof) -> Tuple[list, list]:
    """(device operations, host operations) of a finished `torch.profiler`
    run, each a list of (start_us, end_us, name). They are read from the
    raw kineto events: building the profiler's FunctionEvent tree takes
    tens of seconds at one job's event count. Device-side user annotations
    are ranges over operations, not operations, and are left out."""
    results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    dev, host = [], []
    if results is None:
        for e in prof.events():
            row = (e.time_range.start, e.time_range.end, e.name)
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                if not getattr(e, "is_user_annotation", False):
                    dev.append(row)
            else:
                host.append(row)
        return dev, host
    for e in results.events():
        s = e.start_ns() / 1e3
        row = (s, s + e.duration_ns() / 1e3, e.name())
        if str(e.device_type()).endswith("CUDA"):
            if not e.is_user_annotation():
                dev.append(row)
        else:
            host.append(row)
    return dev, host


@dataclasses.dataclass
class Profile:
    """What the profiled jobs did on the device."""

    jobs: int = 0
    steps: int = 0                 # supersteps of the profiled jobs
    wall_s: float = 0.0            # host wall of the profiled jobs
    untraced_s: float = 0.0        # the same jobs' wall in the untraced window
    busy_s: float = 0.0            # union of device operation spans
    kernels: int = 0               # device kernels (copies and fills apart)
    device_ops: int = 0            # every device operation
    events: int = 0                # host and device events recorded
    by_name: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    gaps: List[Tuple[float, str]] = dataclasses.field(default_factory=list)
    spans: Dict[str, int] = dataclasses.field(default_factory=dict)

    def seconds(self, *fragments: str) -> Optional[float]:
        """Device seconds of the operations whose name holds any of the
        fragments, or None when none ran."""
        hits = [v for name, v in self.by_name.items() if any(f in name for f in fragments)]
        return sum(v[1] for v in hits) if hits else None

    def add(self, dev: list, host: list, wall_s: float, steps: int,
            spans: Dict[str, int]) -> None:
        """Fold one profiled job into the summary: its device and host
        operations (`raw_events`), host wall, supersteps and tracer spans."""
        self.jobs += 1
        self.steps += steps
        self.wall_s += wall_s
        self.events += len(dev) + len(host)
        for name, count in spans.items():
            self.spans[name] = self.spans.get(name, 0) + count
        iv = sorted(dev)
        self.device_ops += len(iv)
        busy = 0.0
        cur_s = cur_e = None
        gaps = []
        for s, e, name in iv:
            entry = self.by_name.setdefault(name, [0, 0.0])
            entry[0] += 1
            entry[1] += (e - s) / 1e6
            if not _is_transfer(name):
                self.kernels += 1
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((s - cur_e, cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        self.busy_s += busy / 1e6
        gaps.sort(reverse=True)
        self.gaps.extend((g / 1e6, _host_activity(host, a, b)) for g, a, b in gaps[:10])
        self.gaps.sort(key=lambda x: -x[0])
        del self.gaps[10:]

    def breakdown(self) -> dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:10]
        return {"device_ops": [[name[:NAME_CHARS], v[1]] for name, v in top],
                "idle_gaps": [[label[:NAME_CHARS], g] for g, label in self.gaps]}


def _host_activity(host, a: float, b: float) -> str:
    """What the host was doing in the device gap [a, b): the shortest host
    operation that covers half of it or more (the innermost, not the
    whole job around it), else the one that overlaps it most, or a note
    that none did."""
    best, best_key = None, None
    for s, t, name in host:
        if t <= a or s >= b:
            continue
        overlap = min(t, b) - max(s, a)
        half = overlap >= 0.5 * (b - a)
        key = (half, -(t - s) if half else overlap)
        if best_key is None or key > best_key:
            best, best_key = name, key
    return best if best is not None else "no host operation recorded"


def span_counts(tracer) -> Dict[str, int]:
    """{span name: count} of a port tracer's recorded spans."""
    out: Dict[str, int] = {}
    for ev in tracer.events:
        if ev.get("ph") == "X":
            out[ev["name"]] = out.get(ev["name"], 0) + 1
    return out

