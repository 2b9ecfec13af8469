"""Deterministic fault injection for crash-safety testing (the port of
`repro.faults.inject`: the same grammar, points and ``REPRO_FAULTS``
variable).

A *fault plan* is a comma-separated spec, normally supplied through the
``REPRO_FAULTS`` environment variable so a real subprocess run can be killed
and resumed from the outside (the CI kill-and-resume legs), or installed
programmatically with `use_plan` for in-process tests:

  kill@superstep=12    SIGKILL the process right after superstep 12 is
                       dispatched (global step numbering — streaming refines
                       count across deltas)
  kill@delta=2         SIGKILL before delta 2 is merged (stream checkpoints
                       for deltas 0..1 are on disk)
  kill@save            SIGKILL mid checkpoint save, after the payload +
                       manifest are written but *before* the atomic rename —
                       leaves a ``.tmp`` dir a resume must ignore
  kill@save-payload    SIGKILL after the npz payload, before the manifest —
                       a torn write inside the ``.tmp`` dir
  kill@save=1          index a repeated point: kill at the *second* save
  nan@superstep=8      poison the LA probability tensor with NaN after
                       step 8 (exercises the drain-window guard)
  badlabel@superstep=8 poison ``labels[0]`` with an out-of-range value

Injection points are checked with `fire(point, index)`; when no plan is
active the check is a single attribute load and an early return, so the
hooks cost nothing in production paths. Kill actions never return; poison
actions return their name and the caller applies `poison` to its state.
All injection is deterministic: the same plan and the same run produce the
same failure, which is what lets CI assert *exact* recovery.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import sys
from collections import defaultdict
from typing import Optional, Tuple

ENV_VAR = "REPRO_FAULTS"

_ACTIONS = ("kill", "nan", "badlabel")
_POINTS = ("superstep", "delta", "save", "save-payload")


@dataclasses.dataclass(frozen=True)
class FaultAction:
    action: str            # "kill" | "nan" | "badlabel"
    point: str             # "superstep" | "delta" | "save" | "save-payload"
    index: Optional[int]   # None = first time the point is hit


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    actions: Tuple[FaultAction, ...]


def parse_faults(spec: str) -> FaultPlan:
    """Parse a ``REPRO_FAULTS`` spec string (see module docstring)."""
    actions = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if "@" not in item:
            raise ValueError(
                f"bad fault spec {item!r}: expected action@point[=index]")
        action, _, rest = item.partition("@")
        point, eq, idx = rest.partition("=")
        if action not in _ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r}; expected one of {_ACTIONS}")
        if point not in _POINTS:
            raise ValueError(
                f"unknown fault point {point!r}; expected one of {_POINTS}")
        index = None
        if eq:
            try:
                index = int(idx)
            except ValueError:
                raise ValueError(f"bad fault index in {item!r}") from None
        if action in ("nan", "badlabel") and point != "superstep":
            raise ValueError(f"{action!r} faults only apply at 'superstep'")
        actions.append(FaultAction(action, point, index))
    return FaultPlan(tuple(actions))


# module state: the active plan (lazily parsed from the environment once),
# per-point hit counters for index matching, and the consumed-action set so
# a poison fires exactly once
_plan: Optional[FaultPlan] = None
_env_loaded = False
_counts: dict = defaultdict(int)
_consumed: set = set()


def active_plan() -> Optional[FaultPlan]:
    global _plan, _env_loaded
    if not _env_loaded:
        _env_loaded = True
        spec = os.environ.get(ENV_VAR)
        if spec:
            _plan = parse_faults(spec)
    return _plan


@contextlib.contextmanager
def use_plan(plan):
    """Install a plan (a `FaultPlan` or spec string) for the scope — the
    in-process test hook mirroring the env var."""
    global _plan, _env_loaded
    if isinstance(plan, str):
        plan = parse_faults(plan)
    prev, prev_loaded = _plan, _env_loaded
    prev_counts, prev_consumed = dict(_counts), set(_consumed)
    _plan, _env_loaded = plan, True
    _counts.clear()
    _consumed.clear()
    try:
        yield plan
    finally:
        _plan, _env_loaded = prev, prev_loaded
        _counts.clear()
        _counts.update(prev_counts)
        _consumed.clear()
        _consumed.update(prev_consumed)


def _kill():
    # SIGKILL, not sys.exit: the point is an unhandleable crash — no atexit,
    # no finally blocks, no flushing beyond what we do here
    sys.stdout.flush()
    sys.stderr.flush()
    os.kill(os.getpid(), signal.SIGKILL)


def fire(point: str, index: Optional[int] = None) -> Optional[str]:
    """Check an injection point. Returns None (no matching fault), never
    returns (kill), or the poison action name for the caller to apply.

    ``index``: the caller's own deterministic counter (superstep / delta
    number). When the caller passes None the point keeps its own hit count,
    so ``kill@save=1`` means "the second save".
    """
    plan = active_plan()
    if plan is None:
        return None
    if index is None:
        index = _counts[point]
        _counts[point] += 1
    for i, act in enumerate(plan.actions):
        if act.point != point or i in _consumed:
            continue
        if act.index is not None and act.index != index:
            continue
        _consumed.add(i)
        if act.action == "kill":
            _kill()
        return act.action
    return None


def poison(state, action: str):
    """Apply a poison action to an algorithm state NamedTuple (on its
    device; the corruption is detected later, at a fetch window, by the
    guard). Out of place, like `repro`'s ``.at[0].set``: the poisoned
    tensor is a clone, so it aliases neither a snapshot nor the caller's
    tensors."""
    if action == "nan" and hasattr(state, "probs"):
        probs = state.probs.clone()
        probs.view(-1)[0] = float("nan")
        return state._replace(probs=probs)
    if action in ("nan", "badlabel"):
        labels = state.labels.clone()
        labels[0] = 2**30
        return state._replace(labels=labels)
    raise ValueError(f"unknown poison action {action!r}")
