"""Deterministic fault injection (see `repro_torch.faults.inject`).

Production code calls `fire(point, index)` at its injection points; the
call is a no-op early return unless a plan is active (the ``REPRO_FAULTS``
env var or a `use_plan` scope), so crash-safety hooks cost nothing when
nothing is being injected.
"""
from repro_torch.faults.inject import (
    ENV_VAR,
    FaultAction,
    FaultPlan,
    active_plan,
    fire,
    parse_faults,
    poison,
    use_plan,
)

__all__ = [
    "ENV_VAR",
    "FaultAction",
    "FaultPlan",
    "active_plan",
    "fire",
    "parse_faults",
    "poison",
    "use_plan",
]
