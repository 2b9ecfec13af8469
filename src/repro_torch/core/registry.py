"""String-keyed algorithm registry: ``run_partitioner(algo="...")`` lookups.

Rule modules register themselves at import time
(``REVOLVER = register(engine.Algorithm(...))``); `get_algorithm` imports the
built-in modules lazily on first lookup so the registry has no import cycle
with the rules it serves. Only Revolver is ported so far; Spinner, restream
and the static baselines come with ROADMAP queue 1 item 5.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.engine import Algorithm

_REGISTRY: Dict[str, Algorithm] = {}


def register(algo: Algorithm) -> Algorithm:
    """Add an algorithm to the registry (last registration wins) and return
    it, so rule modules can use the ``NAME = register(...)`` idiom."""
    _REGISTRY[algo.name] = algo
    return algo


def _ensure_builtins() -> None:
    # the built-in rule modules self-register on import
    from repro_torch.core import revolver  # noqa: F401


def get_algorithm(name: str) -> Algorithm:
    """Look up a registered algorithm; unknown names raise ValueError with
    the available keys."""
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {name!r}; available: {available_algorithms()}"
        ) from None


def available_algorithms() -> Tuple[str, ...]:
    """Sorted names of every registered algorithm."""
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))
