"""String-keyed algorithm registry: ``run_partitioner(algo="...")`` lookups.

Two entry kinds live here:

  * `engine.Algorithm` — superstep algorithms (revolver, spinner, restream)
    the engine drives through the shared convergence loop;
  * `StaticAlgorithm` — closed-form baselines (hash, range) that emit a
    partition in one shot with no supersteps.

Rule modules register themselves at import time
(``REVOLVER = register(engine.Algorithm(...))``); `get_algorithm` imports the
built-in modules lazily on first lookup so the registry has no import cycle
with the rules it serves.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple, Union

from repro_torch.core.engine import Algorithm


@dataclasses.dataclass(frozen=True, eq=False)
class StaticAlgorithm:
    """A stateless one-shot partitioner:
    ``partition(n, k, device) -> [n] int32 labels``."""

    name: str
    partition: Callable


AnyAlgorithm = Union[Algorithm, StaticAlgorithm]

_REGISTRY: Dict[str, AnyAlgorithm] = {}


def register(algo: AnyAlgorithm) -> AnyAlgorithm:
    """Add an algorithm to the registry (last registration wins) and return
    it, so rule modules can use the ``NAME = register(...)`` idiom."""
    _REGISTRY[algo.name] = algo
    return algo


def _ensure_builtins() -> None:
    # the built-in rule modules self-register on import
    from repro_torch.core import restream, revolver, spinner, static_partitioners  # noqa: F401


def get_algorithm(name: str) -> AnyAlgorithm:
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


def superstep_algorithms() -> Tuple[str, ...]:
    """Sorted names of the engine-driven (non-static) algorithms."""
    _ensure_builtins()
    return tuple(sorted(n for n, a in _REGISTRY.items()
                        if isinstance(a, Algorithm)))


def warm_startable_algorithms() -> Tuple[str, ...]:
    """Sorted names of the superstep algorithms that accept
    ``init_from_labels`` warm starts."""
    _ensure_builtins()
    return tuple(sorted(
        n for n, a in _REGISTRY.items()
        if isinstance(a, Algorithm) and a.init_from_labels is not None))
