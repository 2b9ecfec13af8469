"""Revolver core of the port: the superstep engine and its rules.

Layering as in `repro.core`: `engine` owns the (sequential) superstep
schedule, `registry` maps algorithm names to rule modules (`revolver`), and
`runner` drives the convergence loop. `convert` carries `repro`'s layout and
state across for the parity tests.
"""
from repro_torch.core.la import classic_la_update, split_weights_and_signals, weighted_la_update
from repro_torch.core.lp import edge_histogram, normalized_penalty, revolver_scores, tau_term
from repro_torch.core.metrics import (
    edge_cuts,
    local_edges,
    max_normalized_load,
    partition_loads,
)
from repro_torch.core.device_graph import (
    CAPACITY_MODES,
    DeviceGraph,
    capacity,
    capacity_device,
    prepare_device_graph,
)
from repro_torch.core.engine import Algorithm, ChunkContext, ChunkUpdate, superstep
from repro_torch.core.registry import available_algorithms, get_algorithm, register
from repro_torch.core.revolver import (
    RevolverConfig,
    RevolverState,
    revolver_init,
    revolver_init_from_labels,
    revolver_superstep,
)
from repro_torch.core.runner import PartitionResult, run_convergence_loop, run_partitioner

__all__ = [
    "classic_la_update",
    "split_weights_and_signals",
    "weighted_la_update",
    "edge_histogram",
    "normalized_penalty",
    "revolver_scores",
    "tau_term",
    "edge_cuts",
    "local_edges",
    "max_normalized_load",
    "partition_loads",
    "CAPACITY_MODES",
    "DeviceGraph",
    "capacity",
    "capacity_device",
    "prepare_device_graph",
    "Algorithm",
    "ChunkContext",
    "ChunkUpdate",
    "superstep",
    "available_algorithms",
    "get_algorithm",
    "register",
    "RevolverConfig",
    "RevolverState",
    "revolver_init",
    "revolver_init_from_labels",
    "revolver_superstep",
    "PartitionResult",
    "run_convergence_loop",
    "run_partitioner",
]
