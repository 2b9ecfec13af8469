"""Revolver core of the port: the superstep engine and its rules.

Layering as in `repro.core`: `engine` owns the superstep schedules
(sequential, and sharded / halo / async over a `BlocksMesh`), `registry` maps algorithm names to rule modules (`revolver`,
`spinner`, `restream`, `static_partitioners`), and `runner` drives the
convergence loop. `convert` carries `repro`'s layout and
state across for the parity tests.
"""
from repro_torch.core.la import classic_la_update, split_weights_and_signals, weighted_la_update
from repro_torch.core.lp import (
    edge_histogram,
    normalized_penalty,
    revolver_scores,
    spinner_penalty,
    spinner_scores,
    tau_term,
)
from repro_torch.core.metrics import (
    edge_cuts,
    local_edges,
    max_normalized_load,
    partition_loads,
)
from repro_torch.core.device_graph import (
    CAPACITY_MODES,
    DeviceGraph,
    ShardedDeviceGraph,
    capacity,
    capacity_device,
    prepare_device_graph,
    prepare_sharded_device_graph,
    shard_device_graph,
)
from repro_torch.core.engine import (
    Algorithm,
    ChunkContext,
    ChunkUpdate,
    ShardContext,
    ShardUpdate,
    async_superstep,
    place_state,
    superstep,
)
from repro_torch.core.registry import (
    StaticAlgorithm,
    available_algorithms,
    get_algorithm,
    register,
    superstep_algorithms,
    warm_startable_algorithms,
)
from repro_torch.core.revolver import (
    RevolverConfig,
    RevolverState,
    revolver_init,
    revolver_init_from_labels,
    revolver_superstep,
)
from repro_torch.core.spinner import (
    SpinnerConfig,
    SpinnerState,
    spinner_init,
    spinner_init_from_labels,
    spinner_superstep,
)
from repro_torch.core.restream import (
    RestreamConfig,
    RestreamState,
    restream_init,
    restream_init_from_labels,
    restream_superstep,
)
from repro_torch.core.static_partitioners import hash_partition, range_partition
from repro_torch.core.runner import PartitionResult, run_convergence_loop, run_partitioner

__all__ = [
    "classic_la_update",
    "split_weights_and_signals",
    "weighted_la_update",
    "edge_histogram",
    "normalized_penalty",
    "revolver_scores",
    "spinner_penalty",
    "spinner_scores",
    "tau_term",
    "edge_cuts",
    "local_edges",
    "max_normalized_load",
    "partition_loads",
    "CAPACITY_MODES",
    "DeviceGraph",
    "ShardedDeviceGraph",
    "capacity",
    "capacity_device",
    "prepare_device_graph",
    "prepare_sharded_device_graph",
    "shard_device_graph",
    "Algorithm",
    "ChunkContext",
    "ChunkUpdate",
    "ShardContext",
    "ShardUpdate",
    "async_superstep",
    "place_state",
    "superstep",
    "StaticAlgorithm",
    "available_algorithms",
    "get_algorithm",
    "register",
    "superstep_algorithms",
    "warm_startable_algorithms",
    "RevolverConfig",
    "RevolverState",
    "revolver_init",
    "revolver_init_from_labels",
    "revolver_superstep",
    "SpinnerConfig",
    "SpinnerState",
    "spinner_init",
    "spinner_init_from_labels",
    "spinner_superstep",
    "RestreamConfig",
    "RestreamState",
    "restream_init",
    "restream_init_from_labels",
    "restream_superstep",
    "hash_partition",
    "range_partition",
    "PartitionResult",
    "run_convergence_loop",
    "run_partitioner",
]
