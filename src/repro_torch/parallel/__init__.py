"""Distribution substrate of the port: sharding rules and per-rank shards,
the roofline, the activation-sharding context, the collectives of its
single-process meshes (the LM collectives and the partitioner's), and the
cost counter (`cost_count`, the counterpart of `repro`'s HLO cost
analysis), whose counted costs the roofline takes."""
from repro_torch.parallel.collectives import (
    ef_int8_psum,
    gather_shards,
    halo_exchange,
    hub_gather,
    hub_votes,
    lse_combine,
    psum,
    psum_delta_merge,
    replicated_key,
    shard_chain_key,
    sharded_decode_attention,
    vertex_halo_exchange,
)
from repro_torch.parallel.roofline import (Costs, Roofline, model_flops, param_counts,
                                           roofline_from_costs)
from repro_torch.parallel.sharding import (P, batch_specs, cache_specs, dp_axes, param_shapes,
                                           param_specs, shard_tree, unshard_tree,
                                           validate_specs, zero_dp_specs)

__all__ = [
    "param_specs", "batch_specs", "cache_specs", "zero_dp_specs", "validate_specs", "dp_axes",
    "P", "param_shapes", "shard_tree", "unshard_tree",
    "Costs", "Roofline", "model_flops", "param_counts", "roofline_from_costs",
    "lse_combine", "sharded_decode_attention", "ef_int8_psum",
    "gather_shards", "halo_exchange", "hub_gather", "hub_votes", "psum", "psum_delta_merge",
    "replicated_key", "shard_chain_key", "vertex_halo_exchange",
]
