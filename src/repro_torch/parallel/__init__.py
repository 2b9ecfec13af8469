"""Collectives of the port's single-process blocks mesh (the port of the
partitioner part of `repro.parallel`)."""
from repro_torch.parallel.collectives import (
    gather_shards,
    halo_exchange,
    hub_gather,
    hub_votes,
    psum,
    psum_delta_merge,
    replicated_key,
    shard_chain_key,
    vertex_halo_exchange,
)

__all__ = ["gather_shards", "halo_exchange", "hub_gather", "hub_votes", "psum", "psum_delta_merge",
           "replicated_key", "shard_chain_key",
           "vertex_halo_exchange"]
