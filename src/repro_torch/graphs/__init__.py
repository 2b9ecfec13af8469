"""Graph substrate: CSR storage, the synthetic Table-I dataset suite and the
per-block slab layout (the port's own copy of `repro.graphs`)."""
from repro_torch.graphs.csr import Graph, build_graph, graph_stats
from repro_torch.graphs.generators import dc_sbm, erdos_renyi, grid_road, ring_of_cliques, rmat
from repro_torch.graphs.datasets import DATASETS, load_dataset
from repro_torch.graphs.blocking import (
    BlockedEdges,
    block_edges,
    block_slab_sizes,
    fill_block_slab,
    slab_row_ptr,
    slab_span_plan,
)

__all__ = [
    "Graph",
    "build_graph",
    "graph_stats",
    "dc_sbm",
    "erdos_renyi",
    "grid_road",
    "ring_of_cliques",
    "rmat",
    "DATASETS",
    "load_dataset",
    "BlockedEdges",
    "block_edges",
    "block_slab_sizes",
    "fill_block_slab",
    "slab_row_ptr",
    "slab_span_plan",
]
