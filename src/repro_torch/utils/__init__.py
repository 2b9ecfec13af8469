"""Shared utilities of the port: tensor-tree helpers, seed derivation,
structured logging, the artifacts' provenance stamp (the counterparts of
`repro.utils`)."""
from repro_torch.utils.logging import MetricLogger
from repro_torch.utils.prng import fold_in_str
from repro_torch.utils.provenance import bench_provenance
from repro_torch.utils.tree import tree_bytes, tree_global_norm, tree_leaves, tree_param_count

__all__ = [
    "MetricLogger",
    "bench_provenance",
    "fold_in_str",
    "tree_bytes",
    "tree_global_norm",
    "tree_leaves",
    "tree_param_count",
]
