"""Tensor-tree utilities: the counterparts of `repro.utils.tree` for the
port's trees, nested dicts, lists and tuples whose leaves are tensors, and
`nn.Module`s (their parameters)."""
from __future__ import annotations

import torch
from torch import nn


def tree_leaves(tree) -> list:
    """The tensor leaves in order (dict keys sorted, as `repro`'s trees
    are)."""
    if isinstance(tree, nn.Module):
        return [p for _, p in tree.named_parameters()]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def tree_param_count(tree) -> int:
    """Total number of scalars over the tree's tensors."""
    return sum(t.numel() for t in tree_leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes of the tree's tensors (each leaf's dtype itemsize)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def tree_global_norm(tree) -> torch.Tensor:
    """L2 norm over all leaves, accumulated in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tree_leaves(tree)))

