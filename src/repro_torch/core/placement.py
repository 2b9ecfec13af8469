"""Revolver -> MoE expert placement.

The port of `repro.core.placement`. The token->expert routing of a trained
(or profiled) MoE layer induces a weighted EXPERT CO-ACTIVATION GRAPH:
vertices = experts, edge (i, j) weighted by how often experts i and j fire
on the same token (top-k routing activates k experts per token). Placing
co-activating experts on the same device makes the combine step local —
the cross-device share of co-activation weight is a direct proxy for the
EP dispatch/combine traffic that is NOT intra-device.

Revolver's balanced k-way partitioning is exactly this problem:
  * vertices = experts, k = number of EP devices,
  * balance constraint = per-device expert-load balance (the biggest
    partition bounds step time — same argument as the paper §II),
  * local edges = co-activation locality (maximizing it minimizes
    cross-device combine traffic).

``place_experts`` runs the partitioner (`run_partitioner`, Revolver's K1
and K2 on the card) on the co-activation graph and returns a permutation
mapping experts to devices; ``apply_placement`` permutes the expert
dimension of an `MoE` so that rank r of an expert-parallel mesh
(`repro_torch.models.moe._apply_moe_shardmap`) holds the experts the
partitioner gave device r.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.runner import PartitionResult, run_partitioner
from repro_torch.graphs.csr import build_graph


def coactivation_graph(top_idx, n_experts: int):
    """top_idx [T, K] routed expert ids -> (directed co-activation graph,
    weights). An edge (s, d) for every ordered pair of distinct experts on
    one token, over the choice pairs (a, b), a != b; its weight counts its
    samples. The weights come in `repro`'s order (each pair's first
    sample, choice pairs (a, b) in row-major order, then tokens); `repro`
    builds that order with a Python dict, the port with one `np.unique`.
    With no co-activation (top-1 routing) the graph is a ring, weights 1."""
    top_idx = np.asarray(top_idx)
    t, k = top_idx.shape
    choice = [(a, b) for a in range(k) for b in range(k) if a != b]
    if choice:
        src = np.concatenate([top_idx[:, a] for a, _ in choice]).astype(np.int64)
        dst = np.concatenate([top_idx[:, b] for _, b in choice]).astype(np.int64)
        keep = src != dst
        src, dst = src[keep], dst[keep]
    if not choice or src.size == 0:
        # degenerate: no co-activation (top-1 routing) — ring fallback
        src = np.arange(n_experts)
        dst = (src + 1) % n_experts
        return build_graph(src, dst, n_experts), np.ones(len(src))
    keys, first, counts = np.unique(src * n_experts + dst, return_index=True,
                                    return_counts=True)
    seen = np.argsort(first, kind="stable")          # first-sample order
    keys = keys[seen]
    w = counts[seen].astype(np.float64)
    return build_graph(keys // n_experts, keys % n_experts, n_experts), w


@dataclasses.dataclass
class Placement:
    expert_to_device: np.ndarray     # [E] device id per expert
    permutation: np.ndarray          # [E] new order (device-major)
    result: PartitionResult
    cross_coactivation: float        # fraction of co-activation weight cut


def balance(labels: np.ndarray, n_experts: int, n_devices: int) -> np.ndarray:
    """`repro`'s balance repair: the partitioner balances by out-degree, the
    EP shard needs exactly E/n_devices experts a device, so experts are
    packed greedily by label (largest labels first, stable), and the
    overflow goes to the least-loaded device."""
    labels = np.asarray(labels)
    cap = n_experts // n_devices
    counts = np.zeros(n_devices, np.int64)
    assign = np.full(n_experts, -1, np.int64)
    order = np.argsort(-np.bincount(labels, minlength=n_devices)[labels], kind="stable")
    for e in order:
        d = labels[e]
        if counts[d] < cap:
            assign[e] = d
            counts[d] += 1
    for e in np.where(assign < 0)[0]:          # overflow -> least loaded
        d = int(np.argmin(counts))
        assign[e] = d
        counts[d] += 1
    return assign


def place_experts(top_idx, n_experts: int, n_devices: int, *, seed: int = 0,
                  max_steps: int = 120, algo: str = "revolver", device="cuda") -> Placement:
    """Partition experts across ``n_devices`` from routing statistics
    (``top_idx`` [T, K], numpy or a tensor), on ``device``."""
    top_idx = top_idx.cpu().numpy() if isinstance(top_idx, torch.Tensor) else np.asarray(top_idx)
    g, _ = coactivation_graph(top_idx, n_experts)
    res = run_partitioner(algo, g, n_devices, seed=seed, max_steps=max_steps, n_blocks=1,
                          device=device)
    assign = balance(np.asarray(res.labels[:n_experts]), n_experts, n_devices)
    perm = np.argsort(assign, kind="stable")   # device-major expert order
    return Placement(expert_to_device=assign, permutation=perm, result=res,
                     cross_coactivation=_cross_fraction(top_idx, assign))


def _cross_fraction(top_idx, assign: np.ndarray) -> float:
    """Fraction of same-token expert pairs that span two devices."""
    top_idx = np.asarray(top_idx)
    t, k = top_idx.shape
    dev = np.asarray(assign)[top_idx]          # [T, K]
    same = 0
    total = 0
    for a in range(k):
        for b in range(a + 1, k):
            total += t
            same += int(np.sum(dev[:, a] == dev[:, b]))
    return 1.0 - same / max(total, 1)


def apply_placement(moe, placement: Placement):
    """A new `MoE` whose expert axis follows the placement (device-major):
    ``w_gate``, ``w_up`` and ``w_down`` permuted on the expert axis and the
    router's ``w`` on its columns (new tensors); the shared experts are the
    input's own module. The input is left unchanged."""
    from repro_torch.models.common import Dense
    from repro_torch.models.moe import MoE

    perm = torch.as_tensor(placement.permutation, dtype=torch.long, device=moe.w_gate.device)
    rw, rb = moe.router.w, moe.router.b
    router = Dense(rw.index_select(1, perm.to(rw.device)),
                   None if rb is None else rb.index_select(0, perm.to(rb.device)))
    return MoE(router, moe.w_gate.index_select(0, perm), moe.w_up.index_select(0, perm),
               moe.w_down.index_select(0, perm), moe.shared)


__all__ = ["coactivation_graph", "Placement", "balance", "place_experts", "_cross_fraction",
           "apply_placement"]
