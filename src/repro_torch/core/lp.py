"""Label-propagation scoring: the paper's normalized LP (eqs. 10-12) and
the Spinner baseline scoring (eqs. 3-5).

`edge_histogram` is the scatter-add primitive every edge histogram is built
from: the plain versions of the edge-phase kernel (K1, Revolver's two
histograms) and of the edge-histogram kernel (K3, Spinner's and restream's
one) use it; the CUDA kernels in `repro_torch.kernels` compute the same
sums from the slab's row runs.

Every division by the capacity takes it as a 0-dim tensor on the loads'
device (`device_graph.capacity_device`): CUDA divides by a host scalar as a
multiply by its reciprocal, which would not round like the reference's f32
division.
"""
from __future__ import annotations

import torch


def edge_histogram(
    rows: torch.Tensor,
    slots: torch.Tensor,
    vals: torch.Tensor,
    n_rows: int,
    k: int,
) -> torch.Tensor:
    """hist[r, s] = sum of vals[e] over edges with rows[e]==r, slots[e]==s.

    Args:
      rows: [E] integer destination row per edge (local vertex index).
      slots: [E] integer partition slot per edge (e.g. neighbor's label).
      vals: [E] float values (0.0 for padding edges).
      n_rows, k: histogram shape.
    """
    hist = torch.zeros((n_rows, k), dtype=vals.dtype, device=vals.device)
    return hist.index_put_((rows.long(), slots.long()), vals, accumulate=True)


def tau_term(hist: torch.Tensor, inv_wsum: torch.Tensor) -> torch.Tensor:
    """Eq. (11): neighborhood affinity normalized by the total edge weight."""
    return hist * inv_wsum[:, None]


def normalized_penalty(loads: torch.Tensor, capacity: torch.Tensor) -> torch.Tensor:
    """Eq. (12) with the footnote-1 negative shift.

    pi(l) = (1 - b(l)/C) normalized over partitions; if any term is negative
    (partition over capacity), shift by the minimum before normalizing.
    `capacity` is a 0-dim tensor on the loads' device
    (`device_graph.capacity_device`).
    """
    pen = 1.0 - loads / capacity
    mn = torch.min(pen)
    pen = torch.where(mn < 0, pen - mn, pen)
    total = torch.sum(pen)
    k = loads.shape[0]
    return torch.where(total > 0, pen / torch.where(total > 0, total, 1.0),
                       torch.full_like(pen, 1.0 / k))


def revolver_scores(hist: torch.Tensor, inv_wsum: torch.Tensor,
                    loads: torch.Tensor, capacity: torch.Tensor) -> torch.Tensor:
    """Eq. (10): score(v,l) = (tau(v,l) + pi(l)) / 2."""
    tau = tau_term(hist, inv_wsum)
    pi = normalized_penalty(loads, capacity)
    return 0.5 * (tau + pi[None, :])


def spinner_penalty(loads: torch.Tensor, capacity: torch.Tensor) -> torch.Tensor:
    """Eq. (5): pi_hat(l) = b(l)/C (unnormalized; the term Spinner
    subtracts). `capacity` is a 0-dim tensor on the loads' device."""
    return loads / capacity


def spinner_scores(hist: torch.Tensor, inv_wsum: torch.Tensor,
                   loads: torch.Tensor, capacity: torch.Tensor) -> torch.Tensor:
    """Eq. (3): score_hat(v,l) = tau_hat(v,l) - pi_hat(l)."""
    tau = tau_term(hist, inv_wsum)
    return tau - spinner_penalty(loads, capacity)[None, :]
