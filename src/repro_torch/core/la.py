"""Learning-automata update rules.

`classic_la_update` implements the textbook variable-structure LA (eqs. 6/7):
one action is rewarded or penalized per step.

`weighted_la_update` implements the paper's contribution (eqs. 8/9): the
reinforcement is distributed over *all* m actions through a weight vector W
(sum(W)=2: the reward half and the penalty half each sum to 1). As stated in
Section IV-A, the update is executed m times — pass i applies eq. (8) if
r_i = 0 (reward) or eq. (9) if r_i = 1 (penalty), each pass touching all m
probabilities — m^2 elementary updates in total.

These are the plain PyTorch versions, written op for op like
`repro.core.la`; `repro_torch.kernels.la_update` holds the CUDA kernel with
the same semantics (one thread per row, the row's vectors in registers
across the m passes).

Note on the simplex: eqs. (8)/(9) only keep sum(p)=1 approximately. With
`renorm=True` (default) rows are projected back to the simplex after the m
passes.
"""
from __future__ import annotations

import torch

from repro_torch.core.device_graph import scalar_device

_EPS = 1e-12


def classic_la_update(p: torch.Tensor, action: torch.Tensor, penalty: torch.Tensor,
                      alpha: float, beta: float) -> torch.Tensor:
    """Eqs. (6)/(7). p: [..., m]; action: [...] int; penalty: [...] {0,1}."""
    m = p.shape[-1]
    onehot = torch.nn.functional.one_hot(action.long(), m).to(p.dtype)
    # reward (r=0): p_i += alpha (1-p_i); p_j *= (1-alpha)
    p_rew = torch.where(onehot > 0, p + alpha * (1.0 - p), p * (1.0 - alpha))
    # penalty (r=1): p_i *= (1-beta); p_j = p_j (1-beta) + beta/(m-1)
    p_pen = torch.where(onehot > 0, p * (1.0 - beta), p * (1.0 - beta) + beta / (m - 1))
    return torch.where(penalty[..., None] > 0, p_pen, p_rew)


def _div(x, d: int, like: torch.Tensor) -> torch.Tensor:
    """``x / d`` as an IEEE f32 division on ``like``'s (f32) device. CUDA
    turns a division by a host scalar into a multiply by its reciprocal,
    which rounds differently from the reference (and from the CUDA kernel).
    The divisor is the cached device scalar: uploading a new one on every
    call synchronized the host with the card once a block."""
    return x / scalar_device(float(d), like.device)


def weighted_la_update(
    p: torch.Tensor,
    w: torch.Tensor,
    r: torch.Tensor,
    alpha: float,
    beta: float,
    *,
    renorm: bool = True,
    pass_order: str = "penalty_first",
) -> torch.Tensor:
    """Eqs. (8)/(9), executed as m sequential passes (pass i keyed by r_i).

    Pass order (DESIGN.md §10): "penalty_first" (penalty passes, then reward
    passes, stable within each class) is the default that converges;
    "ascending" (index order, the literal reading) is kept for the ablation.

    Args:
      p: [..., m] probability vectors (rows on the simplex).
      w: [..., m] weight vector; reward half sums to 1, penalty half sums to 1.
      r: [..., m] reinforcement signals; 0 = reward, 1 = penalty.
      alpha, beta: reward / penalty learning rates (paper: 1.0 / 0.1).
      renorm: project back onto the simplex after the passes.
      pass_order: "penalty_first" | "ascending".

    Returns:
      Updated [..., m] probability vectors (a new tensor).
    """
    m = p.shape[-1]
    iota = torch.arange(m, device=p.device)

    if pass_order == "penalty_first":
        # per-row pass schedule: penalties (r=1) first, rewards (r=0) last,
        # stable within each class. argsort(-r) is descending-r stable.
        order = torch.argsort(-r, dim=-1, stable=True)
    elif pass_order == "ascending":
        order = iota.expand(r.shape)
    else:
        raise ValueError(f"unknown pass_order {pass_order!r}")

    for t in range(m):
        i = order[..., t]                                # [...] per-row action id
        mask = iota == i[..., None]                      # [..., m] one-hot
        w_i = torch.where(mask, w, 0.0).sum(-1, keepdim=True)
        # eq. (8): reward pass for action i
        p_rew = torch.where(mask, p + alpha * w * (1.0 - p), p * (1.0 - alpha * w))
        # eq. (9): penalty pass for action i; the redistribution floor is
        # scaled by the recipient's weight
        floor = _div(beta * w, m - 1, p)
        p_pen = torch.where(mask, p * (1.0 - beta * w), p * (1.0 - beta * w) + floor)
        is_pen = torch.where(mask, r, 0.0).sum(-1, keepdim=True) > 0
        p_new = torch.where(is_pen, p_pen, p_rew)
        # a slot with zero weight carries no reinforcement signal: skip pass
        p = torch.where(w_i > 0, p_new, p)
    if renorm:
        p = torch.clamp(p, _EPS, 1.0)
        p = p / torch.sum(p, dim=-1, keepdim=True)
    return p


def split_weights_and_signals(w_raw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Step 6 of Section IV-D: mean-split W into reward/penalty halves and
    normalize each half to sum to 1 (so sum(W)=2 as eqs. (8)/(9) require).

    Args:
      w_raw: [..., m] non-negative accumulated weights (eq. 13 histogram).

    Returns:
      (w_norm, r): normalized weights and reinforcement signals
      (r=0 reward where w_i > mean(W), r=1 penalty otherwise).
    """
    m = w_raw.shape[-1]
    mean = _div(torch.sum(w_raw, dim=-1, keepdim=True), m, w_raw)
    r = (w_raw <= mean).to(w_raw.dtype)  # 1 = penalty
    rew_mask = 1.0 - r
    rew_sum = torch.sum(w_raw * rew_mask, dim=-1, keepdim=True)
    pen_sum = torch.sum(w_raw * r, dim=-1, keepdim=True)
    # a half whose accumulated weight is zero carries no reinforcement
    # signal: its slots keep w=0 and their passes are skipped
    w_rew = torch.where(rew_sum > 0, w_raw / torch.where(rew_sum > 0, rew_sum, 1.0), 0.0)
    w_pen = torch.where(pen_sum > 0, w_raw / torch.where(pen_sum > 0, pen_sum, 1.0), 0.0)
    w_norm = torch.where(r > 0, w_pen, w_rew)
    return w_norm.to(w_raw.dtype), r
