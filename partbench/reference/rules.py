"""Plain reference supersteps of Revolver, Spinner and restream.

Written from the paper (arXiv:1907.06768, Section IV-D, eqs. 3-13) and the
rule choices the port documents (self_lambda weights, penalty-first LA
passes with a simplex renorm, Spinner's tie bump, restream's degree ramp
and budget), in plain PyTorch: index_put/index_add scatters, no kernels, no
layout of the program. It builds its own blocking of the graph's
symmetrised adjacency (``n_blocks`` contiguous vertex ranges of
``block_v`` vertices, as the configuration states) and takes every input
from the caller: a state (labels, LA probabilities and the rest) and the
random draws both sides are handed.

``dtype`` sets the precision of the rule's floating-point work
(probabilities, noise, histograms, scores, weights). float32 is the
configuration's; bfloat16 is the control, the step below it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

def blocking(n: int, n_blocks: int, multiple: int = 8) -> tuple[int, int]:
    """(block_v, n_blocks): blocks of ceil(n / n_blocks) vertices rounded up
    to ``multiple``, as many as cover n."""
    bv = -(-n // n_blocks)
    bv = -(-bv // multiple) * multiple
    return bv, -(-n // bv)


class Layout:
    """The reference's view of a graph on ``device``: its own blocking, the
    symmetrised adjacency, degrees and edge-weight sums."""

    def __init__(self, graph: dict, n_blocks: int, device):
        self.n, self.m = int(graph["n"]), int(graph["m"])
        self.block_v, self.n_blocks = blocking(self.n, n_blocks)
        self.n_pad = self.block_v * self.n_blocks
        self.device = device
        self.adj_ptr = np.asarray(graph["adj_ptr"], dtype=np.int64)
        self.adj_idx = torch.as_tensor(graph["adj_idx"], device=device)
        self.adj_w = torch.as_tensor(graph["adj_w"], device=device)
        deg = torch.zeros(self.n_pad, dtype=torch.float32, device=device)
        deg[:self.n] = torch.as_tensor(graph["deg_out"], device=device).to(torch.float32)
        self.deg = deg
        wsum = torch.zeros(self.n_pad, dtype=torch.float64, device=device)
        rows = torch.repeat_interleave(torch.arange(self.n, device=device),
                                       torch.as_tensor(np.diff(self.adj_ptr), device=device))
        wsum.index_add_(0, rows, self.adj_w.to(torch.float64))
        del rows
        wsum = wsum.to(torch.float32)
        self.inv_wsum = torch.where(wsum > 0, 1.0 / wsum.clamp_min(1e-30), 0.0)
        self.vmask = torch.arange(self.n_pad, device=device) < self.n

    def block_edges(self, b: int):
        """Block b's adjacency entries: (local row, neighbour id, weight)."""
        lo = min(b * self.block_v, self.n)
        hi = min(lo + self.block_v, self.n)
        e0, e1 = int(self.adj_ptr[lo]), int(self.adj_ptr[hi])
        counts = torch.as_tensor(np.diff(self.adj_ptr[lo:hi + 1]), device=self.device)
        rows = torch.repeat_interleave(torch.arange(hi - lo, device=self.device), counts)
        return rows, self.adj_idx[e0:e1].long(), self.adj_w[e0:e1]

    def capacity(self, k: int, epsilon: float) -> torch.Tensor:
        """C = (1 + eps) |E| / k as a 0-dim f32 tensor (Spinner's capacity)."""
        return torch.tensor((1.0 + epsilon) * self.m / k, dtype=torch.float32,
                            device=self.device)

    def padded(self, x: np.ndarray, dtype) -> torch.Tensor:
        """A per-vertex host array padded with zeros to n_pad on the device."""
        out = torch.zeros(self.n_pad, dtype=dtype, device=self.device)
        out[:self.n] = torch.as_tensor(np.asarray(x), device=self.device).to(dtype)
        return out


def int_sums(index: torch.Tensor, values: torch.Tensor, k: int) -> torch.Tensor:
    """[k] f32 sums of integer ``values`` by ``index``, exact in int64."""
    acc = torch.zeros(k, dtype=torch.int64, device=values.device)
    return acc.index_add_(0, index.long(), values.long()).to(torch.float32)


def moved(src: torch.Tensor, dst: torch.Tensor, values: torch.Tensor, k: int) -> torch.Tensor:
    """[k] f32 load change of moving integer ``values`` from part ``src`` to
    part ``dst``, exact in int64 and rounded once."""
    v = values.long()
    acc = torch.zeros(k, dtype=torch.int64, device=values.device)
    return acc.index_add_(0, src.long(), -v).index_add_(0, dst.long(), v).to(torch.float32)


def score_sum(best: torch.Tensor, vmask: torch.Tensor) -> torch.Tensor:
    """Sum of the best scores over real vertices, in f64, rounded to f32."""
    return torch.sum(torch.where(vmask, best.float(), 0.0), dtype=torch.float64).to(torch.float32)


def histogram(rows, slots, vals, n_rows: int, k: int, dtype) -> torch.Tensor:
    hist = torch.zeros((n_rows, k), dtype=dtype, device=vals.device)
    return hist.index_put_((rows, slots.long()), vals.to(dtype), accumulate=True)


def migration_prob(demand, loads, cap, dtype):
    """p_mig(l) = clip((C - b(l)) / m(l), 0, 1), 1 where nothing is asked."""
    remaining = (cap - loads).to(dtype)
    demand = demand.to(dtype)
    return torch.where(demand > 0,
                       torch.clamp(remaining / torch.clamp_min(demand, 1e-9), 0.0, 1.0),
                       torch.ones_like(demand))


def revolver_penalty(loads, cap, k: int, dtype):
    """Eq. (12) with footnote 1's shift: (1 - b(l)/C), shifted by its
    minimum when negative, normalised to sum 1."""
    pen = 1.0 - (loads / cap).to(dtype)
    mn = torch.min(pen)
    pen = torch.where(mn < 0, pen - mn, pen)
    total = torch.sum(pen)
    return torch.where(total > 0, pen / torch.where(total > 0, total, 1.0),
                       torch.full_like(pen, 1.0 / k))


def split_weights(w_raw: torch.Tensor, k: int):
    """Step 6: the mean split into reward (above the mean) and penalty
    halves, each normalised to sum 1; a half with no weight stays 0."""
    mean = torch.sum(w_raw, dim=-1, keepdim=True) / torch.tensor(
        float(k), dtype=w_raw.dtype, device=w_raw.device)
    r = (w_raw <= mean).to(w_raw.dtype)
    rew_sum = torch.sum(w_raw * (1.0 - r), dim=-1, keepdim=True)
    pen_sum = torch.sum(w_raw * r, dim=-1, keepdim=True)
    w_rew = torch.where(rew_sum > 0, w_raw / torch.where(rew_sum > 0, rew_sum, 1.0), 0.0)
    w_pen = torch.where(pen_sum > 0, w_raw / torch.where(pen_sum > 0, pen_sum, 1.0), 0.0)
    return torch.where(r > 0, w_pen, w_rew), r


def weighted_la(p, w, r, alpha: float, beta: float):
    """Eqs. (8)/(9) as k passes, penalties first (stable), each pass keyed
    by its slot's signal and skipped where the slot has no weight; then the
    rows are clamped to [1e-12, 1] and renormalised."""
    k = p.shape[-1]
    iota = torch.arange(k, device=p.device)
    order = torch.argsort(-r, dim=-1, stable=True)
    km1 = torch.tensor(float(k - 1), dtype=p.dtype, device=p.device)
    for t in range(k):
        i = order[:, t]
        mask = iota == i[:, None]
        w_i = torch.where(mask, w, 0.0).sum(-1, keepdim=True)
        p_rew = torch.where(mask, p + alpha * w * (1.0 - p), p * (1.0 - alpha * w))
        floor = beta * w / km1
        p_pen = torch.where(mask, p * (1.0 - beta * w), p * (1.0 - beta * w) + floor)
        is_pen = torch.where(mask, r, 0.0).sum(-1, keepdim=True) > 0
        p = torch.where(w_i > 0, torch.where(is_pen, p_pen, p_rew), p)
    p = torch.clamp(p, 1e-12, 1.0)
    return p / torch.sum(p, dim=-1, keepdim=True)


def revolver_step(lay: Layout, st: dict, draws, step: int, k: int, *, epsilon: float,
                  alpha: float, beta: float, dtype=torch.float32) -> dict:
    """One Revolver superstep (Section IV-D) over the blocks in order, each
    block seeing the labels, lambda and loads the earlier ones left.

    ``st`` holds ``labels`` and ``lam`` (int64 [n_pad]), ``probs`` ([n_pad, k])
    and ``loads`` (f32 [k]); a new dict is returned with ``score``."""
    labels, lam = st["labels"].clone(), st["lam"].clone()
    probs = st["probs"].to(dtype).clone()
    loads = st["loads"].clone()
    cap = lay.capacity(k, epsilon)
    bv = lay.block_v
    score = torch.zeros((), dtype=torch.float32, device=lay.device)
    onehot_k = torch.eye(k, dtype=dtype, device=lay.device)
    for b in range(lay.n_blocks):
        v0 = b * bv
        sl = slice(v0, v0 + bv)
        vm, deg, invw = lay.vmask[sl], lay.deg[sl], lay.inv_wsum[sl].to(dtype)
        gumbel, u = draws(step, b)
        gumbel = torch.as_tensor(gumbel, device=lay.device).to(dtype)
        u = torch.as_tensor(u, device=lay.device).to(torch.float32)
        cur = labels[sl]
        p = probs[sl]
        # 1. roulette wheel: argmax of log p + Gumbel noise
        logits = torch.log(torch.clamp(p, 1e-30, 1.0))
        action = torch.where(vm, torch.argmax(logits + gumbel, dim=-1), cur)
        # 2. migration probability per part
        wants = (action != cur) & vm
        p_mig = migration_prob(int_sums(action, deg * wants, k), loads, cap, dtype)
        # 3. + 5. the block's edges: label histogram and eq.-13 factors
        rows, dst, w = lay.block_edges(b)
        hist = histogram(rows, labels[dst], w, bv, k, dtype)
        agree = action[rows] == lam[dst]
        a_col = torch.zeros(bv, dtype=dtype, device=lay.device).index_add_(
            0, rows, torch.where(agree, w, 0.0).to(dtype))
        n_col = torch.zeros(bv, dtype=dtype, device=lay.device).index_add_(
            0, rows, torch.where(agree, 0.0, 1.0).to(dtype))
        del rows, dst, w, agree
        scores = 0.5 * (hist * invw[:, None] + revolver_penalty(loads, cap, k, dtype)[None, :])
        lam_b = torch.argmax(scores, dim=-1)
        score = score + score_sum(torch.max(scores, dim=-1).values, vm)
        # 4. gated migration and 8. the exact load update
        migrate = wants & (u < p_mig[action].float())
        new = torch.where(migrate, action, cur)
        dmig = deg * migrate
        loads = loads + moved(cur, action, dmig, k)
        # 5. finished (self_lambda: every edge reinforces lambda(v)), 6., 7.
        contrib = a_col + torch.where(p_mig[lam_b] > 0, n_col, torch.zeros_like(n_col))
        w_norm, r = split_weights(onehot_k[lam_b] * contrib[:, None], k)
        probs[sl] = weighted_la(p, w_norm, r, alpha, beta)
        labels[sl] = new
        lam[sl] = lam_b
    return {"labels": labels, "lam": lam, "probs": probs, "loads": loads,
            "score": score / torch.tensor(float(lay.n), device=lay.device)}


def spinner_step(lay: Layout, st: dict, draws, step: int, k: int, *, epsilon: float,
                 dtype=torch.float32) -> dict:
    """One Spinner BSP superstep (eqs. 3-5) against the previous labels and
    loads: the best-scoring part (the current one on ties), migration gated
    by the remaining capacity."""
    labels, loads = st["labels"], st["loads"]
    cap = lay.capacity(k, epsilon)
    u = torch.as_tensor(draws(step), device=lay.device).to(torch.float32)
    hist = torch.zeros((lay.n_pad, k), dtype=dtype, device=lay.device)
    for b in range(lay.n_blocks):
        rows, dst, w = lay.block_edges(b)
        hist[b * lay.block_v:(b + 1) * lay.block_v] = histogram(
            rows, labels[dst], w, lay.block_v, k, dtype)
    scores = hist * lay.inv_wsum.to(dtype)[:, None] - (loads / cap).to(dtype)[None, :]
    bump = torch.eye(k, dtype=dtype, device=lay.device)[labels] * 1e-6
    cand = torch.argmax(scores + bump, dim=-1)
    best = torch.max(scores, dim=-1).values
    wants = (cand != labels) & lay.vmask
    p_mig = migration_prob(int_sums(cand, lay.deg * wants, k), loads, cap, dtype)
    migrate = wants & (u < p_mig[cand].float())
    dmig = lay.deg * migrate
    return {"labels": torch.where(migrate, cand, labels),
            "loads": loads + moved(labels, cand, dmig, k),
            "score": score_sum(best, lay.vmask) / torch.tensor(float(lay.n), device=lay.device)}


def degree_ranks(lay: Layout) -> torch.Tensor:
    """Each vertex's percentile in the out-degree order (ties by id)."""
    pos = torch.argsort(torch.argsort(lay.deg, stable=True), stable=True)
    return pos.to(torch.float32) / torch.tensor(float(max(lay.n_pad - 1, 1)),
                                                device=lay.device)


def budgets_spent(lay: Layout, rank: torch.Tensor, steps: int, ramp: int, budget: int) -> torch.Tensor:
    """The re-decisions each vertex has spent after ``steps`` restream
    passes: a pass admits the vertices the degree ramp has unlocked and
    their budget still allows."""
    used = torch.zeros(lay.n_pad, dtype=torch.int32, device=lay.device)
    for t in range(steps):
        active = (rank >= unlock(t, ramp)) & lay.vmask
        if budget:
            active &= used < budget
        used += active.to(used.dtype)
    return used


def unlock(step: int, ramp: int) -> float:
    """The degree gate 1 - (step + 1) / ramp, with the division taken as a
    multiply by the f32 reciprocal and the result rounded to f32 once."""
    return float(np.float32(1.0 - (step + 1) * float(np.float32(1.0 / ramp))))


def restream_step(lay: Layout, st: dict, draws, step: int, k: int, *, epsilon: float,
                  gamma: float, priority_ramp: int, restream_budget: int,
                  dtype=torch.float32) -> dict:
    """One restream pass: per block, the vertices the degree ramp and their
    budget admit take the greedy argmax of tau - gamma * b / C against the
    freshest labels and loads, gated by the remaining capacity.

    ``st`` holds ``labels`` (int64 [n_pad]), ``loads`` (f32 [k]), ``used``
    (int32 [n_pad]) and ``rank`` (f32 [n_pad])."""
    labels, used = st["labels"].clone(), st["used"].clone()
    loads, rank = st["loads"].clone(), st["rank"]
    cap = lay.capacity(k, epsilon)
    bv = lay.block_v
    gate = unlock(step, priority_ramp)
    score = torch.zeros((), dtype=torch.float32, device=lay.device)
    for b in range(lay.n_blocks):
        sl = slice(b * bv, (b + 1) * bv)
        vm, deg, invw = lay.vmask[sl], lay.deg[sl], lay.inv_wsum[sl].to(dtype)
        u = torch.as_tensor(draws(step, b), device=lay.device).to(torch.float32)
        cur = labels[sl]
        active = (rank[sl] >= gate) & vm
        if restream_budget:
            active &= used[sl] < restream_budget
        used[sl] += active.to(used.dtype)
        rows, dst, w = lay.block_edges(b)
        hist = histogram(rows, labels[dst], w, bv, k, dtype)
        del rows, dst, w
        scores = hist * invw[:, None] - gamma * (loads / cap).to(dtype)[None, :]
        bump = torch.eye(k, dtype=dtype, device=lay.device)[cur] * 1e-6
        cand = torch.argmax(scores + bump, dim=-1)
        score = score + score_sum(torch.max(scores, dim=-1).values, vm)
        wants = (cand != cur) & active
        p_mig = migration_prob(int_sums(cand, deg * wants, k), loads, cap, dtype)
        migrate = wants & (u < p_mig[cand].float())
        dmig = deg * migrate
        loads = loads + moved(cur, cand, dmig, k)
        labels[sl] = torch.where(migrate, cand, cur)
    return {"labels": labels, "used": used, "loads": loads, "rank": rank,
            "score": score / torch.tensor(float(lay.n), device=lay.device)}


def initial_state(lay: Layout, algo: str, labels0: np.ndarray, k: int, dtype=torch.float32) -> dict:
    """The reference's state before the first superstep, from the starting
    labels: loads recounted, uniform 1/k probabilities and lambda = labels
    (Revolver), zero budgets and the degree ranks (restream)."""
    labels = lay.padded(labels0, torch.int64)
    st = {"labels": labels, "loads": int_sums(labels, lay.deg, k)}
    if algo == "revolver":
        st["lam"] = labels.clone()
        st["probs"] = torch.full((lay.n_pad, k), 1.0 / k, dtype=dtype, device=lay.device)
    elif algo == "restream":
        st["used"] = torch.zeros(lay.n_pad, dtype=torch.int32, device=lay.device)
        st["rank"] = degree_ranks(lay)
    return st


def step(algo: str, lay: Layout, st: dict, draws, t: int, k: int, rule: dict,
         dtype=torch.float32) -> dict:
    """Superstep ``t`` (0-based) of ``algo`` from state ``st``; ``rule``
    holds the configuration's epsilon and the rule's settings."""
    eps = rule["epsilon"]
    if algo == "revolver":
        if rule.get("weight_mode", "self_lambda") != "self_lambda":
            raise ValueError("the reference follows Revolver's self_lambda weights only")
        return revolver_step(lay, st, draws, t, k, epsilon=eps, alpha=rule.get("alpha", 1.0),
                             beta=rule.get("beta", 0.1), dtype=dtype)
    if algo == "spinner":
        return spinner_step(lay, st, draws, t, k, epsilon=eps, dtype=dtype)
    if algo == "restream":
        return restream_step(lay, st, draws, t, k, epsilon=eps, gamma=rule.get("gamma", 1.0),
                             priority_ramp=rule.get("priority_ramp", 8),
                             restream_budget=rule.get("restream_budget", 32), dtype=dtype)
    raise ValueError(f"no reference rule for {algo!r}")


def uniform_z(labels: np.ndarray, k: int) -> float:
    """The largest |count - n/k| over parts, in binomial standard
    deviations: how far a random start is from uniform."""
    n = labels.size
    counts = np.bincount(np.clip(labels, 0, k - 1), minlength=k)[:k]
    sd = math.sqrt(n * (1.0 / k) * (1.0 - 1.0 / k))
    return float(np.max(np.abs(counts - n / k)) / sd)
