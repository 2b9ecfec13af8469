"""AdamW + warmup-cosine schedule + global-norm clipping, mixed precision.

The port of `repro.optim.adamw`, with its arithmetic: f32 master weights
and f32 moments, the step count incremented before the schedule is read,
bias corrections ``1 - b ** count`` in f32, weight decay on every leaf, the
clip scale ``min(1, max_norm / max(norm, 1e-12))`` over the f32 gradients,
and new parameters the masters cast to the parameter dtype.

Trees here are ``{parameter name: tensor}`` mappings (a model's
`named_parameters` order) where `repro` has pytrees. State layout:

  {"master": {name: f32}, "m": {name: f32}, "v": {name: f32},
   "count": 0-dim int32, ("ef_err": {name: f32} — the error-feedback
   residuals of gradient compression, whose collective comes with the
   port's LM parallelism; nothing reads them yet)}

`adamw_update` updates the state's tensors in place (the trainer holds one
state; a full-width state is 13 GB of f32) and returns it.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), a 0-dim f32
    tensor computed in f32: linear warmup, then cosine down to
    ``min_lr_frac``."""
    step = torch.as_tensor(step).to(torch.float32)
    f32 = dict(dtype=torch.float32, device=step.device)
    warm = cfg.lr * torch.minimum(torch.tensor(1.0, **f32), step / max(cfg.warmup_steps, 1))
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params: dict, *, ef_compression: bool = False) -> dict:
    """Fresh state for ``params`` ({name: tensor}): f32 copies as masters,
    zero moments, count 0."""
    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}

    first = next(iter(params.values()))
    state = {
        "master": {n: p.detach().to(torch.float32, copy=True) for n, p in params.items()},
        "m": zeros(),
        "v": zeros(),
        "count": torch.zeros((), dtype=torch.int32, device=first.device),
    }
    if ef_compression:
        state["ef_err"] = zeros()
    return state


def clip_by_global_norm(grads: dict, max_norm: float) -> tuple[dict, torch.Tensor]:
    """(grads scaled by ``min(1, max_norm / max(norm, 1e-12))``, the global
    L2 norm), the norm in f32."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(grads: dict, opt_state: dict, cfg: OptConfig, *, param_dtype):
    """One step from ``grads`` ({name: tensor}, any float dtype): returns
    (new parameters {name: tensor in ``param_dtype``}, ``opt_state``
    updated in place, {"grad_norm", "lr"})."""
    grads = {n: g.float() for n, g in grads.items()}
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    opt_state["count"] += 1
    count = opt_state["count"]
    lr = schedule(cfg, count)
    b1, b2 = cfg.b1, cfg.b2
    c = count.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=c.device), c)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=c.device), c)
    new_params = {}
    for n, g in grads.items():
        m, v, p = opt_state["m"][n], opt_state["v"][n], opt_state["master"][n]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        p.sub_(lr * (step + cfg.weight_decay * p))
        new_params[n] = p.to(param_dtype)
    return new_params, opt_state, {"grad_norm": gnorm, "lr": lr}
