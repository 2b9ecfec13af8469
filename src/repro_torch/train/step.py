"""train_step / serve_step factories.

The port of `repro.train.step`. ``make_train_step`` returns a
(state, batch) -> (state, metrics) function: CE loss -> gradients
(optionally over microbatches, accumulated in f32) -> global-norm clip ->
AdamW on f32 masters -> the parameters in their dtype. The state is
``{"params": model, "opt": {"master", "m", "v", "count"}, "step"}`` with
the optimizer's trees keyed by parameter name; a step updates it in place
(`repro` donates its state to the jitted step) and returns it.

Gradients come from `torch.autograd.grad` over the model's parameters
(``requires_grad`` on: `train_state`), never through ``.grad``: with
microbatches, each microbatch's gradients are cast to f32, divided by the
microbatch count and summed into f32 buffers, `repro`'s accumulation (a
``.grad`` would sum in the parameter dtype). The forward runs the
differentiable plain forms (`repro_torch.kernels.ops.needs_grad`); the
hand-written kernels serve.

On disk the state is `repro`'s tree (`train_state_tree`): the parameters,
masters and moments stacked as `repro_torch.models.convert` stacks them,
so `repro`'s trainer, the port's and ``launch/serve.py --ckpt-dir`` read
the same checkpoints.

``make_prefill_step`` / ``make_decode_step`` are the thin serving entry
points, as in `repro`.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint import load_checkpoint_tensors, unflatten
from repro_torch.core.device_graph import resolve_device
from repro_torch.models import init_cache, init_lm, lm_decode_step, lm_loss, lm_prefill
from repro_torch.models.convert import lm_params_from_numpy, lm_params_to_tree, tree_to_named
from repro_torch.optim.adamw import OptConfig, adamw_update, init_opt_state

_MOMENTS = ("master", "m", "v", "ef_err")


def train_state(model, *, ef_compression: bool = False) -> dict:
    """A fresh train state around ``model``, whose parameters are switched
    to ``requires_grad``."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    return {"params": model,
            "opt": init_opt_state(params, ef_compression=ef_compression),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def init_train_state(cfg, opt_cfg: OptConfig, seed: int, device="cuda", *,
                     ef_compression: bool = False) -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (`repro`'s ``jax.random.PRNGKey(seed)``: the same seed gives
    the same state, not `repro`'s numbers), and a fresh optimizer state."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return train_state(init_lm(cfg, gen, dev), ef_compression=ef_compression)


def train_state_tree(state: dict) -> dict:
    """The state in `repro`'s checkpoint layout: ``{"params": tree, "opt":
    {"master": tree, "m": tree, "v": tree, "count"}, "step"}``, tensor
    leaves on the state's device (the stacked ones new tensors)."""
    opt = state["opt"]
    tree_opt = {k: lm_params_to_tree(opt[k]) for k in _MOMENTS if k in opt}
    tree_opt["count"] = opt["count"]
    return {"params": lm_params_to_tree(state["params"]), "opt": tree_opt,
            "step": state["step"]}


def restore_train_state(cfg, ckpt_dir: str, step: int, device="cuda") -> dict:
    """The train state of checkpoint ``step`` in ``ckpt_dir`` (written by
    the port's trainer or by `repro`'s) on ``device``. Raises if a tree does
    not match ``cfg`` or the optimizer's leaves do not match the
    parameters' shapes."""
    dev = resolve_device(device)
    tree = unflatten(load_checkpoint_tensors(ckpt_dir, step, dev))
    model = lm_params_from_numpy(cfg, tree["params"], dev)
    model.requires_grad_(True)
    opt = {"count": tree["opt"]["count"].to(torch.int32)}
    for k in _MOMENTS:
        if k in tree["opt"]:
            opt[k] = tree_to_named(model, tree["opt"][k])
    for name, p in model.named_parameters():
        for k in _MOMENTS:
            if k in opt and (opt[k][name].shape != p.shape
                             or opt[k][name].dtype != torch.float32):
                raise ValueError(f"checkpoint step {step}: opt/{k} of {name} is "
                                 f"{opt[k][name].dtype} {tuple(opt[k][name].shape)}, "
                                 f"expected float32 {tuple(p.shape)}")
    return {"params": model, "opt": opt, "step": tree["step"].to(torch.int32)}


def make_train_step(cfg, opt_cfg: OptConfig, *, microbatch: int = 1):
    def grads_of(model, params, mb):
        loss, _ = lm_loss(model, cfg, mb)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(params, grads)]

    def train_step(state: dict, batch: dict):
        """batch: ``{"tokens", "labels", ("frontend")}`` arrays or tensors,
        moved to the parameters' device."""
        model = state["params"]
        names, params = zip(*model.named_parameters())
        dev = params[0].device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        if microbatch > 1:
            mbatch = {k: v.reshape((microbatch, -1) + tuple(v.shape[1:]))
                      for k, v in batch.items()}
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=dev) for p in params]
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(microbatch):
                l_i, g_i = grads_of(model, params, {k: v[i] for k, v in mbatch.items()})
                for acc, g in zip(grads, g_i):
                    acc.add_(g.float() / microbatch)
                loss = loss + l_i / microbatch
        else:
            loss, grads = grads_of(model, params, batch)
        new_params, _, om = adamw_update(dict(zip(names, grads)), state["opt"], opt_cfg,
                                         param_dtype=cfg.pdt)
        del grads
        with torch.no_grad():
            for name, p in zip(names, params):
                p.copy_(new_params[name])
        state["step"] += 1
        return state, {"loss": loss, **om}

    return train_step


def make_prefill_step(cfg, s_max: int):
    def prefill_step(model, batch):
        cache = init_cache(cfg, batch["tokens"].shape[0], s_max, batch["tokens"].device)
        return lm_prefill(model, cfg, cache, batch)
    return prefill_step


def make_decode_step(cfg):
    def decode_step(model, cache, token):
        return lm_decode_step(model, cfg, cache, token)
    return decode_step
