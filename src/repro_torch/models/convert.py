"""Carry `repro`'s LM parameters across into the port.

`repro` keeps a dense decoder's parameters as a nested dict whose block
leaves carry a stacked ``[L, ...]`` layer axis (built with ``jax.vmap``)
and whose dense weights are ``[d_in, d_out]``. `lm_params_from_numpy`
takes that tree with numpy leaves (``jax.device_get(params)``) and returns
the port's `Decoder`, which computes what `repro` computes from them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device_graph import resolve_device
from repro_torch.models.attention import Attention
from repro_torch.models.common import Dense, Embed, Norm
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import MLP
from repro_torch.models.transformer import Block, Decoder, check_ported


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A copy of ``a`` on ``device``. bf16 arrays (``ml_dtypes``, which
    `torch.from_numpy` refuses) go through a uint16 view of their bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _paths(tree: dict, prefix: str = "") -> set:
    out = set()
    for k, v in tree.items():
        out |= _paths(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k}
    return out


def lm_params_from_numpy(cfg: ModelConfig, tree: dict, device) -> Decoder:
    """The port's `Decoder` on ``device`` from `repro`'s dense-decoder
    parameter tree with numpy leaves. Raises if the tree holds leaves the
    port would not use (or lacks some)."""
    check_ported(cfg)
    dev = resolve_device(device)

    def put(a):
        return tensor_from_numpy(a, dev)

    def norm(d):
        return Norm(put(d["g"]), put(d["b"]) if "b" in d else None)

    def lin(d):
        return Dense(put(d["w"]), put(d["b"]) if "b" in d else None)

    def layer(d, i):
        return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in d.items()}

    blocks = []
    for i in range(cfg.n_layers):
        bt = layer(tree["blocks"], i)
        a = bt["attn"]
        blocks.append(Block(
            norm(bt["ln1"]),
            Attention(lin(a["wq"]), lin(a["wk"]), lin(a["wv"]), lin(a["wo"])),
            norm(bt["ln2"]),
            MLP(cfg.mlp_kind, **{k: lin(v) for k, v in bt["mlp"].items()})))
    unembed = None if cfg.tie_embeddings else Embed(put(tree["unembed"]["emb"]))
    model = Decoder(Embed(put(tree["embed"]["emb"])), blocks, norm(tree["ln_f"]), unembed)

    # every leaf of the tree is a parameter of the model, and back
    used = {".".join(p for j, p in enumerate(name.split("."))
                     if not (j == 1 and name.startswith("blocks.")))
            for name, _ in model.named_parameters()}
    if used != _paths(tree):
        raise ValueError(f"parameter tree does not match {cfg.name}: "
                         f"unused {sorted(_paths(tree) - used)}, "
                         f"missing {sorted(used - _paths(tree))}")
    return model
