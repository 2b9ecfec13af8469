"""Carry `repro`'s LM parameters across into the port.

`repro` keeps an LM's parameters as a nested dict whose block leaves carry
a stacked ``[L, ...]`` layer axis (built with ``jax.vmap``) and whose dense
weights are ``[d_in, d_out]``. `lm_params_from_numpy` takes that tree with
numpy leaves (``jax.device_get(params)``) or tensor leaves (a checkpoint
read by `repro_torch.checkpoint`), of a dense decoder or of an RWKV6 model,
and returns the port's `Decoder` or `RWKV`, which computes
what `repro` computes from them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device_graph import resolve_device
from repro_torch.models.attention import Attention
from repro_torch.models.common import Dense, Embed, Norm
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import MLP
from repro_torch.models.rwkv6 import ChannelMix, TimeMix
from repro_torch.models.rwkv_model import RWKV, RWKVBlock
from repro_torch.models.transformer import Block, Decoder, check_ported


def tensor_from_numpy(a, device) -> torch.Tensor:
    """A copy of ``a`` on ``device``. bf16 arrays (``ml_dtypes``, which
    `torch.from_numpy` refuses) go through a uint16 view of their bits; a
    tensor (a checkpoint leaf the store already rebuilt) is moved as it
    is."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _paths(tree: dict, prefix: str = "") -> set:
    out = set()
    for k, v in tree.items():
        out |= _paths(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k}
    return out


def lm_params_from_numpy(cfg: ModelConfig, tree: dict, device) -> Decoder | RWKV:
    """The port's `Decoder` (dense family) or `RWKV` (``ssm`` family) on
    ``device`` from `repro`'s parameter tree with numpy leaves. Raises if
    the tree holds leaves the port would not use (or lacks some)."""
    if cfg.family != "ssm":
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

    def module(d, cls):
        """``cls`` from a dict of arrays, dense layers ({w}) and norms ({g, b})."""
        try:
            return cls(**{k: (lin(v) if "w" in v else norm(v)) if isinstance(v, dict)
                          else put(v) for k, v in d.items()})
        except TypeError as e:      # a key too many or too few
            raise ValueError(f"parameter tree does not match {cfg.name}: {e}") from e

    embed = Embed(put(tree["embed"]["emb"]))
    bts = [layer(tree["blocks"], i) for i in range(cfg.n_layers)]
    if cfg.family == "ssm":
        blocks = [RWKVBlock(norm(bt["ln1"]), norm(bt["ln2"]), module(bt["time"], TimeMix),
                            module(bt["chan"], ChannelMix))
                  for bt in bts]
        model = RWKV(embed, norm(tree["ln0"]), blocks, norm(tree["ln_f"]),
                     Embed(put(tree["unembed"]["emb"])))
    else:
        blocks = [Block(norm(bt["ln1"]),
                        Attention(*(lin(bt["attn"][n]) for n in ("wq", "wk", "wv", "wo"))),
                        norm(bt["ln2"]),
                        MLP(cfg.mlp_kind, **{k: lin(v) for k, v in bt["mlp"].items()}))
                  for bt in bts]
        unembed = None if cfg.tie_embeddings else Embed(put(tree["unembed"]["emb"]))
        model = Decoder(embed, blocks, norm(tree["ln_f"]), unembed)

    # every leaf of the tree is a parameter of the model, and back
    used = {".".join(p for j, p in enumerate(name.split("."))
                     if not (j == 1 and name.startswith("blocks.")))
            for name, _ in model.named_parameters()}
    if used != _paths(tree):
        raise ValueError(f"parameter tree does not match {cfg.name}: "
                         f"unused {sorted(_paths(tree) - used)}, "
                         f"missing {sorted(used - _paths(tree))}")
    return model
