"""Architecture registry: the ten archs `repro` knows, which of them the
port runs, the 4 shapes' skip matrix, and meta-device input specs for the
dry run (`repro_torch.launch.dryrun`).

Every family is ported: the dense decoders (sliding-window attention and
Cohere's parallel attention/MLP block included), the ``moe`` family
(DeepSeek-V2's MoE FFN and MLA attention) and the ``vlm`` family (patch
embeddings before the tokens), all in `repro_torch.models.transformer`;
the RWKV6 ``ssm`` family (`repro_torch.models.rwkv_model`), the Mamba2
``hybrid`` family (`repro_torch.models.zamba`) and the ``encdec`` family
(`repro_torch.models.whisper`). `UNPORTED` is empty; an arch entered there
makes `get_config` raise `NotImplementedError` naming the ROADMAP item that
brings it.

`cell_skip_reason`, `all_cells`, `runnable_cells` and `reduced_shape` are
`repro`'s. `input_specs` returns tensors on the meta device (shapes and
dtypes, no storage) where `repro` returns ``ShapeDtypeStruct``s: the same
keys, shapes and dtypes.
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.shapes import SHAPE_NAMES, SHAPES, ShapeSpec
from repro_torch.models.config import ModelConfig

ARCHS = {
    "tinyllama-1.1b": "tinyllama_1_1b",
    "command-r-plus-104b": "command_r_plus_104b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "stablelm-1.6b": "stablelm_1_6b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "zamba2-7b": "zamba2_7b",
    "internvl2-1b": "internvl2_1b",
    "whisper-base": "whisper_base",
    "rwkv6-3b": "rwkv6_3b",
}

# archs with a sub-quadratic long-context mechanism run long_500k
_SUBQUADRATIC = {"h2o-danube-3-4b", "zamba2-7b", "rwkv6-3b"}

# arch -> (what it needs that is not ported, the ROADMAP item that ports it)
UNPORTED: dict[str, tuple[str, str]] = {}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    if name in UNPORTED:
        what, item = UNPORTED[name]
        raise NotImplementedError(
            f"{name} needs {what}, which is not ported yet; it comes with "
            f"ROADMAP {item}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    return mod.CONFIG


def cell_skip_reason(arch: str, shape: str) -> str | None:
    """None = the (arch, shape) cell runs; otherwise the documented skip."""
    if shape == "long_500k" and arch not in _SUBQUADRATIC:
        return ("pure full-attention arch: no sub-quadratic mechanism for a "
                "524k-token cache (DESIGN.md §6)")
    return None


def all_cells():
    """Yield (arch, shape, skip_reason) for the full 40-cell grid."""
    for arch in ARCHS:
        for shape in SHAPE_NAMES:
            yield arch, shape, cell_skip_reason(arch, shape)


def runnable_cells():
    return [(a, s) for a, s, skip in all_cells() if skip is None]


# --------------------------------------------------------------------------
# input specs (meta-device stand-ins; no allocation)
# --------------------------------------------------------------------------
def _frontend_spec(cfg: ModelConfig, batch: int, device):
    if cfg.family == "vlm":
        return torch.empty((batch, cfg.n_patches, cfg.d_model), dtype=cfg.cdt, device=device)
    if cfg.family == "encdec":
        return torch.empty((batch, cfg.enc_seq, cfg.d_model), dtype=cfg.cdt, device=device)
    return None


def input_specs(cfg: ModelConfig, shape: ShapeSpec | str, *, device="meta"):
    """Batch tensors for a shape cell, on ``device`` (default meta: shapes
    and dtypes only).

    train:   {"tokens": [B,S] i32, "labels": [B,S] i32, ("frontend")}
    prefill: {"tokens": [B,S] i32, ("frontend")}
    decode:  {"token":  [B]   i32}  (the cache comes from init_cache)
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "train":
        specs = {"tokens": torch.empty((b, s), dtype=i32, device=device),
                 "labels": torch.empty((b, s), dtype=i32, device=device)}
    elif shape.kind == "prefill":
        specs = {"tokens": torch.empty((b, s), dtype=i32, device=device)}
    elif shape.kind == "decode":
        return {"token": torch.empty((b,), dtype=i32, device=device)}
    else:
        raise ValueError(shape.kind)
    fe = _frontend_spec(cfg, b, device)
    if fe is not None:
        specs["frontend"] = fe
    return specs


def reduced_shape(shape: ShapeSpec | str, *, seq: int = 32, batch: int = 2):
    if isinstance(shape, str):
        shape = SHAPES[shape]
    return ShapeSpec(shape.name, seq, batch, shape.kind)
