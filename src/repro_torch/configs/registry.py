"""Architecture registry: the ten archs `repro` knows, and which of them
the port runs.

Every family is ported: the dense decoders (sliding-window attention and
Cohere's parallel attention/MLP block included), the ``moe`` family
(DeepSeek-V2's MoE FFN and MLA attention) and the ``vlm`` family (patch
embeddings before the tokens), all in `repro_torch.models.transformer`;
the RWKV6 ``ssm`` family (`repro_torch.models.rwkv_model`), the Mamba2
``hybrid`` family (`repro_torch.models.zamba`) and the ``encdec`` family
(`repro_torch.models.whisper`). `UNPORTED` is empty; an arch entered there
makes `get_config` raise `NotImplementedError` naming the ROADMAP item that
brings it. `repro`'s ``input_specs`` (ShapeDtypeStruct stand-ins for the
JAX dry-run) has no counterpart here.
"""
from __future__ import annotations

import importlib

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
