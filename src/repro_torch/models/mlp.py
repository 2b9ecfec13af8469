"""Dense feed-forward blocks: SwiGLU (llama family) and GELU (whisper)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import dense, dense_init, swiglu


class MLP(nn.Module):
    """``w_gate``/``w_up``/``w_down`` (SwiGLU) or ``w_up``/``w_down`` (GELU)."""

    def __init__(self, kind: str, **dense_layers: nn.Module):
        super().__init__()
        self.kind = kind
        for name, layer in dense_layers.items():
            setattr(self, name, layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_mlp(self, x, kind=self.kind)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype, *,
             kind: str = "swiglu", bias: bool = False) -> MLP:
    if kind == "swiglu":
        return MLP(kind,
                   w_gate=dense_init(gen, d_model, d_ff, dtype, bias=bias),
                   w_up=dense_init(gen, d_model, d_ff, dtype, bias=bias),
                   w_down=dense_init(gen, d_ff, d_model, dtype, bias=bias))
    if kind == "gelu":
        return MLP(kind,
                   w_up=dense_init(gen, d_model, d_ff, dtype, bias=bias),
                   w_down=dense_init(gen, d_ff, d_model, dtype, bias=bias))
    raise ValueError(kind)


def apply_mlp(p: MLP, x: torch.Tensor, *, kind: str = "swiglu") -> torch.Tensor:
    if kind == "swiglu":
        return dense(p.w_down, swiglu(dense(p.w_gate, x), dense(p.w_up, x)))
    if kind == "gelu":
        h = torch.nn.functional.gelu(dense(p.w_up, x).float(), approximate="tanh")
        return dense(p.w_down, h.to(x.dtype))
    raise ValueError(kind)
