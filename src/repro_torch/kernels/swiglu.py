"""F1: SiLU(gate) * up in bf16 with `repro`'s ``bf16_silu`` roundings.

Replaces no TPU kernel. Under ``use_activation_sharding(...,
bf16_silu=True)`` `repro.models.common.swiglu` computes
``jax.nn.silu(gate) * up`` in the activation dtype, which XLA compiles
into one loop fusion that rounds to bf16 after each of neg, exp, add 1,
divide, multiply by gate and multiply by up. PyTorch's own bf16 ``silu``
computes in f32 and rounds once (bit-equal to the default f32 path), so
the switch needs the chain written out; eager, that chain is seven ops
(neg, exp, add, reciprocal, x 1, x gate, x up) moving 32 bytes an element
where the fusion moves 6 (the default f32 path's cast, SiLU, cast and
multiply move 26).

Three implementations of one function:

  * `swiglu_bf16_plain` — the chain ``e = exp(-g); d = 1 + e;
    s = 1 / d; (g * s) * up`` in the inputs' dtype; the CPU path, the
    autograd path and the oracle (bit-equal to `repro`'s fusion on the
    CPU);
  * `swiglu_bf16_cuda` — the hand-written kernel in ``csrc/swiglu.cu``: one
    elementwise pass, 16-byte loads of gate and up and 16-byte stores,
    each step in f32 rounded to bf16 as the chain does (bit-equal to the
    chain on an H100);
  * `swiglu_bf16_meta` — the dry run's count: 0 FLOPs (`repro` counts
    dots only), gate and up read, the output written.

The kernel has no backward (``ops.swiglu`` raises under autograd, and
training takes the plain chain).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

LAUNCHES = _build.LaunchCounter()


def swiglu_bf16_plain(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SiLU(gate) * up with a rounding to the inputs' dtype after each step."""
    e = torch.exp(-gate)
    d = 1 + e
    s = 1 / d
    return (gate * s) * up


def swiglu_bf16_meta(gate: torch.Tensor, up: torch.Tensor):
    """F1 on meta tensors: (the output, its counted work (FLOPs, the tensors
    read once, the tensors written once))."""
    out = torch.empty_like(gate)
    return out, (0, (gate, up), (out,))


def swiglu_bf16_cuda(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Launch F1 on the current stream of the tensors' device.

    ``gate`` and ``up`` are contiguous bf16 CUDA tensors of one shape.
    Returns the product in a new tensor; raises on any input the kernel
    does not take, or if the launch fails.
    """
    dev = gate.device
    if dev.type != "cuda":
        raise ValueError(f"swiglu_bf16_cuda needs CUDA tensors, got {dev}")
    for name, t in (("gate", gate), ("up", up)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} has dtype {t.dtype}, expected torch.bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if up.shape != gate.shape:
        raise ValueError(f"up has shape {tuple(up.shape)}, expected {tuple(gate.shape)}")
    out = torch.empty_like(gate)
    lib = _build.load("swiglu")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.swiglu_launch(gate.data_ptr(), up.data_ptr(), out.data_ptr(),
                                 gate.numel(), stream)
    _build.check(lib, "swiglu", code)
    LAUNCHES.add()
    return out
