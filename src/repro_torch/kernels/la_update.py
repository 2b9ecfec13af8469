"""K2: the weighted learning-automaton probability update, eqs. (8)/(9).

Replaces `repro.kernels.la_update.la_update_pallas`. Eqs. (8)/(9) need k
sequential passes over every vertex's [k] probability vector, penalty
passes first.

Two implementations of one function:

  * `la_update_plain` — the k-pass loop of `repro_torch.core.la`; the CPU
    path and the oracle;
  * `la_update_cuda` — the hand-written kernel in ``csrc/la_update.cu`` (one
    thread per row, the row and its per-slot factors in registers across
    all k passes, 16-byte row loads where k % 4 == 0, the penalty-first
    order built in-kernel instead of an argsort, a pass skipped by a whole
    warp when none of its rows runs it, no fused multiply-adds).

The two agree to atol 5e-6 / rtol 5e-5: every pass rounds alike, only the
renormalization sum may be reduced in another order.
"""
from __future__ import annotations

import torch

from repro_torch.core.la import weighted_la_update
from repro_torch.kernels import _build

MAX_K = 64

LAUNCHES = _build.LaunchCounter()


def la_update_plain(probs: torch.Tensor, weights: torch.Tensor,
                    signals: torch.Tensor, alpha: float, beta: float, *,
                    renorm: bool = True) -> torch.Tensor:
    """[..., k] updated probabilities (penalty-first passes), a new tensor."""
    return weighted_la_update(probs, weights, signals, alpha, beta,
                              renorm=renorm, pass_order="penalty_first")


def la_update_cuda(probs: torch.Tensor, weights: torch.Tensor,
                   signals: torch.Tensor, alpha: float, beta: float, *,
                   renorm: bool = True) -> torch.Tensor:
    """Launch the K2 kernel on the current stream of the tensors' device.

    ``probs``, ``weights`` and ``signals`` are contiguous f32 [..., k] CUDA
    tensors of one shape, ``signals`` in {0, 1}. Returns the updated
    probabilities in a new tensor; raises on any input the kernel does not
    take, or if the launch fails.
    """
    dev = probs.device
    if dev.type != "cuda":
        raise ValueError(f"la_update_cuda needs CUDA tensors, got {dev}")
    shape = tuple(probs.shape)
    k = shape[-1]
    if not 2 <= k <= MAX_K:
        raise ValueError(f"the LA-update kernel takes 2 <= k <= {MAX_K}, got {k}")
    for name, t in (("probs", probs), ("weights", weights), ("signals", signals)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected torch.float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    v = probs.numel() // k
    lib = _build.load("la_update")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.la_update_launch(
            probs.data_ptr(), weights.data_ptr(), signals.data_ptr(),
            out.data_ptr(), v, k, float(alpha), float(beta), int(renorm),
            stream)
    _build.check(lib, "la_update", code)
    LAUNCHES.add()
    return out
