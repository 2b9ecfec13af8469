"""K6: the RWKV6 wkv recurrence.

Replaces `repro.kernels.wkv6.wkv6_pallas`. Per (batch, head), with the state
S [N, N] (key dim n, value dim m) and token t:

    y_t[m]   = sum_n r_t[n] (S[n, m] + u[n] k_t[n] v_t[m])
    S[n, m] <- S[n, m] exp(logw_t[n]) + k_t[n] v_t[m]

r, k, v, logw are [B, S, H, N] f32, u is [H, N] f32 and the state
[B, H, N, N] f32. Returns y [B, S, H, N] f32 and the final state, which is
written over ``state0`` (the serving cache layer's slice, updated without a
copy) and is ``state0`` itself.

Two implementations of one function:

  * `wkv6_plain` — the token-by-token recurrence, `repro`'s ``_wkv_scan``;
    the CPU path and the oracle;
  * `wkv6_cuda` — the hand-written kernels in ``csrc/wkv6.cu``: from
    ``CHUNK`` tokens on, the chunk-parallel form (a local pass over every
    chunk of ``CHUNK`` tokens from a zero state, then a stitch pass that
    carries the state across the chunks in order and adds its term to y);
    below that, one kernel: for short prompts one that spreads each
    (b, h)'s state over 4 N threads, for the fewest tokens (decode, S = 1)
    the token-serial one (a thread a value column). Any S >= 1, a ragged
    last chunk included.

On the meta device (the dry run) `wkv6_meta` stands in for the kernels:
it returns the outputs' shapes and the kernels' counted work, which
`ops.wkv6` reports to the cost counter.

They differ in rounding only: the kernels fuse multiply-adds, sum y in
partial sums, and (prefill) add the state carried into a chunk as a
separate term.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

HEAD_SIZES = (8, 16, 32, 80)     # N the kernel is instantiated for
CHUNK = 256                      # prefill chunk length L (tokens): kChunk in wkv6.cu
SUB = 16                         # tokens a kernel stages at a time (kSub); L is a multiple

LAUNCHES = _build.LaunchCounter()


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor, state0: torch.Tensor):
    """(y [B,S,H,N] f32, state0 holding the final state), one token at a
    time."""
    state = state0.float()
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], torch.exp(logw[:, t])
        att = state + u[None, :, :, None] * kt[..., None] * vt[..., None, :]
        ys.append(torch.einsum("bhn,bhnm->bhm", rt, att))
        state = state * wt[..., None] + kt[..., None] * vt[..., None, :]
    y = torch.stack(ys, 1) if ys else torch.zeros_like(r, dtype=torch.float32)
    state0.copy_(state)
    return y, state0


def wkv6_meta(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor, state0: torch.Tensor):
    """K6 on meta tensors: ((y of r's shape, ``state0``), the kernels'
    counted work (FLOPs, the tensors read once, the tensors written once))
    — 5 N^2 + 5 N FLOPs a token and head; r, k, v, logw, u read and y
    written, the state read and written (``chip_smoke.py``'s K6 bound)."""
    b, s, h, n = r.shape
    y = torch.empty_like(r, dtype=torch.float32)
    return (y, state0), ((5 * n * n + 5 * n) * b * s * h, (r, k, v, logw, u, state0),
                         (y, state0))


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor, state0: torch.Tensor):
    """Launch the K6 kernels on the current stream of the tensors' device:
    for S >= `CHUNK` the local and stitch passes over chunks of `CHUNK`
    tokens (two kernels), below it the decode kernel (one).

    All inputs contiguous f32 on one CUDA device: r, k, v, logw
    [B, S, H, N], u [H, N], state0 [B, H, N, N], N in `HEAD_SIZES`. Returns
    (y, state0), the final state written over state0; raises on any input
    the kernels do not take, or if a launch fails.
    """
    if r.dim() != 4:
        raise ValueError(f"expected r [B,S,H,N], got {tuple(r.shape)}")
    b, s, h, n = r.shape
    if n not in HEAD_SIZES:
        raise ValueError(f"the wkv6 kernel takes N in {HEAD_SIZES}, got {n}")
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"wkv6_cuda needs CUDA tensors, got {dev}")
    shapes = {"r": (b, s, h, n), "k": (b, s, h, n), "v": (b, s, h, n),
              "logw": (b, s, h, n), "u": (h, n), "state0": (b, h, n, n)}
    tensors = {"r": r, "k": k, "v": v, "logw": logw, "u": u, "state0": state0}
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected torch.float32")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned (the kernels copy 16 bytes a lane)")
    y = torch.empty((b, s, h, n), dtype=torch.float32, device=dev)
    # the chunked passes' scratch: each chunk's zero-init final state, its
    # decay and r scaled by the decay within the chunk
    nc = -(-s // CHUNK) if s >= CHUNK else 0
    s_loc = torch.empty((b, h, nc, n, n), dtype=torch.float32, device=dev)
    w_tot = torch.empty((b, h, nc, n), dtype=torch.float32, device=dev)
    r_eff = torch.empty((b, s, h, n) if nc else (0,), dtype=torch.float32, device=dev)
    lib = _build.load("wkv6")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), state0.data_ptr(), y.data_ptr(), s_loc.data_ptr(),
            r_eff.data_ptr(), w_tot.data_ptr(), b, s, h, n, stream)
    _build.check(lib, "wkv6", code)
    LAUNCHES.add()
    return y, state0
