"""K4: causal / sliding-window GQA flash attention, forward.

Replaces `repro.kernels.flash_attention.flash_attention_pallas`. q
[B, Hq, Sq, D] attends to k, v [B, Hkv, Skv, D] (q head h reads kv head
h // (Hq / Hkv)); queries are right-aligned to the keys (query row i sits at
position i + Skv - Sq), the causal mask keeps keys at or before it, the
sliding window keeps the last ``window`` of those. Masked scores are -1e30
and masked probabilities 0, so a row with no valid key gives 0. Math in
f32, output in q's dtype.

Two implementations of one function:

  * `flash_attention_plain` — the masked softmax over whole rows in f32; the
    CPU path and the oracle;
  * `flash_attention_cuda` — the hand-written kernel in
    ``csrc/flash_attention.cu``, bound by operations. Two bodies behind one
    entry point: bf16 at D 64, 120, 128, 192 or 224 (the serving dtype; 192
    is DeepSeek-V2's MLA prefill, a 128-wide no-RoPE part and a 64-wide
    RoPE part, v padded to match; 120 is h2o-danube-3-4b's head, 224
    zamba2-7b's shared-attention head, both padded to the next 64 columns
    in shared memory only) runs on the tensor cores (128-row q tiles, two
    `wgmma` warpgroups fed by TMA copies of 64-key K/V tiles into a ring,
    the online softmax on the accumulator fragment, P rounded to bf16 for
    P.V, tiles the mask kills never loaded, the heaviest q tiles launched
    first); f32, and bf16 at D 16, 24 or 32, keep the SIMT body (a query
    row on one, two or four threads, f32 products on the CUDA cores), which
    the f32 parity checks need (the reduced MLA configs' heads are 24
    wide).

On the meta device (the dry run) `flash_attention_meta` stands in for the
kernel: it returns the output's shape and the kernel's counted work, which
`ops.flash_attention` reports to the cost counter.

They differ in summation order and, in the tensor-core body, in P's
rounding to bf16 before P.V (at most 2^-9 relative a term, the order of
the output's own bf16 rounding; ``tests/test_torch_attention.py`` repeats
that body's arithmetic in PyTorch and holds it to the plain version).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build

NEG = -1e30
HEAD_DIMS = (16, 24, 32, 64, 120, 128, 192, 224)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = _build.LaunchCounter()


def position_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                  window: int | None) -> torch.Tensor:
    """[Sq, Sk] bool from query positions [Sq, 1] and key positions [1, Sk]:
    which keys each query may see."""
    mask = torch.ones((q_pos.shape[0], k_pos.shape[1]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    return mask


def attention_mask(sq: int, skv: int, *, causal: bool, window: int | None,
                   device) -> torch.Tensor:
    """[Sq, Skv] bool: which keys each right-aligned query row may see."""
    q_pos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    k_pos = torch.arange(skv, device=device)[None, :]
    return position_mask(q_pos, k_pos, causal=causal, window=window)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: int | None = None) -> torch.Tensor:
    """[B, Hq, Sq, D] attention output in q's dtype (f32 math)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = 1.0 / (d ** 0.5)
    qg = q.float().reshape(b, hkv, hq // hkv, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    mask = attention_mask(sq, skv, causal=causal, window=window, device=q.device)
    s = torch.where(mask, s, NEG)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    o = o / torch.where(l > 0, l, 1.0)
    return o.reshape(b, hq, sq, d).to(q.dtype)


@functools.lru_cache(maxsize=256)
def attention_pairs(sq: int, skv: int, *, causal: bool, window: int | None) -> int:
    """How many (query, key) pairs the mask keeps for Sq right-aligned
    queries against Skv keys: the score and P.V work K4 must do (it skips
    the tiles the mask kills)."""
    total = 0
    for i in range(sq):
        p = i + skv - sq                        # the query's position
        lo = 0 if window is None else max(0, p - window + 1)
        hi = min(p + 1, skv) if causal else skv
        total += max(0, hi - lo)
    return total


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int | None = None):
    """K4 on meta tensors: (an output of q's shape and dtype, the kernel's
    counted work (FLOPs, the tensors read once, the tensors written once))
    — 4·D FLOPs a kept (query, key) pair and head (q.k and p.v), q, k, v
    read and the output written (``chip_smoke.py``'s K4 bound)."""
    b, hq, sq, d = q.shape
    out = torch.empty_like(q)
    pairs = attention_pairs(sq, k.shape[2], causal=causal, window=window)
    return out, (4 * d * b * hq * pairs, (q, k, v), (out,))


def check_inputs(name: str, dev: torch.device, dtype: torch.dtype,
                 **tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on ``dev`` with ``dtype``, contiguous
    and 16-byte aligned (the kernels load 4 values at a time)."""
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if dtype not in DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {dtype}")
    for tname, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{tname} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{tname} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{tname} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{tname} must start on a 16-byte boundary")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int | None = None) -> torch.Tensor:
    """Launch the K4 kernel on the current stream of the tensors' device.

    q [B, Hq, Sq, D], k and v [B, Hkv, Skv, D], one dtype (f32 or bf16),
    contiguous, D in `HEAD_DIMS`, Hq a multiple of Hkv. Returns the
    output in a new tensor of q's shape and dtype; raises on any input the
    kernel does not take, or if the launch fails.
    """
    dev = q.device
    check_inputs("flash_attention_cuda", dev, q.dtype, q=q, k=k, v=v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,Hq,Sq,D] and k, v [B,Hkv,Skv,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash-attention kernel takes D in {HEAD_DIMS}, got {d}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if skv == 0:
        return out.zero_()
    lib = _build.load("flash_attention")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            hkv, sq, skv, d, int(causal), window or 0, 1.0 / (d ** 0.5),
            DTYPES[q.dtype], stream)
    _build.check(lib, "flash_attention", code)
    LAUNCHES.add()
    return out
