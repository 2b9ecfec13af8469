"""K5: flash-decode — one query token per sequence against a KV cache.

Replaces `repro.kernels.decode_attention.decode_attention_pallas`. q
[B, Hq, D] attends to cache positions ``j < kv_len[b]`` of k_cache, v_cache
[B, Hkv, S, D] (q head h reads kv head h // (Hq / Hkv)). Returns o
[B, Hq, D] in q's dtype and, with ``return_lse``, the softmax statistics m
(the max score) and l (the sum of exp(score - m)), both [B, Hq] f32, which
a sequence-sharded decode combines. A sequence with kv_len 0 gives o = 0,
m = -1e30, l = 0.

Two implementations of one function:

  * `decode_attention_plain` — the masked softmax over the whole cache in
    f32; the CPU path and the oracle;
  * `decode_attention_cuda` — the hand-written kernel in
    ``csrc/decode_attention.cu``: one launch, bound by bytes in flight. The
    cache is split along S into at most 8 parts (`split_plan`); the CTAs of
    one (b, KV head) form a thread-block cluster, one CTA a split, each
    copying its whole split (bf16 kept bf16) into a shared-memory ring with
    cp.async at its start, reading each K row once for all the group's q
    heads (bf16 on the tensor cores with mma.sync, f32 on the CUDA cores),
    and leaving its partial softmax in shared memory; the split-0 CTA
    combines the partials in split order over distributed shared memory.
    No scratch in device memory, no atomics: deterministic.

On the meta device (the dry run) `decode_attention_meta` stands in for the
kernel: it returns the outputs' shapes and the kernel's counted work, which
`ops.decode_attention` reports to the cost counter.

They differ in summation order (the kernel folds the cache in tiles and
splits) and, for bf16, in the kernel's rounding of the probabilities to
bf16 before P.V (at most 2^-9 relative a term; m and l are taken from the
f32 scores).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES, NEG, check_inputs

HEAD_DIMS = (16, 32, 64, 120, 128, 224)

SPLIT_ROWS = 32          # a split covers a multiple of this many positions
CTAS_PER_SM = 2          # splits are added until the grid has this many CTAs per SM
MAX_SPLITS = 8           # one cluster holds the splits; 8 is the portable cluster size

LAUNCHES = _build.LaunchCounter()


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                           return_lse: bool = False):
    """o [B, Hq, D] in q's dtype (f32 math); with ``return_lse`` also m, l
    [B, Hq] f32."""
    b, hq, d = q.shape
    hkv, s_max = k_cache.shape[1], k_cache.shape[2]
    scale = 1.0 / (d ** 0.5)
    qg = q.float().reshape(b, hkv, hq // hkv, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.float()) * scale
    valid = (torch.arange(s_max, device=q.device)[None, :]
             < kv_len.to(q.device)[:, None])[:, None, None, :]
    s = torch.where(valid, s, NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    o = (o / torch.where(l > 0, l, 1.0)).reshape(b, hq, d).to(q.dtype)
    if return_lse:
        return o, m.reshape(b, hq), l.reshape(b, hq)
    return o


def decode_attention_meta(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                          return_lse: bool = False):
    """K5 on meta tensors: (outputs of the kernel's shapes, its counted
    work (FLOPs, the tensors read once, the tensors written once)).
    kv_len's values are unknown on meta, so every cache position counts:
    the dry run's decode shapes attend a full cache. 4·D FLOPs a position
    and q head; q, the caches and kv_len read, the outputs written
    (``chip_smoke.py``'s K5 bound)."""
    b, hq, d = q.shape
    out = torch.empty_like(q)
    m = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    l = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    outs = (out, m, l) if return_lse else (out,)
    return (outs if return_lse else out), (4 * d * b * hq * k_cache.shape[2],
                                           (q, k_cache, v_cache, kv_len), outs)


def split_plan(b: int, hkv: int, s_max: int, n_sm: int) -> tuple[int, int]:
    """(n_split, chunk): the cache positions each CTA covers. Splits are
    added until the grid has CTAS_PER_SM CTAs per SM, or there are
    MAX_SPLITS of them, each covering a multiple of SPLIT_ROWS positions."""
    rows = math.ceil(s_max / SPLIT_ROWS)
    want = max(1, math.ceil(CTAS_PER_SM * n_sm / (b * hkv)))
    chunk = math.ceil(rows / min(want, rows, MAX_SPLITS)) * SPLIT_ROWS
    return math.ceil(s_max / chunk), chunk


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                          return_lse: bool = False):
    """Launch the K5 kernel on the current stream of the tensors' device.

    q [B, Hq, D], caches [B, Hkv, S, D] of q's dtype (f32 or bf16),
    contiguous, D in `HEAD_DIMS`, Hq a multiple of Hkv; kv_len [B]
    int32 on the same device (values are clamped to [0, S]). Returns new
    tensors; raises on any input the kernel does not take, or if the launch
    fails.
    """
    dev = q.device
    check_inputs("decode_attention_cuda", dev, q.dtype, q=q, k_cache=k_cache,
                 v_cache=v_cache)
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"expected q [B,Hq,D] and caches [B,Hkv,S,D], got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    b, hq, d = q.shape
    hkv, s_max = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not match the cache "
                         f"{tuple(k_cache.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the decode kernel takes D in {HEAD_DIMS}, got {d}")
    if kv_len.device != dev or kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (b,):
        raise ValueError(f"kv_len must be [{b}] int32 on {dev}, got "
                         f"{tuple(kv_len.shape)} {kv_len.dtype} on {kv_len.device}")
    kv_len = kv_len.contiguous()
    out = torch.empty_like(q)
    m = torch.empty((b, hq), dtype=torch.float32, device=dev)
    l = torch.empty((b, hq), dtype=torch.float32, device=dev)
    if b == 0 or hq == 0 or s_max == 0:
        out.zero_()
        m.fill_(NEG)
        l.zero_()
        return (out, m, l) if return_lse else out
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, chunk = split_plan(b, hkv, s_max, n_sm)
    lib = _build.load("decode_attention")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            kv_len.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(), b, hq,
            hkv, s_max, d, n_split, chunk, 1.0 / (d ** 0.5), DTYPES[q.dtype], stream)
    _build.check(lib, "decode_attention", code)
    LAUNCHES.add()
    return (out, m, l) if return_lse else out
