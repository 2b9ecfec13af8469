"""The port's attention kernels on the CPU: the plain versions of K4 (flash
attention) and K5 (flash decode) against `repro`'s Pallas kernels in
interpret mode and its oracles, the plain counterparts of `repro`'s naive
and chunked attention, the decode split-and-combine arithmetic, and the
device routing. The CUDA kernels themselves run only on the card, where
``chip_smoke.py`` holds each against its plain version.

Tolerances, all f32: 2e-5 where both sides take a softmax over the same
scores and differ only in summation order (the bound `tests/test_kernels.py`
holds `repro`'s own kernels to)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref
from repro.models import attention as jattn

from repro_torch.kernels import decode_attention, flash_attention, ops
from repro_torch.models import attention as tattn

TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# --------------------------------------------------------------------------
# K4
# --------------------------------------------------------------------------
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", [
    (2, 4, 2, 64, 64, 32, True, None),       # GQA group 2
    (1, 8, 1, 128, 128, 16, True, 32),       # group 8, sliding window
    (2, 4, 4, 64, 128, 32, True, None),      # Sq < Skv, right-aligned
    (1, 2, 2, 64, 64, 64, False, None),      # no mask
    (1, 8, 2, 64, 64, 16, False, 16),        # window without causality
])
def test_flash_attention_plain_matches_pallas_and_ref(b, hq, hkv, sq, skv, d,
                                                      causal, window):
    q, k, v = _qkv(0, b, hq, hkv, sq, skv, d)
    got = flash_attention.flash_attention_plain(*_t(q, k, v), causal=causal,
                                                window=window).numpy()
    pallas = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, window=window,
                                  block_q=32, block_k=32, interpret=True)
    want = ref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("sq,skv,window", [(37, 53, None), (53, 53, 7), (1, 29, None)])
def test_flash_attention_plain_ragged_lengths_match_ref(sq, skv, window):
    """Lengths no tile divides (the CUDA kernel masks them in-kernel)."""
    q, k, v = _qkv(1, 2, 8, 2, sq, skv, 16)
    got = flash_attention.flash_attention_plain(*_t(q, k, v), window=window)
    want = ref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_attention_plain_row_without_keys_gives_zero():
    """Sq > Skv: the first Sq - Skv query rows precede every key, so the
    causal mask leaves them none; they come out 0, as from the Pallas
    kernel (the -inf oracle gives NaN there)."""
    q, k, v = _qkv(2, 1, 4, 2, 64, 32, 16)
    got = flash_attention.flash_attention_plain(*_t(q, k, v)).numpy()
    pallas = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=32, block_k=32,
        interpret=True))
    assert np.all(got[:, :, :32] == 0)
    np.testing.assert_allclose(got, pallas, **TOL)


def test_flash_attention_plain_keeps_bf16():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(3, 1, 4, 2, 32, 32, 16))
    got = flash_attention.flash_attention_plain(q, k, v)
    assert got.dtype == torch.bfloat16
    want = flash_attention.flash_attention_plain(q.float(), k.float(), v.float())
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=1e-2, rtol=1e-2)


def _tensor_core_attention(q, k, v, *, causal, window):
    """K4's tensor-core body in PyTorch: an online softmax over kv tiles of
    the kernel's Bk (64 keys), scores scaled into the log2 domain, masked
    scores -1e30 and masked probabilities 0, the row sum l over the f32
    probabilities, and P rounded to bf16 before P.V (products
    of bf16 values, summed in f32)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    bk = 64
    qg = q.float().reshape(b, hkv, hq // hkv, sq, d)
    mask = flash_attention.attention_mask(sq, skv, causal=causal, window=window, device="cpu")
    m = torch.full((b, hkv, hq // hkv, sq, 1), flash_attention.NEG)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, hq // hkv, sq, d))
    for t0 in range(0, skv, bk):
        kt, vt, ok = k[:, :, t0:t0 + bk].float(), v[:, :, t0:t0 + bk].float(), mask[:, t0:t0 + bk]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kt) * (math.log2(math.e) / math.sqrt(d))
        s = torch.where(ok, s, flash_attention.NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(ok, torch.exp2(s - m_new), 0.0)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhgqk,bhkd->bhgqd", p.to(torch.bfloat16).float(), vt)
        m = m_new
    o = acc / torch.where(l > 0, l, 1.0)
    return o.reshape(b, hq, sq, d).to(q.dtype)


@pytest.mark.parametrize("skv", [64, 1024])
@pytest.mark.parametrize("d", [64, 128, 192])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 100), (False, 37)])
def test_bf16_probabilities_stay_within_the_card_tolerance(skv, d, causal, window):
    """Rounding P to bf16 before P.V (K4's tensor-core body) keeps the output
    within the card check's bf16 tolerance of the plain version (atol 2e-2,
    rtol 1e-2: ATTN_TOL["bfloat16"] in chip_smoke.py), with bf16 inputs."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(9, 1, 4, 2, skv, skv, d))
    got = _tensor_core_attention(q, k, v, causal=causal, window=window)
    want = flash_attention.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=1e-2)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24), (False, None)])
def test_naive_and_chunked_match_repro(causal, window):
    """The plain counterparts of `repro`'s impl="naive" and impl="xla"."""
    q, k, v = _qkv(4, 2, 4, 2, 40, 56, 16)
    qt, kt, vt = _t(q, k, v)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    np.testing.assert_allclose(
        tattn.naive_attention(qt, kt, vt, causal=causal, window=window).numpy(),
        np.asarray(jattn.naive_attention(jq, jk, jv, causal=causal, window=window)),
        **TOL)
    np.testing.assert_allclose(
        tattn.flash_attention_chunked(qt, kt, vt, causal=causal, window=window,
                                      block_q=16, block_k=16).numpy(),
        np.asarray(jattn.flash_attention_xla(jq, jk, jv, causal=causal,
                                             window=window, block_q=16,
                                             block_k=16)),
        **TOL)


# --------------------------------------------------------------------------
# K5
# --------------------------------------------------------------------------
def _decode_inputs(seed, b, hq, hkv, s, d, kv_len):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            np.asarray(kv_len, np.int32))


@pytest.mark.parametrize("b,hq,hkv,s,d,kv_len", [
    (4, 8, 2, 128, 32, [0, 1, 128, 77]),     # group 4; empty, one, full, mixed
    (3, 8, 1, 64, 16, [64, 5, 33]),          # group 8
    (2, 4, 4, 128, 64, [100, 128]),          # MHA (group 1)
])
def test_decode_attention_plain_matches_pallas(b, hq, hkv, s, d, kv_len):
    q, kc, vc, lens = _decode_inputs(5, b, hq, hkv, s, d, kv_len)
    o, m, l = decode_attention.decode_attention_plain(*_t(q, kc, vc, lens),
                                                      return_lse=True)
    jo, jm, jl = jops.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                       jnp.asarray(vc), jnp.asarray(lens),
                                       block_k=32, interpret=True,
                                       return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), **TOL)
    empty = lens == 0
    assert np.all(o.numpy()[empty] == 0) and np.all(l.numpy()[empty] == 0)
    assert np.all(m.numpy()[empty] == np.float32(-1e30))
    live = ~empty
    want = ref.decode_attention_ref(jnp.asarray(q[live]), jnp.asarray(kc[live]),
                                    jnp.asarray(vc[live]), jnp.asarray(lens[live]))
    np.testing.assert_allclose(o.numpy()[live], np.asarray(want), **TOL)
    assert decode_attention.decode_attention_plain(*_t(q, kc, vc, lens)).shape == (b, hq, d)


@pytest.mark.parametrize("b,hkv,s_max,n_sm,plan", [
    (8, 4, 1152, 132, (8, 160)),     # the tinyllama serving shape on an H100
    (1, 1, 100, 132, (4, 32)),
    (64, 8, 4096, 132, (1, 4096)),
    (2, 2, 30, 132, (1, 32)),
    (1, 1, 4096, 132, (8, 512)),     # capped at MAX_SPLITS, one cluster
])
def test_decode_split_plan(b, hkv, s_max, n_sm, plan):
    n_split, chunk = decode_attention.split_plan(b, hkv, s_max, n_sm)
    assert (n_split, chunk) == plan
    assert n_split <= decode_attention.MAX_SPLITS
    assert chunk % decode_attention.SPLIT_ROWS == 0
    assert (n_split - 1) * chunk < s_max <= n_split * chunk


@pytest.mark.parametrize("b,hkv,s,kv_len,n_split", [
    (3, 2, 200, [0, 150, 200], 7),       # a split wholly past kv_len
    (1, 1, 1000, [1000], 8),             # kv_len = S at the cap
    (2, 2, 1152, [1088, 161], 8),        # the serving split, kv_len off the boundary
])
def test_split_and_combine_give_the_whole_cache_statistics(b, hkv, s, kv_len, n_split):
    """The CUDA kernel's arithmetic in PyTorch: per-split partial softmax,
    then M = max m_i, L = sum l_i e^(m_i - M), o = sum acc_i e^(m_i - M) / L
    over the splits in order, equals the whole-cache o, m and l."""
    hq, d = 4 * hkv, 16
    q, kc, vc, lens = _t(*_decode_inputs(6, b, hq, hkv, s, d, kv_len))
    planned, chunk = decode_attention.split_plan(b, hkv, s, 132)
    assert planned == n_split
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d)
    ms, ls, accs = [], [], []
    for i in range(n_split):
        lo, hi = i * chunk, (i + 1) * chunk
        sc = torch.einsum("bhgd,bhkd->bhgk", qg, kc[:, :, lo:hi]) / math.sqrt(d)
        pos = torch.arange(lo, min(hi, s))
        valid = (pos[None, :] < lens[:, None])[:, None, None, :]
        sc = torch.where(valid, sc, -1e30)
        m = sc.amax(-1, keepdim=True)
        p = torch.where(valid, torch.exp(sc - m), 0.0)
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        accs.append(torch.einsum("bhgk,bhkd->bhgd", p, vc[:, :, lo:hi]))
    big = torch.stack(ms).amax(0)
    total = sum(l_i * torch.exp(m_i - big) for m_i, l_i in zip(ms, ls))
    num = sum(a_i * torch.exp(m_i - big) for m_i, a_i in zip(ms, accs))
    o = (num / torch.where(total > 0, total, 1.0)).reshape(b, hq, d)
    want_o, want_m, want_l = decode_attention.decode_attention_plain(
        q, kc, vc, lens, return_lse=True)
    np.testing.assert_allclose(o.numpy(), want_o.numpy(), **TOL)
    np.testing.assert_allclose(big.reshape(b, hq).numpy(), want_m.numpy(), **TOL)
    np.testing.assert_allclose(total.reshape(b, hq).numpy(), want_l.numpy(), **TOL)


def _mma_decode_attention(q, k_cache, v_cache, kv_len, *, n_sm=132, warps=4):
    """K5's tensor-core body (bf16, group <= 16) in PyTorch: the cache split
    by `split_plan`; in a split, warp w takes every 4th 16-key chunk (w, w +
    4, ...) with its own online softmax (scores and probabilities in f32, P
    rounded to bf16 before P V, products of bf16 values summed in f32); the
    warps' partials combined in warp order, then the splits' in split order;
    o rounded to bf16. Returns (o, m, l)."""
    b, hq, d = q.shape
    hkv, s_max = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    n_split, chunk = decode_attention.split_plan(b, hkv, s_max, n_sm)
    qg = q.float().reshape(b, hkv, g, d)
    kf, vf = k_cache.float(), v_cache.float()
    neg = torch.tensor(-1e30)
    scale = 1.0 / math.sqrt(d)

    def combine(parts):
        big = torch.stack([m for m, _, _ in parts]).amax(0)
        total = sum(l * torch.exp(m - big) for m, l, _ in parts)
        num = sum(a * torch.exp(m - big) for m, _, a in parts)
        return big, total, num

    o = torch.zeros((b, hkv, g, d))
    m_out = torch.zeros((b, hkv, g, 1))
    l_out = torch.zeros((b, hkv, g, 1))
    for bi in range(b):
        length = int(kv_len[bi])
        splits = []
        for si in range(n_split):
            s0, s1 = si * chunk, min(si * chunk + chunk, length)
            n_chunks = max(0, -(-(s1 - s0) // 16))
            warp_parts = []
            for w in range(warps):
                m = torch.full((hkv, g, 1), -1e30)
                l = torch.zeros((hkv, g, 1))
                acc = torch.zeros((hkv, g, d))
                for c in range(w, n_chunks, warps):
                    t0 = s0 + 16 * c
                    keys = torch.arange(t0, t0 + 16)
                    valid = keys < s1
                    kt = kf[bi, :, t0:t0 + 16]
                    vt = vf[bi, :, t0:t0 + 16]
                    pad = 16 - kt.shape[1]
                    kt = torch.nn.functional.pad(kt, (0, 0, 0, pad))
                    vt = torch.nn.functional.pad(vt, (0, 0, 0, pad))
                    sc = torch.einsum("hgd,hkd->hgk", qg[bi], kt) * scale
                    sc = torch.where(valid, sc, neg)
                    m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                    corr = torch.exp(m - m_new)
                    pr = torch.where(sc == neg, 0.0, torch.exp(sc - m_new))
                    l = l * corr + pr.sum(-1, keepdim=True)
                    acc = acc * corr + torch.einsum(
                        "hgk,hkd->hgd", pr.to(torch.bfloat16).float(), vt)
                    m = m_new
                warp_parts.append((m, l, acc))
            splits.append(combine(warp_parts))
        big, total, num = combine(splits)
        o[bi] = num / torch.where(total > 0, total, 1.0)
        m_out[bi], l_out[bi] = big, total
    return (o.reshape(b, hq, d).to(torch.bfloat16), m_out.reshape(b, hq),
            l_out.reshape(b, hq))


@pytest.mark.parametrize("b,hq,hkv,s,d,kv_len", [
    (2, 32, 4, 1152, 64, [1088, 161]),       # the tinyllama decode shape's split plan
    (3, 16, 2, 300, 128, [300, 17, 0]),      # d 128, a ragged chunk, an empty row
    (2, 8, 8, 64, 64, [64, 1]),              # group 1
])
def test_bf16_decode_probabilities_stay_within_the_card_tolerance(b, hq, hkv, s, d, kv_len):
    """K5's tensor-core body (per-warp 16-key chunks, P rounded to bf16,
    warp-order then split-order combine) keeps o within the card check's
    bf16 tolerance of the plain version (atol 2e-2, rtol 1e-2:
    ATTN_TOL["bfloat16"] in chip_smoke.py), and m, l within its f32 one
    (1e-4), with bf16 inputs."""
    q, kc, vc = (torch.from_numpy(a).to(torch.bfloat16)
                 for a in _decode_inputs(12, b, hq, hkv, s, d, kv_len)[:3])
    lens = torch.tensor(kv_len, dtype=torch.int32)
    o, m, l = _mma_decode_attention(q, kc, vc, lens)
    want_o, want_m, want_l = decode_attention.decode_attention_plain(q, kc, vc, lens,
                                                                     return_lse=True)
    assert o.dtype == want_o.dtype == torch.bfloat16
    torch.testing.assert_close(o.float(), want_o.float(), atol=2e-2, rtol=1e-2)
    torch.testing.assert_close(m, want_m, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, want_l, atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_attention_and_count_no_launch():
    ops.reset_launch_counts()
    q, k, v = _t(*_qkv(7, 1, 4, 2, 16, 16, 16))
    torch.testing.assert_close(ops.flash_attention(q, k, v, window=8),
                               flash_attention.flash_attention_plain(q, k, v, window=8),
                               rtol=0, atol=0)
    lens = torch.tensor([9], dtype=torch.int32)
    o, m, l = ops.decode_attention(q[:, :, 0], k, v, lens, return_lse=True)
    want = decode_attention.decode_attention_plain(q[:, :, 0], k, v, lens,
                                                   return_lse=True)
    for a, w in zip((o, m, l), want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCH_COUNTERS, 0)
    assert {"flash_attention", "decode_attention"} <= set(ops.LAUNCH_COUNTERS)


def test_attention_kernel_wrappers_refuse_non_cuda_tensors():
    q, k, v = _t(*_qkv(8, 1, 4, 2, 16, 16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention.decode_attention_cuda(q[:, :, 0], k, v,
                                               torch.tensor([3], dtype=torch.int32))
    # meta tensors take the dry run's route (shapes, the kernel's counted
    # work); a wrapper without one still refuses them
    out = ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape
    with pytest.raises(ValueError, match="no implementation"):
        ops.la_update(q.to("meta"), q.to("meta"), q.to("meta"), 0.1, 0.1)
