"""The port's sliding-window path and the two new head widths on the CPU
against `repro`, from the same inputs (made with numpy or by `repro` from
a seed and handed over as numpy arrays): K4's and K5's plain versions at
head widths 120 (h2o-danube-3-4b) and 224 (zamba2-7b's shared attention)
against `repro`'s Pallas kernels in interpret mode, the ring-buffer decode
through K5's function (kv_len = min(pos + 1, W)) against `repro`'s
``_ring_decode_xla`` before and after the ring wraps, reduced
h2o-danube-3-4b prefill plus greedy decode with every cache tensor
compared (the ring wrapping in prefill, and a cache no wider than the
window), and the CLI.

Every leaf of `repro`'s tree is replaced by seeded draws around it before
it is converted, so the norms' constant scales carry signal.

Tolerances, all f32: 2e-5 for the attention kernels' plain versions and
one decode layer (the two frameworks differ in summation order, the bound
``tests/test_torch_attention.py`` uses), 1e-4 for logits and caches after
2 layers and 8 decode steps (as ``tests/test_torch_models.py``)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import registry as jregistry
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.models import attention as jattn
from repro.models import init_cache as jinit_cache
from repro.models import init_lm as jinit_lm
from repro.models import lm_decode_step as jdecode
from repro.models import lm_prefill as jprefill

from repro_torch.configs import registry
from repro_torch.kernels import decode_attention, flash_attention, ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as tattn
from repro_torch.models import init_cache, lm_decode_step, lm_prefill
from repro_torch.models.common import Dense
from repro_torch.models.convert import lm_params_from_numpy

TOL = dict(atol=2e-5, rtol=2e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "h2o-danube-3-4b"
DROPPED = {"impl", "block_q", "block_k", "seq_chunk"}


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _dense(p):
    return Dense(*_t(p["w"]), *(_t(p["b"]) if "b" in p else ()))


# --------------------------------------------------------------------------
# K4 and K5 at head widths 120 and 224
# --------------------------------------------------------------------------
@pytest.mark.parametrize("d", [120, 224])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,causal,window", [
    (1, 4, 4, 64, 64, True, None),      # causal, group 1
    (1, 8, 2, 64, 64, True, None),      # causal, group 4
    (1, 8, 2, 64, 64, True, 24),        # windowed, group 4
    (1, 4, 4, 32, 96, True, 40),        # Sq < Skv under a window, group 1
    (2, 4, 1, 32, 64, True, None),      # Sq < Skv, group 4
])
def test_flash_attention_plain_at_wide_heads_matches_pallas(b, hq, hkv, sq, skv, causal,
                                                            window, d):
    rng = np.random.default_rng(d + sq)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, skv, d)).astype(np.float32) for _ in range(2))
    got = flash_attention.flash_attention_plain(*_t(q, k, v), causal=causal, window=window)
    pallas = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, window=window, block_q=16, block_k=16,
                                  interpret=True)
    want = ref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                             window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert d in flash_attention.HEAD_DIMS


@pytest.mark.parametrize("d", [120, 224])
@pytest.mark.parametrize("b,hq,hkv,s,kv_len", [
    (4, 8, 2, 64, [0, 1, 64, 37]),      # group 4: empty, one, full, mixed
    (3, 4, 4, 64, [64, 0, 17]),         # group 1
])
def test_decode_attention_plain_at_wide_heads_matches_pallas(b, hq, hkv, s, kv_len, d):
    rng = np.random.default_rng(d + s)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, hkv, s, d)).astype(np.float32) for _ in range(2))
    lens = np.asarray(kv_len, np.int32)
    o, m, l = decode_attention.decode_attention_plain(*_t(q, kc, vc, lens), return_lse=True)
    jo, jm, jl = jops.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                       jnp.asarray(lens), block_k=16, interpret=True,
                                       return_lse=True)
    for got, want in ((o, jo), (m, jm), (l, jl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    empty = lens == 0
    assert np.all(o.numpy()[empty] == 0) and np.all(l.numpy()[empty] == 0)
    assert d in decode_attention.HEAD_DIMS


# --------------------------------------------------------------------------
# the ring-buffer decode through K5's function
# --------------------------------------------------------------------------
@pytest.mark.parametrize("pos", [[0, 5, 15, 2], [16, 17, 40, 15]], ids=["before-wrap", "after-wrap"])
def test_ring_decode_is_decode_attention_at_the_ring_length(pos):
    """K5's function with kv_len = min(pos + 1, W) equals `repro`'s
    ``_ring_decode_xla`` on the same ring, before the ring wraps and after."""
    w, d, hq, hkv = 16, 16, 8, 2
    rng = np.random.default_rng(8)
    q = rng.standard_normal((4, hq, 1, d)).astype(np.float32)
    ck, cv = (rng.standard_normal((4, hkv, w, d)).astype(np.float32) for _ in range(2))
    pos = np.asarray(pos, np.int32)
    spec = jattn.AttnSpec(d_model=64, n_q=hq, n_kv=hkv, d_head=d, window=w)
    want = jattn._ring_decode_xla(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                  jnp.asarray(pos), spec)
    got = decode_attention.decode_attention_plain(
        *_t(q[:, :, 0], ck, cv, np.minimum(pos + 1, w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :, 0], **TOL)


@pytest.mark.parametrize("pos", [[0, 7, 3], [8, 21, 35]], ids=["before-wrap", "after-wrap"])
def test_decode_self_attention_takes_decode_attention_on_a_ring(monkeypatch, pos):
    """A sliding-window layer's decode against its ring (W = 8) calls
    ``ops.decode_attention`` with kv_len = min(pos + 1, W), and its output
    and caches equal `repro`'s ring decode."""
    kw = dict(d_model=64, n_q=8, n_kv=2, d_head=16, window=8)
    jspec, tspec = jattn.AttnSpec(**kw), tattn.AttnSpec(**kw)
    params = jax.tree.map(np.asarray, jattn.init_attention(jax.random.PRNGKey(9), jspec,
                                                           jnp.float32))
    tp = tattn.Attention(*(_dense(params[n]) for n in ("wq", "wk", "wv", "wo")))
    rng = np.random.default_rng(9)
    x1 = rng.standard_normal((3, 1, 64)).astype(np.float32)
    ck, cv = (rng.standard_normal((3, 2, 8, 16)).astype(np.float32) for _ in range(2))
    pos = np.asarray(pos, np.int32)
    seen = []
    real = ops.decode_attention

    def spy(q, k_cache, v_cache, kv_len, **kw_):
        seen.append(kv_len.clone())
        return real(q, k_cache, v_cache, kv_len, **kw_)

    monkeypatch.setattr(ops, "decode_attention", spy)
    tk, tv = _t(ck, cv)
    ty, _, _ = tattn.decode_self_attention(tp, tspec, *_t(x1), tk, tv, *_t(pos))
    assert len(seen) == 1 and seen[0].tolist() == np.minimum(pos + 1, 8).tolist()
    jy, jk, jv = jattn.decode_self_attention(params, jspec, jnp.asarray(x1), jnp.asarray(ck),
                                             jnp.asarray(cv), jnp.asarray(pos))
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------------
# the model: config, prefill, decode, serving
# --------------------------------------------------------------------------
def test_h2o_config_and_reduced_match_repro():
    for ours, theirs in ((registry.get_config(ARCH), jregistry.get_config(ARCH)),
                         (registry.get_config(ARCH).reduced(), jregistry.get_config(ARCH).reduced())):
        want = {k: v for k, v in dataclasses.asdict(theirs).items() if k not in DROPPED}
        assert dataclasses.asdict(ours) == want
    assert registry.get_config(ARCH).head_dim == 120
    small = registry.get_config(ARCH).reduced()
    assert (small.window, small.head_dim) == (16, 16)


@functools.lru_cache(maxsize=None)
def _params():
    """`repro`'s reduced h2o-danube-3-4b parameters from seed 0, every leaf
    replaced by N(leaf, std(leaf)^2) draws (std 0.1 for a constant leaf)."""
    cfg = jregistry.get_config(ARCH).reduced()
    tree = jax.tree.map(np.asarray, jax.jit(jinit_lm, static_argnums=0)(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda a: (a + rng.standard_normal(a.shape) * (float(a.std()) or 0.1))
                        .astype(a.dtype), tree)


@pytest.mark.parametrize("impl,s,s_max", [("pallas", 32, 48), ("xla", 37, 48), ("xla", 4, 12)],
                         ids=["pallas-ring", "xla-ring", "xla-no-ring"])
def test_reduced_h2o_prefill_and_decode_match_repro(impl, s, s_max):
    """Reduced h2o-danube-3-4b (window 16, head width 16) against `repro`:
    prompts of 32 and 37 are longer than the window, so the ring wraps in
    prefill; a cache of 12 <= the window is a plain cache. Prefill and 8
    greedy decode steps, the logits every step, both caches and ``pos`` at
    the end."""
    jcfg = dataclasses.replace(jregistry.get_config(ARCH).reduced(), impl=impl)
    tcfg = registry.get_config(ARCH).reduced()
    params = _params()
    model = lm_params_from_numpy(tcfg, jax.tree.map(np.copy, params), "cpu")
    b, steps = 2, 8
    prompts = np.random.default_rng(10).integers(0, tcfg.vocab, (b, s)).astype(np.int32)
    jl, jc = jax.jit(jprefill, static_argnums=1)(params, jcfg, jinit_cache(jcfg, b, s_max),
                                                 {"tokens": jnp.asarray(prompts)})
    tc = init_cache(tcfg, b, s_max, "cpu")
    assert tc["main"][0].shape[3] == min(s_max, tcfg.window)
    tl, tc = lm_prefill(model, tcfg, tc, {"tokens": torch.from_numpy(prompts)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    decode = jax.jit(jdecode, static_argnums=1)
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        assert np.array_equal(tl.argmax(-1).numpy(), tok)
        jl, jc = decode(params, jcfg, jc, jnp.asarray(tok))
        tl, tc = lm_decode_step(model, tcfg, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    assert set(tc) == set(jc) == {"main", "pos"}
    for i in range(2):
        assert tc["main"][i].shape == jc["main"][i].shape
        np.testing.assert_allclose(tc["main"][i].numpy(), np.asarray(jc["main"][i]), **MODEL_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.full(b, s + steps))


def test_serve_cli_runs_h2o_on_cpu(capsys):
    """Prompts of 24 past the reduced window of 16: the ring wraps."""
    res = serve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "24", "--max-new", "4"])
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == torch.int32
    assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < 128
    assert "generated 8 tokens" in capsys.readouterr().out
