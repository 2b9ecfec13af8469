"""The port's Whisper encoder-decoder on the CPU against `repro`, from the
same parameters and inputs (made with numpy or by `repro` from a seed and
handed over as numpy arrays): `sinusoid_pos`, the encoder, cross-attention
from memory and from a cache, its one-token decode form, K4's plain
version without a causal mask against `repro`'s Pallas kernel, reduced
whisper-base prefill plus greedy decode with every cache tensor compared,
the ``encdec`` tree's conversion and its refusals, serving and the CLI.

`repro`'s init sets the norms' ``g`` to 1 and every bias to 0, where a
wrong use of them would not show, so every test that converts `repro`'s
parameters first replaces each leaf with seeded draws around it.

Tolerances, all f32: 2e-5 for one layer (the two frameworks differ only in
summation order), 1e-4 for logits and caches after 2 + 2 layers and 8
decode steps (as ``tests/test_torch_models.py``)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import registry as jregistry
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import init_cache as jinit_cache
from repro.models import init_lm as jinit_lm
from repro.models import lm_decode_step as jdecode
from repro.models import lm_prefill as jprefill
from repro.models import whisper as jwhisper
from repro.serve import Engine as JEngine

from repro_torch.configs import registry
from repro_torch.kernels import flash_attention, ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import init_cache, init_lm, lm_decode_step, lm_prefill
from repro_torch.models import whisper as twhisper
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.serve import Engine

LAYER_TOL = dict(atol=2e-5, rtol=2e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "whisper-base"
DROPPED = {"impl", "block_q", "block_k", "seq_chunk"}


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _randomize(tree, seed):
    """Each leaf replaced by seeded draws around it: N(leaf, std(leaf)^2)
    (std 0.1 for a constant leaf)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape) * (float(a.std()) or 0.1)).astype(a.dtype),
        _np_tree(tree))


def _t(a):
    return torch.from_numpy(np.array(a))


def _dense(p):
    return tcommon.Dense(_t(p["w"]), _t(p["b"]) if "b" in p else None)


def _attention(p):
    return tattn.Attention(*(_dense(p[n]) for n in ("wq", "wk", "wv", "wo")))


# --------------------------------------------------------------------------
# configs and primitives
# --------------------------------------------------------------------------
def test_whisper_config_and_reduced_match_repro():
    for ours, theirs in ((registry.get_config(ARCH), jregistry.get_config(ARCH)),
                         (registry.get_config(ARCH).reduced(), jregistry.get_config(ARCH).reduced())):
        want = {k: v for k, v in dataclasses.asdict(theirs).items() if k not in DROPPED}
        assert dataclasses.asdict(ours) == want
    small = registry.get_config(ARCH).reduced()
    assert (small.n_enc_layers, small.n_layers, small.enc_seq, small.n_kv) == (2, 2, 16, 4)


@pytest.mark.parametrize("n,d", [(1500, 512), (16, 64), (7, 10)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sinusoid_pos_is_bit_equal_to_repro(n, d, dtype):
    """Built in numpy f64 and cast once, in both frameworks."""
    want = np.asarray(jcommon.sinusoid_pos(n, d, getattr(jnp, dtype))).astype(np.float32)
    got = tcommon.sinusoid_pos(n, d, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (n, d)
    np.testing.assert_array_equal(got.float().numpy(), want)


@functools.lru_cache(maxsize=None)
def _params():
    """`repro`'s reduced whisper-base parameters from seed 0, every leaf
    randomized (made once a worker; callers copy before changing)."""
    cfg = jregistry.get_config(ARCH).reduced()
    return _randomize(jax.jit(jinit_lm, static_argnums=0)(cfg, jax.random.PRNGKey(0)), 0)


def _tree():
    return jax.tree.map(np.copy, _params())


def _frames(seed, b, cfg):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def test_encode_matches_repro():
    """Sinusoidal positions, 2 bidirectional blocks with biases, the final
    LayerNorm."""
    cfg = registry.get_config(ARCH).reduced()
    jcfg = jregistry.get_config(ARCH).reduced()
    model = lm_params_from_numpy(cfg, _tree(), "cpu")
    frames = _frames(1, 3, cfg)
    want = jwhisper.encode(_params(), jcfg, jnp.asarray(frames))
    got = twhisper.encode(model, cfg, _t(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("from_cache", [False, True])
@pytest.mark.parametrize("sq,sm", [(5, 16), (1, 16), (9, 7)])
def test_apply_cross_attention_matches_repro(from_cache, sq, sm):
    """Queries from x, keys and values from the memory (or a precomputed
    (k, v) pair): no RoPE, no mask, Sq != Sm."""
    cfg = registry.get_config(ARCH).reduced()
    jspec, tspec = jwhisper.enc_spec(jregistry.get_config(ARCH).reduced()), twhisper.enc_spec(cfg)
    p = _tree()["dec_blocks"]["cross"]
    p = jax.tree.map(lambda a: a[1], p)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, sq, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, sm, cfg.d_model)).astype(np.float32)
    if from_cache:
        k = rng.standard_normal((2, cfg.n_kv, sm, cfg.head_dim)).astype(np.float32)
        v = rng.standard_normal((2, cfg.n_kv, sm, cfg.head_dim)).astype(np.float32)
        jarg, targ = (jnp.asarray(k), jnp.asarray(v)), (_t(k), _t(v))
    else:
        jarg, targ = jnp.asarray(mem), _t(mem)
    want = jattn.apply_cross_attention(p, jspec, jnp.asarray(x), jarg, from_cache=from_cache)
    got = tattn.apply_cross_attention(_attention(p), tspec, _t(x), targ, from_cache=from_cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [
    (2, 4, 4, 32, 96, 16),       # cross prefill: Sq < Skv
    (1, 4, 4, 96, 96, 32),       # the encoder: Sq = Skv
    (2, 8, 2, 32, 64, 16),       # group 4
    (1, 2, 2, 64, 32, 16),       # Sq > Skv: every row still sees every key
])
def test_flash_attention_plain_without_mask_matches_pallas(b, hq, hkv, sq, skv, d):
    """K4's plain version with ``causal=False`` against `repro`'s Pallas
    kernel in interpret mode (shapes its 32-row blocks divide)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    got = flash_attention.flash_attention_plain(_t(q), _t(k), _t(v), causal=False)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                                block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("impl", ["xla", "naive"])
def test_cross_decode_matches_repro_attend_at_one_query(impl):
    """`decode_cross_attention` (K5's function, kv_len = Sm for every row)
    against `repro`'s ``apply_cross_attention`` from the cache at Sq = 1,
    which runs ``attend(causal=False)``."""
    cfg = registry.get_config(ARCH).reduced()
    jspec = dataclasses.replace(jwhisper.enc_spec(jregistry.get_config(ARCH).reduced()),
                                impl=impl)
    p = jax.tree.map(lambda a: a[0], _tree()["dec_blocks"]["cross"])
    rng = np.random.default_rng(4)
    x1 = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    k = rng.standard_normal((3, cfg.n_kv, cfg.enc_seq, cfg.head_dim)).astype(np.float32)
    v = rng.standard_normal((3, cfg.n_kv, cfg.enc_seq, cfg.head_dim)).astype(np.float32)
    want = jattn.apply_cross_attention(p, jspec, jnp.asarray(x1), (jnp.asarray(k), jnp.asarray(v)),
                                       from_cache=True)
    got = tattn.decode_cross_attention(_attention(p), twhisper.enc_spec(cfg), _t(x1), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


# --------------------------------------------------------------------------
# the model: prefill, decode, serving
# --------------------------------------------------------------------------
def _cache_leaves(cache):
    return jax.tree.leaves(jax.tree.map(np.asarray, cache,
                                        is_leaf=lambda x: isinstance(x, torch.Tensor)))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_reduced_whisper_prefill_and_decode_match_repro(impl):
    """2 encoder and 2 decoder blocks against `repro` (Pallas attention
    interpreted, or XLA): prefill of a 9-token prompt against 16 frames and
    8 greedy decode steps, the logits every step, both self and cross
    caches and ``pos`` at the end; no kernel launch counted on the CPU."""
    jcfg = dataclasses.replace(jregistry.get_config(ARCH).reduced(), impl=impl)
    tcfg = registry.get_config(ARCH).reduced()
    params = _params()
    model = lm_params_from_numpy(tcfg, _tree(), "cpu")
    b, s, s_max, steps = 2, 9, 24, 8
    prompts = np.random.default_rng(5).integers(0, tcfg.vocab, (b, s)).astype(np.int32)
    frames = _frames(6, b, tcfg)
    prefill = jax.jit(jprefill, static_argnums=1)
    decode = jax.jit(jdecode, static_argnums=1)
    jl, jc = prefill(params, jcfg, jinit_cache(jcfg, b, s_max),
                     {"tokens": jnp.asarray(prompts), "frontend": jnp.asarray(frames)})
    ops.reset_launch_counts()
    tl, tc = lm_prefill(model, tcfg, init_cache(tcfg, b, s_max, "cpu"),
                        {"tokens": torch.from_numpy(prompts), "frontend": _t(frames)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        assert np.array_equal(tl.argmax(-1).numpy(), tok)
        jl, jc = decode(params, jcfg, jc, jnp.asarray(tok))
        tl, tc = lm_decode_step(model, tcfg, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCH_COUNTERS, 0)
    assert set(tc) == set(jc) == {"self", "cross", "pos"}
    want, got = jax.tree.leaves(jax.tree.map(np.asarray, jc)), _cache_leaves(tc)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, **MODEL_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.full(b, s + steps))


def test_whisper_prefill_decode_match_the_teacher_forced_pass():
    """prefill(S-1) + decode(1 token) logits == `whisper_hidden`'s."""
    cfg = registry.get_config(ARCH).reduced()
    model = lm_params_from_numpy(cfg, _tree(), "cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab, (2, 12))
                            .astype(np.int32))
    frames = _t(_frames(8, 2, cfg))
    batch = {"tokens": toks[:, :11], "frontend": frames}
    lg_pre, cache = lm_prefill(model, cfg, init_cache(cfg, 2, 16, "cpu"), batch)
    lg_dec, _ = lm_decode_step(model, cfg, cache, toks[:, 11])
    full = twhisper._logits(cfg, model, twhisper.whisper_hidden(model, cfg, toks, frames))
    np.testing.assert_allclose(lg_pre.numpy(), full[:, 10].numpy(), **MODEL_TOL)
    np.testing.assert_allclose(lg_dec.numpy(), full[:, 11].numpy(), **MODEL_TOL)


def test_whisper_prefill_refuses_frames_the_cross_cache_cannot_hold():
    cfg = registry.get_config(ARCH).reduced()
    model = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    frames = torch.zeros((1, cfg.enc_seq - 1, cfg.d_model))
    with pytest.raises(ValueError, match="cross cache"):
        lm_prefill(model, cfg, init_cache(cfg, 1, 8, "cpu"),
                   {"tokens": torch.ones((1, 4), dtype=torch.int32), "frontend": frames})


def test_greedy_generation_serves_whisper_like_repro():
    """`Engine.generate(..., frontend=)` gives `repro`'s tokens and
    log-probabilities; two generates bit-equal; no launch on the CPU."""
    jcfg = jregistry.get_config(ARCH).reduced()
    tcfg = registry.get_config(ARCH).reduced()
    model = lm_params_from_numpy(tcfg, _tree(), "cpu")
    prompts = np.random.default_rng(9).integers(0, tcfg.vocab, (2, 6)).astype(np.int32)
    frames = _frames(10, 2, tcfg)
    want = JEngine(jcfg, _params(), s_max=14).generate(jnp.asarray(prompts), max_new=8,
                                                       frontend=jnp.asarray(frames))
    eng = Engine(tcfg, model, s_max=14)
    ops.reset_launch_counts()
    a = eng.generate(torch.from_numpy(prompts), max_new=8, frontend=_t(frames))
    b = eng.generate(torch.from_numpy(prompts), max_new=8, frontend=_t(frames))
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCH_COUNTERS, 0)
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.logprobs, b.logprobs)
    np.testing.assert_array_equal(a.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(a.logprobs.numpy(), np.asarray(want.logprobs), **MODEL_TOL)


# --------------------------------------------------------------------------
# conversion
# --------------------------------------------------------------------------
def test_lm_params_from_numpy_carries_the_whisper_tree():
    """Round trip: every leaf of `repro`'s tree lands in one parameter of
    the port, ``enc_blocks`` [Le, ...] at ``enc_blocks.i``, ``dec_blocks``
    [Ld, ...] at ``dec_blocks.i`` (the self-attention at ``self``)."""
    cfg = registry.get_config(ARCH).reduced()
    tree = _tree()
    model = lm_params_from_numpy(cfg, tree, "cpu")
    params = dict(model.named_parameters())
    assert len(params) == sum(a.shape[0] if k in ("enc_blocks", "dec_blocks") else 1
                              for k in tree for a in jax.tree.leaves(tree[k]))
    for i in range(2):
        np.testing.assert_array_equal(params[f"dec_blocks.{i}.self.wk.b"].numpy(),
                                      tree["dec_blocks"]["self"]["wk"]["b"][i])
        np.testing.assert_array_equal(params[f"dec_blocks.{i}.cross.wo.w"].numpy(),
                                      tree["dec_blocks"]["cross"]["wo"]["w"][i])
        np.testing.assert_array_equal(params[f"enc_blocks.{i}.mlp.w_up.b"].numpy(),
                                      tree["enc_blocks"]["mlp"]["w_up"]["b"][i])
    np.testing.assert_array_equal(params["dec_pos"].numpy(), tree["dec_pos"])
    assert params["dec_pos"].shape == (cfg.max_pos, cfg.d_model) == (36864, 64)


@pytest.mark.parametrize("change", ["extra", "missing", "no_dec_pos", "enc_layers",
                                    "dec_layers"])
def test_lm_params_from_numpy_refuses_a_whisper_tree_that_does_not_match(change):
    """A leaf the port would not use, one it lacks, a missing ``dec_pos``,
    or a config whose encoder or decoder depth differs from the tree's."""
    tree = _tree()
    cfg = registry.get_config(ARCH).reduced()
    if change == "extra":
        tree["dec_blocks"]["cross"]["w_extra"] = tree["dec_blocks"]["ln3"]["g"]
    elif change == "missing":
        del tree["enc_blocks"]["mlp"]["w_down"]["b"]
    elif change == "no_dec_pos":
        del tree["dec_pos"]
    elif change == "enc_layers":
        cfg = dataclasses.replace(cfg, n_enc_layers=1)
    elif change == "dec_layers":
        cfg = dataclasses.replace(cfg, n_layers=3)
    with pytest.raises(ValueError, match=f"does not match {cfg.name}"):
        lm_params_from_numpy(cfg, tree, "cpu")


def test_serve_cli_runs_whisper_on_cpu(capsys):
    res = serve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "5", "--max-new", "4"])
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == torch.int32
    assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < 128
    assert "generated 8 tokens" in capsys.readouterr().out
