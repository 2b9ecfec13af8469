"""The port's VLM frontend (internvl2-1b) and Cohere's parallel
attention/MLP block (command-r-plus-104b) on the CPU against `repro`, from
the same parameters and inputs (made with numpy or by `repro` from a seed
and handed over as numpy arrays): the configs, reduced prefill plus greedy
decode with every cache tensor compared, K4's plain version at the GQA
groups these two configs bring (7 and 12) against `repro`'s Pallas kernel,
a VLM served with fewer new tokens than patches against the teacher-forced
pass (where `repro`'s launcher sizing fails), the trees' conversion and
refusals, and the CLI.

Every test that converts `repro`'s parameters first replaces each leaf
with seeded draws around it (its norms' ``g`` of 1 and biases of 0 would
hide a wrong use of them).

Tolerances, all f32: 2e-5 where both take one softmax over the same scores
(``tests/test_torch_attention.py``), 1e-4 for logits and caches after 2
layers and 8 decode steps (``tests/test_torch_models.py``)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import registry as jregistry
from repro.kernels import ops as jops
from repro.models import init_cache as jinit_cache
from repro.models import init_lm as jinit_lm
from repro.models import lm_decode_step as jdecode
from repro.models import lm_prefill as jprefill
from repro.serve import Engine as JEngine

from repro_torch.configs import registry
from repro_torch.kernels import decode_attention, flash_attention, ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as tattn
from repro_torch.models import init_cache, init_lm, lm_decode_step, lm_prefill
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.serve import Engine, cache_rows

TOL = dict(atol=2e-5, rtol=2e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
VLM, COHERE = "internvl2-1b", "command-r-plus-104b"
DROPPED = {"impl", "block_q", "block_k", "seq_chunk"}


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _params(arch):
    """`repro`'s reduced parameters of ``arch`` from seed 0, every leaf
    redrawn as N(leaf, std(leaf)^2) (std 0.1 for a constant leaf); made
    once a worker, callers copy before changing."""
    cfg = jregistry.get_config(arch).reduced()
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape) * (float(a.std()) or 0.1)).astype(a.dtype),
        _np_tree(jax.jit(jinit_lm, static_argnums=0)(cfg, jax.random.PRNGKey(0))))


def _tree(arch):
    return jax.tree.map(np.copy, _params(arch))


def _frontend(seed, b, cfg):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_patches, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", [VLM, COHERE])
def test_config_and_reduced_match_repro(arch):
    for ours, theirs in ((registry.get_config(arch), jregistry.get_config(arch)),
                         (registry.get_config(arch).reduced(), jregistry.get_config(arch).reduced())):
        want = {k: v for k, v in dataclasses.asdict(theirs).items() if k not in DROPPED}
        assert dataclasses.asdict(ours) == want
    vlm, cohere = registry.get_config(VLM), registry.get_config(COHERE)
    assert (vlm.family, vlm.n_patches, vlm.n_heads // vlm.n_kv) == ("vlm", 256, 7)
    assert (cohere.parallel_block, cohere.logit_scale, cohere.n_heads // cohere.n_kv,
            cohere.head_dim, cohere.norm_bias) == (True, 0.0625, 12, 128, False)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", [
    (1, 7, 1, 64, 64, 16, True),      # internvl2-1b's group 7
    (2, 14, 2, 32, 96, 16, True),     # group 7, Sq < Skv
    (1, 12, 1, 64, 64, 32, True),     # command-r-plus's group 12
    (1, 24, 2, 32, 64, 16, False),    # group 12 without a mask
])
def test_flash_attention_plain_at_groups_7_and_12_matches_pallas(b, hq, hkv, sq, skv, d, causal):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    got = flash_attention.flash_attention_plain(_t(q), _t(k), _t(v), causal=causal)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("group", [7, 12])
def test_decode_attention_plain_at_groups_7_and_12_matches_pallas(group):
    rng = np.random.default_rng(2)
    b, hkv, s, d = 3, 2, 96, 16
    q = rng.standard_normal((b, hkv * group, d)).astype(np.float32)
    kc = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    vc = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    lens = np.array([96, 1, 50], np.int32)
    got = decode_attention.decode_attention_plain(_t(q), _t(kc), _t(vc), _t(lens))
    want = jops.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                 jnp.asarray(lens), block_k=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------------
# the models against repro
# --------------------------------------------------------------------------
def _cache_leaves(cache):
    return jax.tree.leaves(jax.tree.map(np.asarray, cache,
                                        is_leaf=lambda x: isinstance(x, torch.Tensor)))


@pytest.mark.parametrize("arch,impl", [(VLM, "pallas"), (VLM, "xla"), (COHERE, "pallas"),
                                       (COHERE, "xla")])
def test_reduced_prefill_and_decode_match_repro(arch, impl):
    """Reduced internvl2-1b (8 patches before an 8- or 9-token prompt, qkv bias,
    GQA) and command-r-plus-104b (the parallel block, LayerNorm without a
    bias, logit scale 1/16) against `repro` (Pallas attention interpreted,
    or XLA): prefill and 8 greedy decode steps, the logits every step, the
    cache's k, v and ``pos`` at the end; no kernel launch counted."""
    jcfg = dataclasses.replace(jregistry.get_config(arch).reduced(), impl=impl)
    tcfg = registry.get_config(arch).reduced()
    model = lm_params_from_numpy(tcfg, _tree(arch), "cpu")
    # 8 patches + 8 tokens: a length `repro`'s Pallas blocks take
    b, s, steps = 2, 8 if impl == "pallas" else 9, 8
    s_max = tcfg.n_patches + s + steps
    prompts = np.random.default_rng(3).integers(0, tcfg.vocab, (b, s)).astype(np.int32)
    jbatch, tbatch = {"tokens": jnp.asarray(prompts)}, {"tokens": _t(prompts)}
    if tcfg.family == "vlm":
        fe = _frontend(4, b, tcfg)
        jbatch["frontend"], tbatch["frontend"] = jnp.asarray(fe), _t(fe)
    prefill = jax.jit(jprefill, static_argnums=1)
    decode = jax.jit(jdecode, static_argnums=1)
    jl, jc = prefill(_params(arch), jcfg, jinit_cache(jcfg, b, s_max), jbatch)
    ops.reset_launch_counts()
    tl, tc = lm_prefill(model, tcfg, init_cache(tcfg, b, s_max, "cpu"), tbatch)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        assert np.array_equal(tl.argmax(-1).numpy(), tok)
        jl, jc = decode(_params(arch), jcfg, jc, jnp.asarray(tok))
        tl, tc = lm_decode_step(model, tcfg, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCH_COUNTERS, 0)
    assert set(tc) == set(jc) == {"main", "pos"}
    want, got = jax.tree.leaves(jax.tree.map(np.asarray, jc)), _cache_leaves(tc)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, **MODEL_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.full(b, tcfg.n_patches + s + steps))


def test_parallel_block_has_no_ln2_and_adds_both_branches():
    """One ``ln1`` feeds attention and the MLP: h + attn(a) + mlp(a)."""
    cfg = registry.get_config(COHERE).reduced()
    model = lm_params_from_numpy(cfg, _tree(COHERE), "cpu")
    blk = model.blocks[0]
    assert blk.ln2 is None and blk.ln1.b is None
    h = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 7, cfg.d_model))
                         .astype(np.float32))
    pos = torch.arange(7)
    a = ttransformer._norm(cfg, blk.ln1, h)
    want = h + tattn.apply_attention(blk.attn, ttransformer.attn_spec(cfg), a, pos) + blk.mlp(a)
    got = ttransformer._apply_block(cfg, blk, h, pos)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", [VLM, COHERE])
def test_prefill_decode_match_the_teacher_forced_pass(arch):
    """prefill(S-1) + decode(1 token) logits == `decoder_hidden`'s, whose
    positions count a VLM's patches."""
    cfg = registry.get_config(arch).reduced()
    model = lm_params_from_numpy(cfg, _tree(arch), "cpu")
    toks = _t(np.random.default_rng(6).integers(0, cfg.vocab, (2, 12)).astype(np.int32))
    fe = _t(_frontend(7, 2, cfg)) if cfg.family == "vlm" else None
    lg_pre, cache = lm_prefill(model, cfg, init_cache(cfg, 2, cfg.n_patches + 16, "cpu"),
                               {"tokens": toks[:, :11], "frontend": fe})
    lg_dec, _ = lm_decode_step(model, cfg, cache, toks[:, 11])
    full = ttransformer._logits(cfg, model, ttransformer.decoder_hidden(model, cfg, toks, fe))
    np.testing.assert_allclose(lg_pre.numpy(), full[:, -2].numpy(), **MODEL_TOL)
    np.testing.assert_allclose(lg_dec.numpy(), full[:, -1].numpy(), **MODEL_TOL)


def test_vlm_serves_fewer_new_tokens_than_patches_like_the_teacher_forced_pass():
    """A reduced internvl2-1b generate of 3 tokens after 8 patches and a
    4-token prompt, its cache sized by `cache_rows` (patches counted): each
    greedy token and log-probability equal the teacher-forced pass over
    prompt + the tokens before it. `repro`'s launcher sizing (prompt +
    max_new = 7 rows, fewer than the 8 patches) is refused."""
    cfg = registry.get_config(VLM).reduced()
    model = lm_params_from_numpy(cfg, _tree(VLM), "cpu")
    p, max_new = 4, 3
    assert max_new < cfg.n_patches
    prompts = _t(np.random.default_rng(8).integers(0, cfg.vocab, (2, p)).astype(np.int32))
    fe = _t(_frontend(9, 2, cfg))
    rows = cache_rows(cfg, p, max_new)
    assert rows == cfg.n_patches + p + max_new - 1
    res = Engine(cfg, model, s_max=rows).generate(prompts, max_new=max_new, frontend=fe)
    seq = torch.cat([prompts, res.tokens[:, :-1]], dim=1)
    full = ttransformer._logits(cfg, model, ttransformer.decoder_hidden(model, cfg, seq, fe))
    want = torch.log_softmax(full[:, cfg.n_patches + p - 1:], dim=-1)
    np.testing.assert_array_equal(res.tokens.numpy(), want.argmax(-1).numpy())
    np.testing.assert_allclose(res.logprobs.numpy(),
                               want.gather(2, res.tokens.long()[..., None])[..., 0].numpy(),
                               **MODEL_TOL)
    with pytest.raises(ValueError, match="cache rows"):
        Engine(cfg, model, s_max=p + max_new).generate(prompts, max_new=max_new, frontend=fe)


def test_greedy_generation_serves_the_vlm_like_repro():
    """`Engine.generate(..., frontend=)` against `repro`'s engine with a
    cache that holds the patches; two generates bit-equal."""
    jcfg = jregistry.get_config(VLM).reduced()
    tcfg = registry.get_config(VLM).reduced()
    model = lm_params_from_numpy(tcfg, _tree(VLM), "cpu")
    prompts = np.random.default_rng(10).integers(0, tcfg.vocab, (2, 6)).astype(np.int32)
    fe = _frontend(11, 2, tcfg)
    s_max = cache_rows(tcfg, 6, 8)
    want = JEngine(jcfg, _params(VLM), s_max=s_max).generate(jnp.asarray(prompts), max_new=8,
                                                            frontend=jnp.asarray(fe))
    eng = Engine(tcfg, model, s_max=s_max)
    a = eng.generate(_t(prompts), max_new=8, frontend=_t(fe))
    b = eng.generate(_t(prompts), max_new=8, frontend=_t(fe))
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.logprobs, b.logprobs)
    np.testing.assert_array_equal(a.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(a.logprobs.numpy(), np.asarray(want.logprobs), **MODEL_TOL)


def test_vlm_prefill_refuses_a_missing_frontend():
    cfg = registry.get_config(VLM).reduced()
    model = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="patch embeddings"):
        lm_prefill(model, cfg, init_cache(cfg, 1, 16, "cpu"),
                   {"tokens": torch.ones((1, 4), dtype=torch.int32)})


# --------------------------------------------------------------------------
# conversion and the CLI
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [VLM, COHERE])
def test_lm_params_from_numpy_carries_the_tree(arch):
    cfg = registry.get_config(arch).reduced()
    tree = _tree(arch)
    params = dict(lm_params_from_numpy(cfg, tree, "cpu").named_parameters())
    assert len(params) == sum(a.shape[0] if k == "blocks" else 1
                              for k in tree for a in jax.tree.leaves(tree[k]))
    np.testing.assert_array_equal(params["blocks.1.attn.wq.w"].numpy(),
                                  tree["blocks"]["attn"]["wq"]["w"][1])
    assert ("blocks.0.ln2.g" in params) == (not cfg.parallel_block)
    assert ("blocks.0.attn.wk.b" in params) == cfg.qkv_bias


@pytest.mark.parametrize("change", ["ln2_in_parallel", "no_ln2", "extra", "missing"])
def test_lm_params_from_numpy_refuses_a_tree_that_does_not_match(change):
    """A parallel block's tree with an ``ln2`` (a leaf too many), a
    sequential block's without one, a leaf the port would not use or one
    it lacks."""
    cfg = registry.get_config(COHERE).reduced()
    tree = _tree(COHERE)
    if change == "ln2_in_parallel":
        tree["blocks"]["ln2"] = tree["blocks"]["ln1"]
    elif change == "no_ln2":
        cfg = dataclasses.replace(cfg, parallel_block=False)
    elif change == "extra":
        tree["blocks"]["mlp"]["w_extra"] = tree["blocks"]["mlp"]["w_up"]
    elif change == "missing":
        del tree["blocks"]["attn"]["wo"]
    with pytest.raises(ValueError, match=f"does not match {cfg.name}"):
        lm_params_from_numpy(cfg, tree, "cpu")


@pytest.mark.parametrize("arch", [VLM, COHERE])
def test_serve_cli_runs_on_cpu(arch, capsys):
    res = serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "5", "--max-new", "4"])
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == torch.int32
    assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < 128
    assert "generated 8 tokens" in capsys.readouterr().out
