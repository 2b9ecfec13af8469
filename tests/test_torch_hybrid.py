"""The port's Mamba2 hybrid on the CPU against `repro`, from the same
parameters and inputs (made with numpy or by `repro` from a seed and handed
over as numpy arrays): the Mamba2 mixer's chunked SSD form, its scan and
its one-token decode, reduced zamba2-7b prefill plus greedy decode with
every cache tensor compared, the ``hybrid`` tree's conversion (its
doubly stacked ``mamba`` axis and its refusals), serving and the CLI.

`repro`'s init sets many leaves to constants (LoRA ``b`` 0, ``A_log`` and
``dt_bias`` 0, ``D`` and the norms' ``g`` 1, the conv biases 0), where a
wrong use of them would not show, so every test first replaces each leaf
with seeded draws around it (``A_log`` and ``dt_bias`` in [-1, 0.5], where
the decays stay finite) and only then converts.

Tolerances, all f32: 1e-5 for one mixer (the two frameworks differ in
summation order), 1e-4 between the chunked form and the scan (the chunked
form sums its decays as differences of a cumulative sum), 1e-4 for logits
and caches after 7 layers and 8 decode steps (as
``tests/test_torch_models.py``)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import registry as jregistry
from repro.models import init_cache as jinit_cache
from repro.models import init_lm as jinit_lm
from repro.models import lm_decode_step as jdecode
from repro.models import lm_prefill as jprefill
from repro.models import ssm as jssm

from repro_torch.configs import registry
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import init_cache, init_lm, lm_decode_step, lm_prefill
from repro_torch.models import ssm as tssm
from repro_torch.models import zamba as tzamba
from repro_torch.models.common import Dense, Norm
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.serve import Engine

MIXER_TOL = dict(atol=1e-5, rtol=1e-5)
FORM_TOL = dict(atol=1e-4, rtol=1e-4)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "zamba2-7b"
DROPPED = {"impl", "block_q", "block_k", "seq_chunk"}


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _randomize(tree, seed):
    """Each leaf replaced by seeded draws around it: N(leaf, std(leaf)^2)
    (std 0.1 for a constant leaf), ``A_log`` and ``dt_bias`` uniform in
    [-1, 0.5]."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        a = np.asarray(a)
        name = jax.tree_util.keystr(path)
        if "A_log" in name or "dt_bias" in name:
            return rng.uniform(-1.0, 0.5, a.shape).astype(a.dtype)
        return (a + rng.standard_normal(a.shape) * (float(a.std()) or 0.1)).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(draw, _np_tree(tree))


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# the Mamba2 mixer
# --------------------------------------------------------------------------
SPECS = {
    "g1": dict(d_model=32, d_state=16, d_head=16, chunk=8),
    "g2": dict(d_model=32, d_state=8, d_head=8, chunk=8, n_groups=2),
}


def _mixer(name, seed):
    """(repro's spec, the port's spec, repro's randomized params, the
    port's Mamba2 from them)."""
    kw = SPECS[name]
    jspec = jssm.Mamba2Spec(**kw)
    params = _randomize(jssm.init_mamba2(jax.random.PRNGKey(seed), jspec, jnp.float32), seed)
    tp = tssm.Mamba2(**{k: (Dense(_t(v["w"])) if "w" in v else Norm(_t(v["g"])))
                        if isinstance(v, dict) else _t(v) for k, v in params.items()})
    return jspec, tssm.Mamba2Spec(**kw), params, tp


def _ssd_inputs(seed, b, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((b, s, h, p)).astype(np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    dt = rng.uniform(0.01, 1.0, (b, s, h)).astype(np.float32)
    a = -rng.uniform(0.3, 2.0, h).astype(np.float32)
    d_skip = rng.standard_normal(h).astype(np.float32)
    return xs, bm, cm, dt, a, d_skip


@pytest.mark.parametrize("s,chunk,g,h", [(16, 8, 1, 4), (24, 8, 2, 4), (8, 8, 1, 2)])
def test_ssd_chunked_and_scan_match_repro(s, chunk, g, h):
    """`_ssd_chunked` and `_ssd_scan` (y and the final state) against
    `repro`'s, and the port's chunked form against its own scan."""
    args = _ssd_inputs(1, 2, s, h, 8, g, 8)
    jargs = [jnp.asarray(a) for a in args]
    targs = [_t(a) for a in args]
    jy, jst = jssm._ssd_chunked(*jargs, chunk, g, h)
    ty, tst = tssm._ssd_chunked(*targs, chunk, g, h)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MIXER_TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **MIXER_TOL)
    jy2, jst2 = jssm._ssd_scan(*jargs, g, h)
    sy, sst = tssm._ssd_scan(*targs, g, h)
    np.testing.assert_allclose(sy.numpy(), np.asarray(jy2), **MIXER_TOL)
    np.testing.assert_allclose(sst.numpy(), np.asarray(jst2), **MIXER_TOL)
    np.testing.assert_allclose(ty.numpy(), sy.numpy(), **FORM_TOL)
    np.testing.assert_allclose(tst.numpy(), sst.numpy(), **FORM_TOL)


def test_ssd_chunked_masks_overflowing_decays_with_a_select():
    """Strong decays (dt A ~ -100 a step) put exp(cum_t - cum_s) past the
    f32 range above the diagonal: masked by a select, the output stays
    finite and equals the scan's (a multiply by 0 would give NaN)."""
    xs, bm, cm, dt, a, d_skip = _ssd_inputs(2, 1, 16, 2, 8, 1, 8)
    dt = np.full_like(dt, 10.0)
    a = np.full_like(a, -10.0)
    seg_max = float(-np.cumsum(dt[0, :8, 0] * a[0])[-1])
    assert seg_max > np.log(np.finfo(np.float32).max)
    targs = [_t(v) for v in (xs, bm, cm, dt, a, d_skip)]
    y, st = tssm._ssd_chunked(*targs, 8, 1, 2)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    sy, sst = tssm._ssd_scan(*targs, 1, 2)
    np.testing.assert_allclose(y.numpy(), sy.numpy(), **FORM_TOL)
    np.testing.assert_allclose(st.numpy(), sst.numpy(), **FORM_TOL)


@pytest.mark.parametrize("name,s", [("g1", 16), ("g1", 13), ("g2", 24)])
def test_apply_mamba2_with_state_matches_repro(name, s):
    """y, the SSM state and both conv tails; S 13 is no whole number of
    chunks, so both take the scan."""
    jspec, tspec, params, tp = _mixer(name, 3)
    x = np.random.default_rng(3).standard_normal((2, s, jspec.d_model)).astype(np.float32)
    jy, (jst, (jcx, jcbc)) = jssm.apply_mamba2_with_state(params, jspec, jnp.asarray(x))
    ty, (tst, (tcx, tcbc)) = tssm.apply_mamba2_with_state(tp, tspec, _t(x))
    for got, want in ((ty, jy), (tst, jst), (tcx, jcx), (tcbc, jcbc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MIXER_TOL)


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_decode_mamba2_matches_repro_over_8_steps(name):
    """8 one-token steps from the state a 16-token prefill left, against
    `repro`'s decode; the port's prefill(16) + 8 decode steps also equal its
    prefill(24) (chunked against scan)."""
    jspec, tspec, params, tp = _mixer(name, 4)
    x = np.random.default_rng(4).standard_normal((2, 24, jspec.d_model)).astype(np.float32)
    _, jstate = jssm.apply_mamba2_with_state(params, jspec, jnp.asarray(x[:, :16]))
    _, tstate = tssm.apply_mamba2_with_state(tp, tspec, _t(x[:, :16]))
    jst, jconv = jstate
    tst, tconv = tstate
    ys = []
    for i in range(16, 24):
        jy, jst, jconv = jssm.decode_mamba2(params, jspec, jnp.asarray(x[:, i:i + 1]), jst, jconv)
        ty, tst, tconv = tssm.decode_mamba2(tp, tspec, _t(x[:, i:i + 1]), tst, tconv)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MIXER_TOL)
        ys.append(ty)
    for got, want in ((tst, jst), (tconv[0], jconv[0]), (tconv[1], jconv[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MIXER_TOL)
    whole, (w_st, _) = tssm.apply_mamba2_with_state(tp, tspec, _t(x))
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), whole[:, 16:].numpy(), **FORM_TOL)
    np.testing.assert_allclose(tst.numpy(), w_st.numpy(), **FORM_TOL)


# --------------------------------------------------------------------------
# the model: config, conversion, prefill, decode, serving
# --------------------------------------------------------------------------
def test_zamba_config_and_reduced_match_repro():
    for ours, theirs in ((registry.get_config(ARCH), jregistry.get_config(ARCH)),
                         (registry.get_config(ARCH).reduced(), jregistry.get_config(ARCH).reduced())):
        want = {k: v for k, v in dataclasses.asdict(theirs).items() if k not in DROPPED}
        assert dataclasses.asdict(ours) == want
    small = registry.get_config(ARCH).reduced()
    assert (small.n_attn_groups, small.mamba_per_group, small.trailing_mamba) == (2, 2, 1)
    assert tzamba.shared_attn_spec(small).d_head == 32
    assert tzamba.shared_attn_spec(registry.get_config(ARCH)).d_head == 224


@functools.lru_cache(maxsize=None)
def _params():
    """`repro`'s reduced zamba2-7b parameters from seed 0, every leaf
    randomized (made once a worker; callers copy before changing)."""
    cfg = jregistry.get_config(ARCH).reduced()
    return _randomize(jax.jit(jinit_lm, static_argnums=0)(cfg, jax.random.PRNGKey(0)), 0)


def _tree():
    return jax.tree.map(np.copy, _params())


def _cache_leaves(cache):
    return jax.tree.leaves(jax.tree.map(np.asarray, cache,
                                        is_leaf=lambda x: isinstance(x, torch.Tensor)))


@pytest.mark.parametrize("impl,s", [("pallas", 32), ("xla", 37)])
def test_reduced_zamba_prefill_and_decode_match_repro(impl, s):
    """2 groups of (shared attention at head width 32, 2 Mamba2 layers) and
    1 trailing layer against `repro` (Pallas attention interpreted, or XLA
    at a prompt of 37, whose Mamba2 layers take the scan): prefill and 8
    greedy decode steps, the logits every step, every tensor of ``kv``,
    ``ssm`` and ``trail_ssm``, ``h0`` and ``pos`` at the end."""
    jcfg = dataclasses.replace(jregistry.get_config(ARCH).reduced(), impl=impl)
    tcfg = registry.get_config(ARCH).reduced()
    params = _params()
    model = lm_params_from_numpy(tcfg, _tree(), "cpu")
    b, s_max, steps = 2, 48, 8
    prompts = np.random.default_rng(5).integers(0, tcfg.vocab, (b, s)).astype(np.int32)
    prefill = jax.jit(jprefill, static_argnums=1)
    decode = jax.jit(jdecode, static_argnums=1)
    jl, jc = prefill(params, jcfg, jinit_cache(jcfg, b, s_max), {"tokens": jnp.asarray(prompts)})
    ops.reset_launch_counts()
    tl, tc = lm_prefill(model, tcfg, init_cache(tcfg, b, s_max, "cpu"),
                        {"tokens": torch.from_numpy(prompts)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        assert np.array_equal(tl.argmax(-1).numpy(), tok)
        jl, jc = decode(params, jcfg, jc, jnp.asarray(tok))
        tl, tc = lm_decode_step(model, tcfg, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCH_COUNTERS, 0)
    assert set(tc) == set(jc) == {"kv", "ssm", "trail_ssm", "h0", "pos"}
    assert jax.tree.structure(jax.tree.map(lambda _: 0, jc)) == jax.tree.structure(
        jax.tree.map(lambda _: 0, tc, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    want, got = jax.tree.leaves(jax.tree.map(np.asarray, jc)), _cache_leaves(tc)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, **MODEL_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.full(b, s + steps))


def test_zamba_prefill_decode_match_the_teacher_forced_pass():
    """prefill(S-1) + decode(1 token) logits == the full hidden pass's, on
    the converted model (prefill 23 runs the scan, 24 the chunked form)."""
    cfg = registry.get_config(ARCH).reduced()
    model = lm_params_from_numpy(cfg, _tree(), "cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab, (2, 24))
                            .astype(np.int32))
    lg_pre, cache = lm_prefill(model, cfg, init_cache(cfg, 2, 32, "cpu"), {"tokens": toks[:, :23]})
    lg_dec, _ = lm_decode_step(model, cfg, cache, toks[:, 23])
    full = tzamba._logits(model, tzamba.zamba_hidden(model, cfg, toks))
    np.testing.assert_allclose(lg_pre.numpy(), full[:, 22].numpy(), **FORM_TOL)
    np.testing.assert_allclose(lg_dec.numpy(), full[:, 23].numpy(), **FORM_TOL)


def test_lm_params_from_numpy_carries_the_doubly_stacked_mamba_axis():
    """Round trip: every leaf of `repro`'s tree lands in one parameter of
    the port, ``mamba`` [G, M, ...] at ``mamba.g.m``, ``lora`` [G, ...] at
    ``lora.g`` and ``trailing`` [T, ...] at ``trailing.t``."""
    cfg = registry.get_config(ARCH).reduced()
    tree = _tree()
    model = lm_params_from_numpy(cfg, tree, "cpu")
    params = dict(model.named_parameters())
    assert len(params) == sum(int(np.prod(a.shape[:2])) if k == "mamba" else
                              (a.shape[0] if k in ("lora", "trailing") else 1)
                              for k in tree for a in jax.tree.leaves(tree[k]))
    for gi in range(2):
        for mi in range(2):
            np.testing.assert_array_equal(params[f"mamba.{gi}.{mi}.mix.in_z.w"].numpy(),
                                          tree["mamba"]["mix"]["in_z"]["w"][gi, mi])
            np.testing.assert_array_equal(params[f"mamba.{gi}.{mi}.mix.A_log"].numpy(),
                                          tree["mamba"]["mix"]["A_log"][gi, mi])
        np.testing.assert_array_equal(params[f"lora.{gi}.k.b"].numpy(), tree["lora"]["k"]["b"][gi])
    np.testing.assert_array_equal(params["trailing.0.mix.conv_w_bc"].numpy(),
                                  tree["trailing"]["mix"]["conv_w_bc"][0])
    np.testing.assert_array_equal(params["shared.mlp.w_down.w"].numpy(),
                                  tree["shared"]["mlp"]["w_down"]["w"])


@pytest.mark.parametrize("change", ["extra", "missing", "no_lora", "groups", "per_group",
                                    "trailing"])
def test_lm_params_from_numpy_refuses_a_hybrid_tree_that_does_not_match(change):
    """A leaf the port would not use, one it lacks, a missing LoRA set, or a
    config whose group count, Mamba layers a group or trailing layers
    differ from the tree's stacked axes are refused."""
    tree = _tree()
    cfg = registry.get_config(ARCH).reduced()
    if change == "extra":
        tree["mamba"]["mix"]["w_extra"] = tree["mamba"]["mix"]["D"]
    elif change == "missing":
        del tree["shared"]["attn"]["wo"]
    elif change == "no_lora":
        del tree["lora"]
    elif change == "groups":
        cfg = dataclasses.replace(cfg, n_attn_groups=1, n_layers=4)
    elif change == "per_group":
        cfg = dataclasses.replace(cfg, mamba_per_group=1, n_layers=5)
    elif change == "trailing":
        cfg = dataclasses.replace(cfg, trailing_mamba=0, n_layers=6)
    with pytest.raises(ValueError, match=f"does not match {cfg.name}"):
        lm_params_from_numpy(cfg, tree, "cpu")


def test_greedy_generation_serves_zamba_on_the_cpu():
    """`Engine.generate` on the hybrid's cache: two generates bit-equal,
    finite, no kernel launch counted on the CPU."""
    cfg = registry.get_config(ARCH).reduced()
    model = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = torch.from_numpy(np.random.default_rng(7).integers(0, 128, (2, 12)).astype(np.int32))
    eng = Engine(cfg, model, s_max=20)
    ops.reset_launch_counts()
    a, b = eng.generate(prompts, max_new=8), eng.generate(prompts, max_new=8)
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCH_COUNTERS, 0)
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.logprobs, b.logprobs)
    assert a.tokens.shape == (2, 8) and bool(torch.isfinite(a.logprobs).all())


def test_serve_cli_runs_zamba_on_cpu(capsys):
    res = serve_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "13", "--max-new", "4"])
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == torch.int32
    assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < 128
    assert "generated 8 tokens" in capsys.readouterr().out
