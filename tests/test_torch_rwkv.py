"""The port's RWKV6 serving path on the CPU against `repro`, from the same
parameters and inputs (made with numpy, or by `repro` from a seed, and
handed over as numpy arrays): the plain version of K6 against `repro`'s
Pallas kernel in interpret mode, its numpy oracle and its model scan; the
time and channel mixes; reduced rwkv6-3b prefill, decode and greedy
generation through `lm_params_from_numpy`; the config, the serving CLI and
the entry points' device rules. K6 itself runs only on the card, where
``chip_smoke.py`` holds it against its plain version.

Tolerances, all f32: 2e-4 against the Pallas kernel and the f64 oracle
(the bound `tests/test_kernels.py` holds `repro`'s own kernel to; the
state sums up to 128 decayed outer products); 2e-5 against the model scan
and for one layer (the two frameworks differ only in summation order);
1e-4 for logits and caches after two blocks and 8 decode steps."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import registry as jregistry
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.models import init_cache as jinit_cache
from repro.models import init_lm as jinit_lm
from repro.models import lm_decode_step as jdecode
from repro.models import lm_prefill as jprefill
from repro.models import rwkv6 as jrwkv6
from repro.serve import Engine as JEngine

from repro_torch.configs import registry
from repro_torch.kernels import _build, ops, wkv6
from repro_torch.launch import serve as serve_cli
from repro_torch.models import init_cache, init_lm, lm_decode_step, lm_prefill
from repro_torch.models import common as tcommon
from repro_torch.models import rwkv6 as trwkv6
from repro_torch.models import rwkv_model
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.serve import Engine

KERNEL_TOL = dict(atol=2e-4, rtol=2e-4)
LAYER_TOL = dict(atol=2e-5, rtol=2e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
DROPPED = {"impl", "block_q", "block_k", "seq_chunk"}
CACHE_FIELDS = ("x_time", "wkv", "x_chan", "pos")


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _wkv_inputs(seed, b, s, h, n):
    """r, k, v, logw [B,S,H,N], u [H,N], state0 [B,H,N,N], f32: decays
    from strong (w = e^-e^2) to weak, a nonzero starting state."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32) for _ in range(3))
    logw = -np.exp(rng.uniform(-6.0, 2.0, (b, s, h, n))).astype(np.float32)
    u = (rng.standard_normal((h, n)) * 0.3).astype(np.float32)
    s0 = (rng.standard_normal((b, h, n, n)) * 0.1).astype(np.float32)
    return r, k, v, logw, u, s0


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


# --------------------------------------------------------------------------
# K6's plain version
# --------------------------------------------------------------------------
@pytest.mark.parametrize("b,s,h,n,block_s", [
    (2, 64, 2, 16, 32),
    (1, 128, 4, 32, 64),
    (3, 32, 1, 8, 32),
    (2, 1, 3, 16, 1),            # one decode token
])
def test_wkv6_plain_matches_pallas_and_ref(b, s, h, n, block_s):
    args = _wkv_inputs(0, b, s, h, n)
    y, st = wkv6.wkv6_plain(*_t(*args))
    py, pst = jops.wkv6(*map(jnp.asarray, args), block_s=block_s, interpret=True)
    ry, rst = ref.wkv6_ref(*args)
    for got, want in ((y, py), (st, pst), (y, ry), (st, rst)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


@pytest.mark.parametrize("s", [48, 7])
def test_wkv6_plain_matches_model_scan(s):
    args = _wkv_inputs(1, 2, s, 2, 16)
    y, st = wkv6.wkv6_plain(*_t(*args))
    wy, wst = jrwkv6._wkv_scan(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **LAYER_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(wst), **LAYER_TOL)


def test_wkv6_in_place_writes_the_state_over_state0():
    args = _wkv_inputs(2, 2, 9, 2, 8)
    tensors = _t(*args)
    y, st = ops.wkv6(*tensors)
    ry, rst = ref.wkv6_ref(*args)
    assert st is tensors[5]
    assert not np.allclose(args[5], np.asarray(rst), **KERNEL_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **KERNEL_TOL)
    np.testing.assert_allclose(tensors[5].numpy(), np.asarray(rst), **KERNEL_TOL)


def test_wkv6_on_the_cpu_builds_nothing_and_counts_no_launch(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("build or load attempted")

    monkeypatch.setattr(_build, "build", boom)
    monkeypatch.setattr(_build, "load", boom)
    ops.reset_launch_counts()
    ops.wkv6(*_t(*_wkv_inputs(3, 1, 5, 2, 16)))
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCH_COUNTERS, 0)
    assert "wkv6" in ops.LAUNCH_COUNTERS


def test_wkv6_cuda_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="N in"):
        wkv6.wkv6_cuda(*_t(*_wkv_inputs(4, 1, 3, 2, 12)))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        wkv6.wkv6_cuda(*_t(*_wkv_inputs(4, 1, 3, 2, 16)))


# --------------------------------------------------------------------------
# time and channel mix
# --------------------------------------------------------------------------
SPEC = dict(d_model=64, n_heads=4, d_ffn=128)


def _tt(a):
    return torch.from_numpy(np.array(a))


def _params(cls, tree):
    """A port module from `repro`'s dict of one mix (no layer axis)."""
    def leaf(d):
        if not isinstance(d, dict):
            return _tt(d)
        if "w" in d:
            return tcommon.Dense(_tt(d["w"]))
        return tcommon.Norm(_tt(d["g"]), _tt(d["b"]))
    return cls(**{k: leaf(v) for k, v in tree.items()})


def _time_pair(seed):
    jspec = jrwkv6.RWKV6Spec(**SPEC, chunk=8)
    params = _np_tree(jrwkv6.init_rwkv6_time(jax.random.PRNGKey(seed), jspec, jnp.float32))
    return jspec, trwkv6.RWKV6Spec(**SPEC), params, _params(trwkv6.TimeMix, params)


@pytest.mark.parametrize("impl", ["chunked", "scan"])
@pytest.mark.parametrize("with_states", [False, True])
def test_apply_rwkv6_time_matches_repro(impl, with_states):
    jspec, tspec, params, tp = _time_pair(0)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 32, 64)) * 0.5).astype(np.float32)
    x_prev = (rng.standard_normal((2, 1, 64)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((2, 4, 16, 16)) * 0.1).astype(np.float32)
    jkw = dict(x_prev=jnp.asarray(x_prev), wkv_state=jnp.asarray(s0)) if with_states else {}
    tstate = torch.from_numpy(s0.copy())
    tkw = dict(x_prev=torch.from_numpy(x_prev), wkv_state=tstate) if with_states else {}
    jy, (jlast, jst) = jrwkv6.apply_rwkv6_time(params, jspec, jnp.asarray(x), impl=impl, **jkw)
    ty, (tlast, tst) = trwkv6.apply_rwkv6_time(tp, tspec, torch.from_numpy(x), **tkw)
    for got, want in ((ty, jy), (tlast, jlast), (tst, jst)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    if with_states:             # the given state is updated in place
        assert tst is tstate


@pytest.mark.parametrize("with_prev", [False, True])
def test_apply_rwkv6_channel_matches_repro(with_prev):
    jspec = jrwkv6.RWKV6Spec(**SPEC)
    params = _np_tree(jrwkv6.init_rwkv6_channel(jax.random.PRNGKey(1), jspec, jnp.float32))
    tp = _params(trwkv6.ChannelMix, params)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    x_prev = rng.standard_normal((2, 1, 64)).astype(np.float32) if with_prev else None
    jy, jlast = jrwkv6.apply_rwkv6_channel(
        params, jnp.asarray(x), x_prev=None if x_prev is None else jnp.asarray(x_prev))
    ty, tlast = trwkv6.apply_rwkv6_channel(
        tp, torch.from_numpy(x), x_prev=None if x_prev is None else torch.from_numpy(x_prev))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))


# --------------------------------------------------------------------------
# the model: config, conversion, prefill, decode, generation
# --------------------------------------------------------------------------
def test_config_and_reduced_match_repro():
    for ours, theirs in ((registry.get_config("rwkv6-3b"), jregistry.get_config("rwkv6-3b")),
                         (registry.get_config("rwkv6-3b").reduced(),
                          jregistry.get_config("rwkv6-3b").reduced())):
        want = {k: v for k, v in dataclasses.asdict(theirs).items() if k not in DROPPED}
        assert dataclasses.asdict(ours) == want
        spec = rwkv_model.rwkv_spec(ours)
        assert (spec.n_heads, spec.d_head) == (ours.rwkv_heads, ours.d_model // ours.rwkv_heads)
    assert rwkv_model.rwkv_spec(registry.get_config("rwkv6-3b")).d_head in wkv6.HEAD_SIZES
    assert rwkv_model.rwkv_spec(registry.get_config("rwkv6-3b").reduced()).d_head in wkv6.HEAD_SIZES


def _models(seed=0):
    jcfg = jregistry.get_config("rwkv6-3b").reduced()
    tcfg = registry.get_config("rwkv6-3b").reduced()
    params = jinit_lm(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, params, lm_params_from_numpy(tcfg, _np_tree(params), "cpu")


def _check_cache(tc, jc):
    for name in CACHE_FIELDS:
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **MODEL_TOL)


@pytest.mark.parametrize("s", [16, 13], ids=["chunked", "scan"])
def test_prefill_and_decode_match_repro(s):
    """S = 16 takes `repro`'s chunked form (chunk 8), S = 13 its scan."""
    jcfg, tcfg, params, model = _models()
    b, steps = 2, 8
    prompts = np.random.default_rng(7).integers(0, tcfg.vocab, (b, s)).astype(np.int32)
    jl, jc = jprefill(params, jcfg, jinit_cache(jcfg, b, s + steps), {"tokens": jnp.asarray(prompts)})
    tl, tc = lm_prefill(model, tcfg, init_cache(tcfg, b, s + steps, "cpu"),
                        {"tokens": torch.from_numpy(prompts)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    _check_cache(tc, jc)
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = jdecode(params, jcfg, jc, jnp.asarray(tok))
        tl, tc = lm_decode_step(model, tcfg, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    _check_cache(tc, jc)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.full(b, s + steps))


def test_greedy_generation_matches_repro_and_counts_no_launch():
    jcfg, tcfg, params, model = _models(1)
    prompts = np.random.default_rng(8).integers(0, tcfg.vocab, (2, 16)).astype(np.int32)
    want = JEngine(jcfg, params, s_max=32).generate(jnp.asarray(prompts), max_new=8)
    ops.reset_launch_counts()
    got = Engine(tcfg, model, s_max=32).generate(torch.from_numpy(prompts), max_new=8)
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCH_COUNTERS, 0)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprobs.numpy(), np.asarray(want.logprobs), **MODEL_TOL)


def test_prefill_decode_match_the_teacher_forced_pass():
    """prefill(S-1) + decode(1 token) logits == the full hidden pass's."""
    cfg = registry.get_config("rwkv6-3b").reduced()
    model = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    s = 21
    toks = torch.randint(0, cfg.vocab, (2, s), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    lg_pre, cache = lm_prefill(model, cfg, init_cache(cfg, 2, s, "cpu"),
                               {"tokens": toks[:, :s - 1]})
    lg_dec, cache = lm_decode_step(model, cfg, cache, toks[:, s - 1])
    full = rwkv_model._logits(model, rwkv_model.rwkv_hidden(model, cfg, toks))
    np.testing.assert_allclose(lg_pre.numpy(), full[:, s - 2].numpy(), **LAYER_TOL)
    np.testing.assert_allclose(lg_dec.numpy(), full[:, s - 1].numpy(), **LAYER_TOL)


@pytest.mark.parametrize("where", ["extra", "missing"])
def test_lm_params_from_numpy_refuses_a_tree_that_does_not_match(where):
    jcfg = jregistry.get_config("rwkv6-3b").reduced()
    tree = _np_tree(jinit_lm(jcfg, jax.random.PRNGKey(0)))
    if where == "extra":
        tree["blocks"]["time"]["mu_y"] = tree["blocks"]["time"]["mu_x"]
    else:
        del tree["blocks"]["chan"]["mu_r"]
    with pytest.raises(ValueError, match="does not match rwkv6-3b"):
        lm_params_from_numpy(registry.get_config("rwkv6-3b").reduced(), tree, "cpu")


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------
def test_serve_cli_runs_rwkv_on_cpu(capsys):
    res = serve_cli.main(["--arch", "rwkv6-3b", "--reduced", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "8", "--max-new", "4"])
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == torch.int32
    assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < 128
    assert "generated 8 tokens" in capsys.readouterr().out


def test_rwkv_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.get_config("rwkv6-3b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--arch", "rwkv6-3b", "--reduced"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_lm(cfg, torch.Generator(), "cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 8, "cuda")
    tree = _np_tree(jinit_lm(jregistry.get_config("rwkv6-3b").reduced(), jax.random.PRNGKey(0)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_params_from_numpy(cfg, tree, "cuda")

