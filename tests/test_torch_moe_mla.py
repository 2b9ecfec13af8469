"""The port's DeepSeek-V2 path on the CPU against `repro`, from the same
parameters and inputs (made with numpy or by `repro` from a seed and handed
over as numpy arrays): the MoE router, capacity and sort-based dispatch
(drop set, load and routing equal), the dense MoE oracle, MLA's prefill
(with and without q LoRA) and its absorbed decode, K4's plain version at
MLA's head widths (24 reduced, 192 full), reduced deepseek-v2-lite-16b and
deepseek-v2-236b prefill plus greedy decode, the parameter conversion of
the ``moe`` family's tree and the serving CLI.

Tolerances, all f32: 1e-5 for one MoE layer (the two frameworks differ
in summation order, and the port sums a token's K gated outputs where
`repro` scatter-adds them in sorted-pair order), 2e-5 for one attention
layer (as ``tests/test_torch_models.py``), 1e-4 for logits after two
layers and 8 decode steps. Router ties: the inputs are random f32 values,
where the K-th and (K+1)-th probabilities never tie exactly, so
``torch.topk`` and ``jax.lax.top_k`` pick the same experts."""
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
from repro.models import init_cache as jinit_cache
from repro.models import init_lm as jinit_lm
from repro.models import lm_decode_step as jdecode
from repro.models import lm_prefill as jprefill
from repro.models import mla as jmla
from repro.models import moe as jmoe

from repro_torch.configs import registry
from repro_torch.kernels import flash_attention, ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import init_cache, lm_decode_step, lm_prefill
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.models.common import Dense, Norm
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.models.mlp import MLP
from repro_torch.serve import Engine

MOE_TOL = dict(atol=1e-5, rtol=1e-5)
LAYER_TOL = dict(atol=2e-5, rtol=2e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["deepseek-v2-lite-16b", "deepseek-v2-236b"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _t(a):
    return torch.from_numpy(np.array(a))


def _dense(p):
    return Dense(_t(p["w"]), _t(p["b"]) if "b" in p else None)


def _moe_pair(spec_kw, seed):
    jspec = jmoe.MoESpec(**spec_kw)
    params = _np_tree(jmoe.init_moe(jax.random.PRNGKey(seed), jspec, jnp.float32))
    shared = (MLP("swiglu", **{k: _dense(v) for k, v in params["shared"].items()})
              if "shared" in params else None)
    tp = tmoe.MoE(_dense(params["router"]), _t(params["w_gate"]), _t(params["w_up"]),
                  _t(params["w_down"]), shared)
    return jspec, tmoe.MoESpec(**spec_kw), params, tp


MOE_SPECS = {
    # capacity 8 against a mean load of 16: experts overflow, pairs drop
    "drops": dict(d_model=32, n_experts=8, top_k=2, d_ff_expert=24, n_shared=1,
                  capacity_factor=0.5),
    # DeepSeek-V2's routed scale and renormalised gates, the default capacity
    "scaled": dict(d_model=32, n_experts=16, top_k=4, d_ff_expert=16, n_shared=2,
                   norm_topk=True, routed_scale=16.0),
    # dropless (capacity >= T), no shared expert
    "dropless": dict(d_model=32, n_experts=8, top_k=2, d_ff_expert=24,
                     capacity_factor=8.0),
}


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(MOE_SPECS))
def test_route_and_capacity_match_repro(name):
    jspec, tspec, params, tp = _moe_pair(MOE_SPECS[name], 0)
    x = np.random.default_rng(0).standard_normal((64, 32)).astype(np.float32)
    jg, ji, jp = jmoe.route(params["router"], jnp.asarray(x), jspec)
    tg, ti, tpr = tmoe.route(tp.router, torch.from_numpy(x), tspec)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **MOE_TOL)
    np.testing.assert_allclose(tpr.numpy(), np.asarray(jp), **MOE_TOL)
    for t in (1, 7, 8, 64, 1000, 8200):
        assert tmoe.moe_capacity(t, tspec) == jmoe.moe_capacity(t, jspec)


@pytest.mark.parametrize("name", list(MOE_SPECS))
def test_apply_moe_matches_repro_with_the_same_drops(name):
    """Output within 1e-5; the drop count, the routing and the per-expert
    load exactly equal, including where capacity drops pairs."""
    jspec, tspec, params, tp = _moe_pair(MOE_SPECS[name], 1)
    x = np.random.default_rng(1).standard_normal((2, 32, 32)).astype(np.float32)
    jy, js = jmoe.apply_moe(params, jnp.asarray(x), jspec, return_stats=True)
    ty, ts = tmoe.apply_moe(tp, torch.from_numpy(x), tspec, return_stats=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MOE_TOL)
    assert int(ts["dropped"]) == int(js["dropped"])
    if name == "drops":
        assert int(ts["dropped"]) > 0
    else:
        assert int(ts["dropped"]) == 0
    np.testing.assert_array_equal(ts["top_idx"].numpy(), np.asarray(js["top_idx"]))
    np.testing.assert_array_equal(ts["expert_load"].numpy(), np.asarray(js["expert_load"]))
    np.testing.assert_allclose(ts["router_probs_mean"].numpy(),
                               np.asarray(js["router_probs_mean"]), **MOE_TOL)
    # [T, d] input too, and no stats
    y2 = tmoe.apply_moe(tp, torch.from_numpy(x.reshape(64, 32)), tspec)
    np.testing.assert_array_equal(y2.numpy(), ty.numpy().reshape(64, 32))


@pytest.mark.parametrize("name", ["scaled", "dropless"])
def test_moe_ref_matches_repro_and_dropless_dispatch(name):
    jspec, tspec, params, tp = _moe_pair(MOE_SPECS[name], 2)
    x = np.random.default_rng(2).standard_normal((3, 11, 32)).astype(np.float32)
    want = jmoe.moe_ref(params, jnp.asarray(x), jspec)
    got = tmoe.moe_ref(tp, torch.from_numpy(x), tspec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    dropless = dataclasses.replace(tspec, capacity_factor=tspec.n_experts / tspec.top_k)
    np.testing.assert_allclose(tmoe.apply_moe(tp, torch.from_numpy(x), dropless).numpy(),
                               got.numpy(), **MOE_TOL)


def test_moe_combine_adds_with_no_scatter(monkeypatch):
    """The dispatch and combine use gathers, a permutation and a sum over K:
    no index_add_ or scatter-add, whose float atomics on the card would make
    two calls differ. Two calls are bit-equal."""
    def boom(*a, **k):
        raise AssertionError("scatter-add reached")
    for name in ("index_add", "index_add_", "scatter_add", "scatter_add_",
                 "scatter_reduce", "scatter_reduce_"):
        monkeypatch.setattr(torch.Tensor, name, boom)
    monkeypatch.setattr(torch, "index_add", boom)
    monkeypatch.setattr(torch, "scatter_add", boom)
    _, tspec, _, tp = _moe_pair(MOE_SPECS["drops"], 3)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((40, 32)).astype(np.float32))
    a, stats = tmoe.apply_moe(tp, x, tspec, return_stats=True)
    assert int(stats["dropped"]) > 0
    assert torch.equal(a, tmoe.apply_moe(tp, x, tspec))


def test_decode_batch_never_drops_at_the_serving_capacity():
    """At batch 8 decode a layer sees 8 tokens, the capacity is 8 and a
    token's K picks are distinct experts, so no expert takes more than 8."""
    cfg = registry.get_config("deepseek-v2-lite-16b")
    spec = tmoe.MoESpec(d_model=32, n_experts=cfg.n_experts, top_k=cfg.top_k,
                        d_ff_expert=8, n_shared=cfg.n_shared_experts,
                        capacity_factor=cfg.capacity_factor)
    assert tmoe.moe_capacity(8, spec) == 8
    tp = tmoe.init_moe(torch.Generator().manual_seed(4), spec, torch.float32)
    x = torch.zeros((8, 1, 32))
    x[:, 0, 0] = 1.0               # every token routes to the same 6 experts
    _, stats = tmoe.apply_moe(tp, x, spec, return_stats=True)
    assert int(stats["dropped"]) == 0 and float(stats["expert_load"].max()) == 8.0


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------
def _mla_pair(q_lora_rank, seed):
    kw = dict(d_model=64, n_heads=4, q_lora_rank=q_lora_rank, kv_lora_rank=16,
              d_nope=16, d_rope=8, d_v=16)
    jspec = jmla.MLASpec(**kw, impl="pallas", block_q=16, block_k=16)
    params = _np_tree(jmla.init_mla(jax.random.PRNGKey(seed), jspec, jnp.float32))
    tp = tmla.MLA(**{k: _dense(v) if "w" in v else Norm(_t(v["g"]))
                     for k, v in params.items()})
    return jspec, tmla.MLASpec(**kw), params, tp


@pytest.mark.parametrize("q_lora_rank", [0, 24], ids=["lite", "q_lora"])
def test_apply_mla_matches_repro(q_lora_rank):
    jspec, tspec, params, tp = _mla_pair(q_lora_rank, 5)
    x = np.random.default_rng(5).standard_normal((2, 32, 64)).astype(np.float32)
    pos = np.arange(32)
    jy, (jc, jpe) = jmla.apply_mla(params, jspec, jnp.asarray(x), jnp.asarray(pos),
                                   return_cache=True)
    ty, (tc, tpe) = tmla.apply_mla(tp, tspec, torch.from_numpy(x), torch.from_numpy(pos),
                                   return_cache=True)
    assert tuple(tc.shape) == (2, 32, 16) and tuple(tpe.shape) == (2, 32, 8)
    for got, want in ((ty, jy), (tc, jc), (tpe, jpe)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    xla = jmla.apply_mla(params, dataclasses.replace(jspec, impl="xla"), jnp.asarray(x),
                         jnp.asarray(pos))
    np.testing.assert_allclose(ty.numpy(), np.asarray(xla), **LAYER_TOL)


@pytest.mark.parametrize("q_lora_rank", [0, 24], ids=["lite", "q_lora"])
def test_decode_mla_matches_repro_and_the_prefill(q_lora_rank):
    """The absorbed decode against `repro`'s on random caches (written in
    place), and the port's decode at position P against its own prefill of
    P + 1 tokens."""
    jspec, tspec, params, tp = _mla_pair(q_lora_rank, 6)
    rng = np.random.default_rng(6)
    x1 = rng.standard_normal((3, 1, 64)).astype(np.float32)
    cc = rng.standard_normal((3, 40, 16)).astype(np.float32)
    cpe = rng.standard_normal((3, 40, 8)).astype(np.float32)
    pos = np.asarray([0, 17, 39], np.int32)
    tcc, tcpe = torch.from_numpy(cc.copy()), torch.from_numpy(cpe.copy())
    ty, tcc2, tcpe2 = tmla.decode_mla(tp, tspec, torch.from_numpy(x1), tcc, tcpe,
                                      torch.from_numpy(pos))
    assert tcc2 is tcc and tcpe2 is tcpe
    jy, jcc, jcpe = jmla.decode_mla(params, jspec, jnp.asarray(x1), jnp.asarray(cc),
                                    jnp.asarray(cpe), jnp.asarray(pos))
    for got, want in ((ty, jy), (tcc, jcc), (tcpe, jcpe)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)

    p, s_max = 20, 24
    x = torch.from_numpy(rng.standard_normal((2, p + 1, 64)).astype(np.float32))
    whole = tmla.apply_mla(tp, tspec, x, torch.arange(p + 1))
    _, (c, pe) = tmla.apply_mla(tp, tspec, x[:, :p], torch.arange(p), return_cache=True)
    cache_c, cache_pe = torch.zeros((2, s_max, 16)), torch.zeros((2, s_max, 8))
    cache_c[:, :p], cache_pe[:, :p] = c, pe
    y, _, _ = tmla.decode_mla(tp, tspec, x[:, p:], cache_c, cache_pe,
                              torch.full((2,), p, dtype=torch.int32))
    np.testing.assert_allclose(y[:, 0].numpy(), whole[:, p].numpy(), **LAYER_TOL)


@pytest.mark.parametrize("b,h,s,d", [(2, 4, 64, 24), (1, 2, 64, 192)])
def test_flash_attention_plain_at_mla_head_dims(b, h, s, d):
    """K4's plain version at MLA's reduced (24) and full (192) head width
    against `repro`'s Pallas kernel in interpret mode and its oracle."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))
    got = flash_attention.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    pallas = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=True, window=None, block_q=32, block_k=32,
                                  interpret=True)
    want = ref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **LAYER_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    assert d in flash_attention.HEAD_DIMS


# --------------------------------------------------------------------------
# the models: configs, conversion, prefill, decode, serving
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _params(arch):
    """`repro`'s reduced parameters of ``arch`` from seed 0 (made once a
    worker; callers copy the tree before changing it)."""
    cfg = jregistry.get_config(arch).reduced()
    return jax.jit(jinit_lm, static_argnums=0)(cfg, jax.random.PRNGKey(0))


def _tree(arch):
    return _np_tree(_params(arch))


def _models(arch):
    jcfg = dataclasses.replace(jregistry.get_config(arch).reduced(), impl="pallas")
    tcfg = registry.get_config(arch).reduced()
    params = _params(arch)
    return jcfg, tcfg, params, lm_params_from_numpy(tcfg, _np_tree(params), "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_deepseek_prefill_and_decode_match_repro(arch):
    """Reduced configs (1 dense + 1 MoE layer, MLA at head width 24; 236b
    with q LoRA and routed scale 16) against `repro` with its Pallas
    attention interpreted: prefill, 8 greedy decode steps, both caches."""
    jcfg, tcfg, params, model = _models(arch)
    assert len(model.dense_blocks) == 1 and len(model.blocks) == 1
    b, s, s_max, steps = 2, 32, 48, 8
    prompts = np.random.default_rng(8).integers(0, tcfg.vocab, (b, s)).astype(np.int32)
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
    assert set(tc) == set(jc) == {"main", "dense", "pos"}
    for key in ("main", "dense"):
        for i in range(2):
            np.testing.assert_allclose(tc[key][i].numpy(), np.asarray(jc[key][i]), **MODEL_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.full(b, s + steps))


def test_greedy_generation_serves_deepseek_on_the_cpu():
    tcfg = registry.get_config("deepseek-v2-lite-16b").reduced()
    model = lm_params_from_numpy(tcfg, _tree("deepseek-v2-lite-16b"), "cpu")
    prompts = torch.from_numpy(np.random.default_rng(9).integers(0, 128, (2, 12)).astype(np.int32))
    eng = Engine(tcfg, model, s_max=20)
    a, b = eng.generate(prompts, max_new=8), eng.generate(prompts, max_new=8)
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.logprobs, b.logprobs)
    assert a.tokens.shape == (2, 8) and bool(torch.isfinite(a.logprobs).all())


@pytest.mark.parametrize("change,arch", [
    ("extra", "deepseek-v2-lite-16b"),
    ("missing", "deepseek-v2-lite-16b"),
    ("no_shared", "deepseek-v2-lite-16b"),
    ("no_dense_blocks", "deepseek-v2-lite-16b"),
    ("layers", "deepseek-v2-lite-16b"),
    ("q_lora", "deepseek-v2-236b"),
])
def test_lm_params_from_numpy_refuses_a_moe_tree_that_does_not_match(change, arch):
    """A leaf the port would not use, one it lacks, a missing shared expert
    or dense stack, a stack of another depth, or the q projection of the
    other MLA form are refused; the unchanged tree converts."""
    tree = _tree("deepseek-v2-lite-16b")
    cfg = registry.get_config(arch).reduced()
    if change == "extra":
        tree["blocks"]["moe"]["w_extra"] = tree["blocks"]["moe"]["w_up"]
    elif change == "missing":
        del tree["dense_blocks"]["attn"]["wo"]
    elif change == "no_shared":
        del tree["blocks"]["moe"]["shared"]
    elif change == "no_dense_blocks":
        del tree["dense_blocks"]
    elif change == "layers":
        cfg = dataclasses.replace(cfg, n_layers=3)
    with pytest.raises(ValueError, match=f"does not match {cfg.name}"):
        lm_params_from_numpy(cfg, tree, "cpu")
    model = lm_params_from_numpy(registry.get_config("deepseek-v2-lite-16b").reduced(),
                                 _tree("deepseek-v2-lite-16b"), "cpu")
    names = {n for n, _ in model.named_parameters()}
    assert {"blocks.0.moe.w_gate", "blocks.0.moe.router.w", "blocks.0.moe.shared.w_up.w",
            "dense_blocks.0.mlp.w_down.w", "dense_blocks.0.attn.wkv_a.w",
            "blocks.0.attn.kv_norm.g"} <= names


def test_serve_cli_runs_deepseek_on_cpu(capsys):
    res = serve_cli.main(["--arch", "deepseek-v2-lite-16b", "--reduced", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "8", "--max-new", "4"])
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == torch.int32
    assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < 128
    assert "generated 8 tokens" in capsys.readouterr().out
