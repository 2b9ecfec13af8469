"""The port's dense LM serving path on the CPU against `repro`, from the
same parameters and inputs (made with numpy or by `repro` from a seed and
handed over as numpy arrays): the primitives, attention prefill and decode,
parameter conversion, prefill / decode / greedy generation at reduced
tinyllama with GQA (and stablelm, and a sliding-window variant), the
serving CLI, and the entry points' refusals.

Tolerances, all f32: 2e-5 for a single layer (the two frameworks differ
only in summation order); 1e-4 for logits after two layers and 8 decode
steps, where those differences pass through norms and matmuls."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import registry as jregistry
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import init_cache as jinit_cache
from repro.models import init_lm as jinit_lm
from repro.models import lm_decode_step as jdecode
from repro.models import lm_prefill as jprefill
from repro.serve import Engine as JEngine

from repro_torch.configs import registry
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import init_cache, init_lm, lm_decode_step, lm_prefill
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttransformer
from repro_torch.models.convert import lm_params_from_numpy, tensor_from_numpy
from repro_torch.serve import Engine

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
LAYER_TOL = dict(atol=2e-5, rtol=2e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
GQA = dict(n_heads=8, n_kv=2, d_model=128)   # reduced() alone makes tinyllama MHA
DROPPED = {"impl", "block_q", "block_k", "seq_chunk"}


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _dense(p):
    return tcommon.Dense(torch.from_numpy(np.array(p["w"])),
                         torch.from_numpy(np.array(p["b"])) if "b" in p else None)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "stablelm-1.6b", "deepseek-v2-lite-16b",
                                  "deepseek-v2-236b"])
@pytest.mark.parametrize("overrides", [{}, GQA])
def test_config_and_reduced_match_repro(arch, overrides):
    for ours, theirs in ((registry.get_config(arch), jregistry.get_config(arch)),
                         (registry.get_config(arch).reduced(**overrides),
                          jregistry.get_config(arch).reduced(**overrides))):
        want = {k: v for k, v in dataclasses.asdict(theirs).items() if k not in DROPPED}
        assert dataclasses.asdict(ours) == want
        assert ours.head_dim == theirs.head_dim
        assert ours.pdt == getattr(torch, theirs.pdt.name)


def test_registry_knows_every_arch_and_refuses_the_unported(monkeypatch):
    """Every arch of `repro` is ported (``UNPORTED`` is empty since ROADMAP
    queue 1 item 13 closed); an arch entered there still raises naming its
    item."""
    assert set(registry.ARCHS) == set(jregistry.ARCHS)
    assert registry.UNPORTED == {}
    for arch in registry.ARCHS:
        assert registry.get_config(arch).family in ("dense", "moe", "ssm", "hybrid", "vlm",
                                                    "encdec")
    monkeypatch.setitem(registry.UNPORTED, "whisper-base",
                        ("the encoder-decoder family", "queue 1 item 13"))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 13"):
        registry.get_config("whisper-base")
    with pytest.raises(KeyError):
        registry.get_config("gpt-5")


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind,bias", [("rms", False), ("layer", True), ("layer", False)])
def test_apply_norm_matches_repro(kind, bias):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32) * 3 + 1
    g = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    jp = {"g": jnp.asarray(g)} | ({"b": jnp.asarray(b)} if bias else {})
    tp = tcommon.Norm(torch.from_numpy(g), torch.from_numpy(b) if bias else None)
    want = jcommon.apply_norm(jp, jnp.asarray(x), kind=kind, eps=1e-5)
    got = tcommon.apply_norm(tp, torch.from_numpy(x), kind=kind, eps=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("d_rot", [None, 4, 8])
def test_apply_rope_matches_repro(d_rot):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 1, 7))
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), d_rot=d_rot, theta=10000.0)
    got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), d_rot=d_rot,
                             theta=10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_apply_mlp_matches_repro(kind):
    params = _np_tree(jmlp.init_mlp(jax.random.PRNGKey(2), 32, 48, jnp.float32,
                                    kind=kind, bias=True))
    x = np.random.default_rng(2).standard_normal((2, 5, 32)).astype(np.float32)
    mlp = tmlp.MLP(kind, **{k: _dense(v) for k, v in params.items()})
    want = jmlp.apply_mlp(params, jnp.asarray(x), kind=kind)
    np.testing.assert_allclose(mlp(torch.from_numpy(x)).numpy(), np.asarray(want),
                               **LAYER_TOL)


def test_tensor_from_numpy_keeps_bf16_bits():
    a = np.asarray(jnp.asarray([1.0, -2.5, 3.140625, 1e-3], jnp.bfloat16))
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


# --------------------------------------------------------------------------
# attention layer
# --------------------------------------------------------------------------
def _attn_pair(spec_kw, seed):
    jspec = jattn.AttnSpec(**spec_kw, impl="pallas", block_q=16, block_k=16)
    tspec = tattn.AttnSpec(**spec_kw)
    params = _np_tree(jattn.init_attention(jax.random.PRNGKey(seed), jspec, jnp.float32))
    tp = tattn.Attention(*(_dense(params[n]) for n in ("wq", "wk", "wv", "wo")))
    return jspec, tspec, params, tp


SPECS = [dict(d_model=64, n_q=8, n_kv=2, d_head=16),
         dict(d_model=64, n_q=4, n_kv=4, d_head=16, rope_frac=0.5, qkv_bias=True)]


@pytest.mark.parametrize("spec_kw", SPECS)
def test_apply_attention_matches_repro(spec_kw):
    jspec, tspec, params, tp = _attn_pair(spec_kw, 3)
    x = np.random.default_rng(3).standard_normal((2, 32, 64)).astype(np.float32)
    pos = np.arange(32)
    jy, (jk, jv) = jattn.apply_attention(params, jspec, jnp.asarray(x),
                                         jnp.asarray(pos), return_kv=True)
    ty, (tk, tv) = tattn.apply_attention(tp, tspec, torch.from_numpy(x),
                                         torch.from_numpy(pos), return_kv=True)
    for got, want in ((ty, jy), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    xla = jattn.apply_attention(params, dataclasses.replace(jspec, impl="xla"),
                                jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(ty.numpy(), np.asarray(xla), **LAYER_TOL)


@pytest.mark.parametrize("spec_kw,window", [(SPECS[0], None), (SPECS[1], None),
                                            (SPECS[0], 8)])
def test_decode_self_attention_matches_repro(spec_kw, window):
    """Full cache: against both of `repro`'s decode paths (masked matvec
    and the Pallas kernel). Ring buffer (window 8 = cache width): against
    `repro`'s ring path. The caches are updated in place."""
    spec_kw = dict(spec_kw, window=window)
    jspec, tspec, params, tp = _attn_pair(spec_kw, 4)
    rng = np.random.default_rng(4)
    s_max = window or 40
    hkv, dh = spec_kw["n_kv"], spec_kw["d_head"]
    x1 = rng.standard_normal((3, 1, 64)).astype(np.float32)
    ck = rng.standard_normal((3, hkv, s_max, dh)).astype(np.float32)
    cv = rng.standard_normal((3, hkv, s_max, dh)).astype(np.float32)
    pos = np.asarray([0, 17, 39], np.int32)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    ty, tk2, tv2 = tattn.decode_self_attention(tp, tspec, torch.from_numpy(x1), tk, tv,
                                               torch.from_numpy(pos))
    assert tk2 is tk and tv2 is tv
    for impl in (("xla",) if window else ("xla", "pallas")):
        jy, jk, jv = jattn.decode_self_attention(
            params, jspec, jnp.asarray(x1), jnp.asarray(ck), jnp.asarray(cv),
            jnp.asarray(pos), decode_impl=impl)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LAYER_TOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **LAYER_TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **LAYER_TOL)


# --------------------------------------------------------------------------
# the model: conversion, prefill, decode, generation
# --------------------------------------------------------------------------
def _configs(arch, **overrides):
    jcfg = jregistry.get_config(arch).reduced(**overrides)
    tcfg = registry.get_config(arch).reduced(**overrides)
    return dataclasses.replace(jcfg, impl="pallas"), tcfg


def _models(arch, seed=0, **overrides):
    jcfg, tcfg = _configs(arch, **overrides)
    params = jinit_lm(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, params, lm_params_from_numpy(tcfg, _np_tree(params), "cpu")


@pytest.mark.parametrize("arch,overrides", [
    ("tinyllama-1.1b", GQA),
    ("stablelm-1.6b", {}),                       # LayerNorm + bias, partial RoPE, qkv bias
    ("tinyllama-1.1b", dict(GQA, window=8)),     # ring-buffer cache
], ids=["tinyllama-gqa", "stablelm", "tinyllama-gqa-window"])
def test_prefill_and_decode_match_repro(arch, overrides):
    jcfg, tcfg, params, model = _models(arch, **overrides)
    b, s, s_max, steps = 2, 32, 48, 8
    prompts = np.random.default_rng(5).integers(0, tcfg.vocab, (b, s)).astype(np.int32)
    jl, jc = jprefill(params, jcfg, jinit_cache(jcfg, b, s_max), {"tokens": jnp.asarray(prompts)})
    tl, tc = lm_prefill(model, tcfg, init_cache(tcfg, b, s_max, "cpu"),
                        {"tokens": torch.from_numpy(prompts)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    for i in range(2):
        np.testing.assert_allclose(tc["main"][i].numpy(), np.asarray(jc["main"][i]),
                                   **MODEL_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jc = jdecode(params, jcfg, jc, jnp.asarray(tok))
        tl, tc = lm_decode_step(model, tcfg, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    for i in range(2):
        np.testing.assert_allclose(tc["main"][i].numpy(), np.asarray(jc["main"][i]),
                                   **MODEL_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.full(b, s + steps))


def test_greedy_generation_matches_repro_and_counts_no_launch():
    jcfg, tcfg, params, model = _models("tinyllama-1.1b", **GQA)
    prompts = np.random.default_rng(6).integers(0, tcfg.vocab, (2, 16)).astype(np.int32)
    want = JEngine(jcfg, params, s_max=32).generate(jnp.asarray(prompts), max_new=8)
    ops.reset_launch_counts()
    got = Engine(tcfg, model, s_max=32).generate(torch.from_numpy(prompts), max_new=8)
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCH_COUNTERS, 0)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_allclose(got.logprobs.numpy(), np.asarray(want.logprobs), **MODEL_TOL)


def test_prefill_decode_match_the_teacher_forced_pass():
    """prefill(S-1) + decode(1 token) logits == the full hidden pass's."""
    cfg = registry.get_config("tinyllama-1.1b").reduced(**GQA)
    model = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    s = 32
    toks = torch.randint(0, cfg.vocab, (2, s), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    lg_pre, cache = lm_prefill(model, cfg, init_cache(cfg, 2, s + 16, "cpu"),
                               {"tokens": toks[:, :s - 1]})
    lg_dec, cache = lm_decode_step(model, cfg, cache, toks[:, s - 1])
    full = ttransformer._logits(cfg, model, ttransformer.decoder_hidden(model, cfg, toks))
    np.testing.assert_allclose(lg_pre.numpy(), full[:, s - 2].numpy(), atol=2e-3, rtol=2e-2)
    np.testing.assert_allclose(lg_dec.numpy(), full[:, s - 1].numpy(), atol=2e-3, rtol=2e-2)


def test_sampling_draws_from_the_generator():
    cfg = registry.get_config("tinyllama-1.1b").reduced()
    model = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = torch.zeros((2, 4), dtype=torch.int32)
    eng = Engine(cfg, model, s_max=12, eos_id=3)
    runs = [eng.generate(prompts, max_new=8, temperature=1.0,
                         generator=torch.Generator().manual_seed(s)).tokens
            for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    for toks in runs:       # after EOS a sequence keeps emitting EOS
        for row in toks.tolist():
            if 3 in row:
                assert set(row[row.index(3):]) == {3}


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------
def test_serve_cli_runs_on_cpu(capsys):
    res = serve_cli.main(["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "8", "--max-new", "4"])
    assert res.tokens.shape == (2, 4) and res.tokens.dtype == torch.int32
    assert int(res.tokens.min()) >= 0 and int(res.tokens.max()) < 128
    assert "generated 8 tokens" in capsys.readouterr().out


def test_serve_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.get_config("tinyllama-1.1b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli.main(["--arch", "tinyllama-1.1b", "--reduced"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_lm(cfg, torch.Generator(), "cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 8, "cuda")


@pytest.mark.parametrize("overrides,item", [
    # MoE and MLA were ported with ROADMAP queue 1 item 13's first bullet:
    # these two cases now build and serve
    (dict(family="moe", moe=True, n_experts=4, top_k=2, d_ff_expert=16, first_dense=1,
          capacity_factor=4.0), "item 13"),
    (dict(attn_kind="mla", kv_lora_rank=16, mla_d_nope=8, mla_d_rope=8, mla_d_v=16),
     "item 13"),
    # the VLM frontend and the parallel block were ported with item 13's
    # last bullets: these cases now build internvl2-1b's reduced config and
    # a parallel-block tinyllama and serve them
    (dict(family="vlm"), "item 13"),
    (dict(parallel_block=True), "item 13"),
    # the Mamba2 hybrid was ported with item 13's third bullet: this case
    # now builds zamba2-7b's reduced config and serves it
    (dict(family="hybrid"), "item 13"),
])
def test_unported_model_features_raise(overrides, item):
    """Every feature item 13 named is ported: MoE FFNs (with their leading
    dense stack), MLA attention, a VLM's patches, the parallel block and
    the hybrid (zamba2-7b reduced) build, and a prefill and a decode step
    through them give finite logits."""
    cfg = dataclasses.replace(registry.get_config("tinyllama-1.1b").reduced(), **overrides)
    batch = {"tokens": torch.ones((2, 8), dtype=torch.int32)}
    if cfg.family == "hybrid":
        cfg = registry.get_config("zamba2-7b").reduced()
    if cfg.family == "vlm":
        cfg = registry.get_config("internvl2-1b").reduced()
        batch["frontend"] = torch.randn((2, cfg.n_patches, cfg.d_model),
                                        generator=torch.Generator().manual_seed(1))
    model = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    if cfg.family == "hybrid":
        assert [len(group) for group in model.mamba] == [2, 2] and len(model.trailing) == 1
    else:
        assert len(model.dense_blocks) == (1 if cfg.moe else 0)
        assert all((blk.moe is not None) == cfg.moe for blk in model.blocks)
        assert all((blk.ln2 is None) == cfg.parallel_block for blk in model.blocks)
        assert all(type(blk.attn).__name__ == ("MLA" if cfg.attn_kind == "mla" else "Attention")
                   for blk in model.blocks)
    cache = init_cache(cfg, 2, cfg.n_patches + 12, "cpu")
    logits, cache = lm_prefill(model, cfg, cache, batch)
    assert int(cache["pos"][0]) == cfg.n_patches + 8
    logits, cache = lm_decode_step(model, cfg, cache, logits.argmax(-1).int())
    assert logits.shape == (2, cfg.vocab) and bool(torch.isfinite(logits).all())


def test_serve_cli_refuses_checkpoints_and_unported_archs(tmp_path, monkeypatch, capsys):
    """``--ckpt-dir`` restores parameters (tests/test_torch_checkpoint.py);
    a checkpoint that holds no parameters (here a partitioner's) is
    refused, as an arch entered in ``UNPORTED`` is; whisper-base, the last
    arch item 13 ported, serves."""
    from repro.checkpoint import save_checkpoint as jax_save_checkpoint

    jax_save_checkpoint(str(tmp_path), 1, {"labels": np.zeros(8, np.int32)})
    with pytest.raises(ValueError, match="holds no params tree"):
        serve_cli.main(["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path)])
    res = serve_cli.main(["--arch", "whisper-base", "--reduced", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "4", "--max-new", "3"])
    assert res.tokens.shape == (2, 3) and "generated 6 tokens" in capsys.readouterr().out
    monkeypatch.setitem(registry.UNPORTED, "whisper-base",
                        ("the encoder-decoder family", "queue 1 item 13"))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 13"):
        serve_cli.main(["--arch", "whisper-base", "--reduced", "--device", "cpu"])


def test_serving_on_the_cpu_builds_and_loads_nothing():
    """Import every module of the LM paths and serve the dense (a
    sliding-window and a parallel-block one too), the RWKV, the hybrid, the
    VLM and the encoder-decoder family on the CPU,
    with the compiler and the library loader made to fail: neither may be
    reached, and no kernel launch is counted."""
    code = textwrap.dedent("""
        import ctypes, subprocess
        import torch
        def boom(*a, **k):
            raise AssertionError("build or load attempted")
        subprocess.Popen = boom
        ctypes.CDLL = boom
        from repro_torch.kernels import _build, ops
        from repro_torch.launch import serve
        for arch in ("tinyllama-1.1b", "rwkv6-3b", "h2o-danube-3-4b", "zamba2-7b",
                     "command-r-plus-104b", "internvl2-1b", "whisper-base"):
            serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--batch", "1", "--prompt-len", "4", "--max-new", "2"])
        assert _build._libs == {}
        assert set(ops.launch_counts().values()) == {0}
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
