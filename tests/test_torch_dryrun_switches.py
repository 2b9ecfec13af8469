"""The dry run's three switches — `repro`'s ``bf16_silu``, ``seq_parallel``
and ``zero_dp`` — on the CPU against `repro`'s.

  * ``bf16_silu``: `swiglu` under ``use_activation_sharding(mesh,
    bf16_silu=True)`` is bit-equal to `repro`'s for bf16 [64, 5632] and the
    reduced archs' FFN shapes (the chain `kernels.swiglu.swiglu_bf16_plain`,
    F1's plain version and the CPU route of ``ops.swiglu``); an f32
    activation keeps the f32 path; autograd takes the plain chain and
    ``ops.swiglu`` refuses it; F1's meta route counts 0 FLOPs and 6 bytes an
    element in bf16. Reduced tinyllama-1.1b and deepseek-v2-lite-16b in
    bf16 under the switch: prefill and 4 greedy decode steps against
    `repro`'s, logits within BF16_LOGITS_RTOL relative L2 (bf16 rounds at
    other places in the two frameworks: the attention's softmax, the
    norms); the train loss within 1e-2 relative and each gradient leaf
    within 5e-2 relative L2 (the bf16 tolerances of
    ``tests/test_torch_train_losses.py``).
  * ``seq_parallel``: changes no value (the hooks are identities: loss,
    gradients and logits bit-equal with and without it, also under a
    counter on real tensors). Counted on the (data 2, model 2) mesh:
    prefill and decode rows equal with and without it, as in `repro`
    (whose prefill block takes no hook); training rows have the default
    row's FLOPs, every all-reduce the plan drops becomes one
    reduce-scatter of half its bytes, and in the forward pass of a serial
    dense block stack the reduce-scatters plus the all-gathers cost
    exactly the all-reduces they replace (`cost_count`'s module docstring:
    a ring all-reduce is a reduce-scatter and an all-gather). Over the
    whole step the port books one reduce-scatter per partial product, as
    its default books one all-reduce per product, so the backward's gather
    points send less than they replace; the gathers at the stream's ends
    (the LM head's input, its recomputation in the checkpointed loss, the
    embedding's gradient) and the first block's attention gradient add
    their own, pinned below. On the production single-pod mesh a train
    row's ``temp_gb`` falls (the residual stream saved across each
    rematerialised block is S / 16 a rank).
    XLA's SP lowering of `repro`'s reduced step is not this plan
    (subprocess under 4 forced host devices): on tinyllama-1.1b's
    ``train_4k`` it keeps its all-reduces and adds gathers, all-to-alls
    and permutes — all-reduce 314,548 B, all-gather 110,656, all-to-all
    49,152, collective-permute 8,256, against 296,884 of all-reduce
    without SP — where the port's count books all-reduce 231,256,
    reduce-scatter 32,768 and all-gather 36,864 against 296,792. Held
    against `repro` (`SP_CASES`): prefill and decode unchanged by SP in
    both, training FLOPs unchanged in both.
  * ``zero_dp=False``: the optimizer state takes the parameters' specs;
    the per-rank argument bytes equal `repro`'s from its spec functions for
    every runnable train cell on both production meshes, and its
    ``memory_analysis`` on the reduced step (one device in process, the
    (2, 2) mesh in the subprocess).
  * The CLI: ``--seq-parallel`` and ``--bf16-silu`` reach the row,
    ``--all`` resumes keyed on ``seq_parallel``, and ``--timeout`` makes a
    cell past it a ``FAILED`` row.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_dryrun import (DENSE, ROOT, _reduced, _repro_arguments,  # noqa: E402
                               _repro_costs)
from test_torch_train_losses import (BF16_LEAF_TOL, BF16_LOSS_RTOL, _batch,  # noqa: E402
                                     _port_value_and_grad, _repro_value_and_grad)

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import swiglu as tswiglu  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import LMMesh, make_host_mesh  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import init_cache, lm_decode_step, lm_loss, lm_prefill  # noqa: E402
from repro_torch.models.convert import lm_params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.parallel.act_sharding import use_activation_sharding  # noqa: E402
from repro_torch.parallel.cost_count import CostCounter  # noqa: E402

BF16_LOGITS_RTOL = 2e-2
SP_ARCHS = DENSE + ["internvl2-1b", "deepseek-v2-lite-16b", "zamba2-7b"]
SERIAL_DENSE = ["tinyllama-1.1b", "h2o-danube-3-4b", "stablelm-1.6b"]
# zamba2-7b's default count gives its last block's output gradient, a
# fresh tensor in backward, the splits of the last forward tensor of its
# shape (`CostCounter._backward_splits`), there one split over "model" on
# the hidden axis; under SP the hook states the stream's layout instead, so
# the products behind it ([64, 128] and [128, 64] outputs) book other
# all-reduces: 8,192 B of the dropped all-reduce bytes have no
# reduce-scatter
PLAN_SHIFT = {"zamba2-7b": 8192}
MESH = ((2, 2), ("data", "model"))


def _jmesh():
    from repro.launch.mesh import make_mesh_compat

    return make_mesh_compat((1, 1), ("data", "model"))


def _coll(row, kind) -> dict:
    return (row["collectives"] or {}).get(kind, {"count": 0.0, "bytes": 0.0})


# --------------------------------------------------------------------------
# bf16_silu
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(64, 5632), (2, 32, 64), (2, 8, 64), (4, 12, 32), (3, 7, 5)])
def test_swiglu_bf16_is_bit_equal_to_repro(shape):
    """[64, 5632] and the reduced archs' FFN activations (tinyllama's
    [B, S, d_ff], deepseek's shared expert and its [E, C, d_ff_expert]),
    and a ragged one."""
    from repro.models.common import swiglu as jswiglu
    from repro.parallel.act_sharding import use_activation_sharding as juse

    rng = np.random.default_rng(sum(shape))
    gate = np.asarray(jnp.asarray(rng.standard_normal(shape) * 3, jnp.bfloat16))
    up = np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
    with juse(_jmesh(), bf16_silu=True):
        want = np.asarray(jax.jit(jswiglu)(gate, up)).astype(np.float32)
    tg, tu = tensor_from_numpy(gate, "cpu"), tensor_from_numpy(up, "cpu")
    default = tcommon.swiglu(tg, tu)
    with use_activation_sharding(make_host_mesh(device="cpu"), bf16_silu=True):
        got = tcommon.swiglu(tg, tu)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(tswiglu.swiglu_bf16_plain(tg, tu).float().numpy(), want)
    if shape == (64, 5632):                 # the switch changes values: SiLU rounds in bf16
        assert (default != got).sum() > 0.2 * got.numel()


def test_swiglu_switch_routes():
    """An f32 activation keeps the f32 path under the switch (the two
    coincide in `repro`); under autograd the plain chain runs and gets
    gradients, and ``ops.swiglu`` refuses; without the switch nothing
    reaches F1; the meta route reports 0 FLOPs, gate and up read, the
    output written."""
    rng = np.random.default_rng(0)
    g32 = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    u32 = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    host = make_host_mesh(device="cpu")
    default = tcommon.swiglu(g32, u32)
    with use_activation_sharding(host, bf16_silu=True):
        assert torch.equal(tcommon.swiglu(g32, u32), default)
        g = g32.bfloat16().requires_grad_()
        u = u32.bfloat16().requires_grad_()
        out = tcommon.swiglu(g, u)
        out.float().sum().backward()
        assert g.grad is not None and u.grad is not None
        assert torch.equal(out.detach(), tswiglu.swiglu_bf16_plain(g.detach(), u.detach()))
        with pytest.raises(RuntimeError, match="no backward"):
            ops.swiglu(g, u)
    calls = []
    ops.KERNEL_HOOK.fn = lambda name, flops, reads, writes: calls.append(
        (name, flops, [tuple(t.shape) for t in reads], [tuple(t.shape) for t in writes]))
    try:
        gm = torch.empty(8, 32, dtype=torch.bfloat16, device="meta")
        tcommon.swiglu(gm, gm)
        assert calls == []
        with use_activation_sharding(host, bf16_silu=True):
            out = tcommon.swiglu(gm, gm)
    finally:
        ops.KERNEL_HOOK.fn = None
    assert out.device.type == "meta" and out.shape == gm.shape and out.dtype == torch.bfloat16
    assert calls == [("swiglu", 0, [(8, 32), (8, 32)], [(8, 32)])]


def test_dry_run_counts_f1_where_the_f32_path_was():
    """A bf16 serving row under the switch: one F1 call a layer, 6 bytes an
    element where the f32 path's cast, SiLU, cast and multiply moved 26,
    and the same FLOPs."""
    cfg = treg.get_config("tinyllama-1.1b").reduced(param_dtype="bfloat16",
                                                    compute_dtype="bfloat16")
    shape = treg.reduced_shape("prefill_32k")
    rows = [dryrun.dryrun_cell("x", "prefill_32k", "host", cfg=cfg, shape=shape,
                               mesh=make_host_mesh(device="cpu"), verbose=False, bf16_silu=on)
            for on in (False, True)]
    n = shape.global_batch * shape.seq_len * cfg.d_ff
    assert rows[1]["kernel_calls"]["swiglu"] == cfg.n_layers
    assert "swiglu" not in rows[0]["kernel_calls"]
    assert rows[0]["flops"] == rows[1]["flops"]
    assert rows[0]["bytes"] - rows[1]["bytes"] == (26 - 6) * n * cfg.n_layers
    assert rows[1]["bf16_silu"] and not rows[0]["bf16_silu"]


def _bf16_models(arch):
    from repro.configs import registry as jreg
    from repro.models import init_lm as jinit_lm

    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg, tcfg = jreg.get_config(arch).reduced(**kw), treg.get_config(arch).reduced(**kw)
    if jcfg.family == "moe":
        import dataclasses

        jcfg = dataclasses.replace(jcfg, impl="pallas")
    params = jax.jit(jinit_lm, static_argnums=0)(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jax.device_get(params))
    return jcfg, tcfg, params, lm_params_from_numpy(tcfg, tree, "cpu")


def _rel(got: torch.Tensor, want) -> float:
    w = np.asarray(want, np.float32)
    return float(np.linalg.norm(got.float().numpy() - w) / np.linalg.norm(w))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-lite-16b"])
def test_bf16_silu_serving_matches_repro(arch):
    from repro.models import init_cache as jinit_cache
    from repro.models import lm_decode_step as jdecode
    from repro.models import lm_prefill as jprefill
    from repro.parallel.act_sharding import use_activation_sharding as juse

    jcfg, tcfg, params, model = _bf16_models(arch)
    b, s, s_max, steps = 2, 32, 40, 4
    prompts = np.random.default_rng(3).integers(0, tcfg.vocab, (b, s)).astype(np.int32)
    host = make_host_mesh(device="cpu")
    with juse(_jmesh(), bf16_silu=True):
        prefill = jax.jit(jprefill, static_argnums=1)
        decode = jax.jit(jdecode, static_argnums=1)
        jl, jc = prefill(params, jcfg, jinit_cache(jcfg, b, s_max),
                         {"tokens": jnp.asarray(prompts)})
        with use_activation_sharding(host, bf16_silu=True):
            tl, tc = lm_prefill(model, tcfg, init_cache(tcfg, b, s_max, "cpu"),
                                {"tokens": torch.from_numpy(prompts)})
        assert _rel(tl, jl) < BF16_LOGITS_RTOL
        for _ in range(steps):
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
            jl, jc = decode(params, jcfg, jc, jnp.asarray(tok))
            with use_activation_sharding(host, bf16_silu=True):
                tl, tc = lm_decode_step(model, tcfg, tc, torch.from_numpy(tok))
            assert _rel(tl, jl) < BF16_LOGITS_RTOL
    default, _ = lm_prefill(model, tcfg, init_cache(tcfg, b, s_max, "cpu"),
                            {"tokens": torch.from_numpy(prompts)})
    with use_activation_sharding(host, bf16_silu=True):
        switched, _ = lm_prefill(model, tcfg, init_cache(tcfg, b, s_max, "cpu"),
                                 {"tokens": torch.from_numpy(prompts)})
    assert not torch.equal(default, switched)


def test_bf16_silu_train_loss_and_grads_match_repro():
    from repro.parallel.act_sharding import use_activation_sharding as juse

    jcfg, tcfg, params, model = _bf16_models("tinyllama-1.1b")
    tree = jax.tree.map(np.asarray, jax.device_get(params))
    batch = _batch(tcfg)
    with juse(_jmesh(), bf16_silu=True):
        want_loss, want = _repro_value_and_grad(jcfg, tree, batch)
    with use_activation_sharding(make_host_mesh(device="cpu"), bf16_silu=True):
        got_loss, got = _port_value_and_grad(tcfg, model, batch)
    assert abs(got_loss - want_loss) <= BF16_LOSS_RTOL * abs(want_loss)
    for path, w in want.items():
        rel = float(np.linalg.norm(got[path] - w) / np.linalg.norm(w))
        assert rel < BF16_LEAF_TOL, (path, rel)


# --------------------------------------------------------------------------
# seq_parallel
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-7b", "command-r-plus-104b"])
def test_seq_parallel_changes_no_value(arch):
    """Loss, gradients and prefill logits bit-equal with and without SP,
    outside a counter and (but for the slow hybrid) under one counting real
    CPU tensors on a (2, 2) mesh, where the hooks act."""
    cfg = treg.get_config(arch).reduced()
    torch.manual_seed(0)
    model = lm_params_from_numpy(cfg, _np_params(arch), "cpu")
    batch = _batch(cfg)
    mesh = LMMesh(*MESH)
    runs = []
    modes = ((False, False), (True, False)) + (((True, True),) if arch != "zamba2-7b" else ())
    for sp, counted in modes:
        with use_activation_sharding(mesh, sp=sp, moe_shardmap=False), \
                (CostCounter(mesh) if counted else contextlib.nullcontext()):
            loss, grads = _port_value_and_grad(cfg, model, batch)
            with torch.no_grad():
                logits, _ = lm_prefill(model, cfg, init_cache(cfg, 2, 40, "cpu"),
                                       {"tokens": torch.from_numpy(batch["tokens"][:2])})
            runs.append((loss, grads, logits))
    for loss, grads, logits in runs[1:]:
        assert loss == runs[0][0]
        assert torch.equal(logits, runs[0][2])
        for k, g in grads.items():
            np.testing.assert_array_equal(g, runs[0][1][k])


def _np_params(arch):
    from repro.configs import registry as jreg
    from repro.models import init_lm as jinit_lm

    cfg = jreg.get_config(arch).reduced()
    return jax.tree.map(np.asarray, jax.device_get(
        jax.jit(jinit_lm, static_argnums=0)(cfg, jax.random.PRNGKey(0))))


def _rows(arch, shape_name, **kw):
    cfg, _, shape = _reduced(arch, shape_name)
    return [dryrun.dryrun_cell(arch, shape_name, "reduced", cfg=cfg, shape=shape,
                               mesh=LMMesh(*MESH), verbose=False, seq_parallel=sp, **kw)
            for sp in (False, True)]


def _same_counts(a, b) -> bool:
    keys = ("flops", "bytes", "collective_bytes", "collectives", "mem", "kernel_calls")
    return all(a[k] == b[k] for k in keys)


@pytest.mark.parametrize("arch", SP_ARCHS)
def test_seq_parallel_rows(arch):
    for shape_name in ("prefill_32k", "decode_32k"):
        off, on = _rows(arch, shape_name)
        assert _same_counts(off, on), shape_name
    off, on = _rows(arch, "train_4k")
    assert on["seq_parallel"] and not off["seq_parallel"]
    assert on["flops"] == off["flops"]
    dropped = _coll(off, "all-reduce")["bytes"] - _coll(on, "all-reduce")["bytes"]
    rs = _coll(on, "reduce-scatter")
    assert dropped > 0 and rs["bytes"] * 2 == dropped - PLAN_SHIFT.get(arch, 0)
    assert _coll(on, "all-gather")["bytes"] > 0
    assert on["mem"]["temp_gb"] <= off["mem"]["temp_gb"]


def _forward_counts(arch, sp: bool) -> CostCounter:
    """The reduced train cell's loss alone (no backward) counted on the
    (2, 2) mesh."""
    from repro_torch.configs.registry import input_specs
    from repro_torch.models import init_lm
    from repro_torch.models.common import MetaDraws
    from repro_torch.models.convert import lm_params_to_tree
    from repro_torch.parallel.sharding import batch_specs, param_specs

    cfg, _, shape = _reduced(arch, "train_4k")
    mesh = LMMesh(*MESH)
    with torch.device("meta"):
        model = init_lm(cfg, MetaDraws(), "meta")
    counter = CostCounter(mesh)
    p_specs = param_specs(lm_params_to_tree(model), cfg=cfg, mesh=mesh)
    counter.shard(dict(model.named_parameters()), dryrun._layer_specs(model, p_specs, mesh.shape))
    batch = input_specs(cfg, shape)
    counter.shard(batch, batch_specs(batch, mesh))
    with torch.no_grad(), use_activation_sharding(mesh, sp=sp, moe_shardmap=False), counter:
        lm_loss(model, cfg, batch)
    return counter


@pytest.mark.parametrize("arch", SERIAL_DENSE)
def test_seq_parallel_pairs_cost_what_they_replace(arch):
    """Serial dense blocks, L layers, W the per-rank bytes of the residual
    stream [B, S, d] whole: in the forward pass the 2L - 1 all-reduces the
    plan drops (the first block's attention output still meets the whole
    embedding) become 2L - 1 reduce-scatters, and the 2L - 2 gathers at
    the hooks plus the LM head's one gather make up the rest: the pairs
    cost exactly what the all-reduces cost. Over the step, the all-gathers
    are pinned: the forward's 2L - 1, one for each forward reduce-scatter's
    gradient and the first block's attention gradient (2L), the
    embedding's scatter (1) and the checkpointed loss's recomputation (1),
    each W / 2."""
    cfg, _, shape = _reduced(arch, "train_4k")
    off, on = _forward_counts(arch, False), _forward_counts(arch, True)
    ar = lambda c: c.collectives["all-reduce"]["bytes"]       # noqa: E731
    dropped = ar(off) - ar(on)
    w = shape.global_batch * shape.seq_len * cfg.d_model * 4 / 2
    layers = cfg.n_layers
    assert dropped == (2 * layers - 1) * w
    assert on.collectives["reduce-scatter"]["bytes"] + on.collectives["all-gather"]["bytes"] \
        == dropped
    assert on.flops == off.flops
    _, step_on = _rows(arch, "train_4k")
    assert _coll(step_on, "all-gather")["bytes"] == (4 * layers + 1) * w / 2


def test_seq_parallel_lowers_train_temp_on_the_production_mesh():
    """tinyllama-1.1b at full width (2 of its 22 layers) on the 16 x 16
    mesh at ``train_4k``: the FLOPs stay, ``temp_gb`` falls."""
    import dataclasses

    cfg = dataclasses.replace(treg.get_config("tinyllama-1.1b"), n_layers=2)
    rows = [dryrun.dryrun_cell("tinyllama-1.1b", "train_4k", "single", cfg=cfg, verbose=False,
                               seq_parallel=sp) for sp in (False, True)]
    assert rows[1]["flops"] == rows[0]["flops"]
    assert rows[1]["mem"]["temp_gb"] < rows[0]["mem"]["temp_gb"]
    assert _coll(rows[1], "reduce-scatter")["count"] > 0


# --------------------------------------------------------------------------
# `repro`'s SP and zero_dp=False lowerings on the (2, 2) mesh: a subprocess
# --------------------------------------------------------------------------
# a serial and a parallel dense block stack and the VLM train; the serving
# steps of a decoder and of the encoder-decoder
TRAIN_CASES = [(a, "train_4k") for a in ("tinyllama-1.1b", "command-r-plus-104b",
                                         "internvl2-1b")]
SP_CASES = TRAIN_CASES + [(a, s) for a in ("tinyllama-1.1b", "whisper-base")
                          for s in ("prefill_32k", "decode_32k")]


def _worker(out: str) -> int:
    assert jax.device_count() >= 4, f"needs 4 host devices, has {jax.device_count()}"
    rows = {}
    for a, s in SP_CASES:
        for sp in (False, True):
            rows[f"{a}/{s}/sp={sp}"] = _repro_costs(a, s, (2, 2), sp=sp)
    for a, s in TRAIN_CASES:
        rows[f"{a}/{s}/zero_dp=False"] = _repro_costs(a, s, (2, 2), zero_dp=False)
    with open(out, "w") as f:
        json.dump(rows, f)
    return 0


@pytest.fixture(scope="module")
def repro_switches(tmp_path_factory):
    out = tmp_path_factory.mktemp("repro_dryrun_switches") / "costs.json"
    env = dict(os.environ)
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_force_host_platform_device_count")]
    env["XLA_FLAGS"] = " ".join(flags + ["--xla_force_host_platform_device_count=4"])
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"), os.path.join(ROOT, "tests"),
                                         env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("arch,shape", SP_CASES)
def test_seq_parallel_against_repro(arch, shape, repro_switches):
    """Serving steps: unchanged by SP in `repro` (no hook in its prefill
    block; the decode block's token is one position) and in the port.
    Training: the FLOPs unchanged in both; the port's plan drops
    all-reduce bytes where XLA's keeps them and reshards besides (module
    docstring)."""
    off, on = repro_switches[f"{arch}/{shape}/sp=False"], repro_switches[f"{arch}/{shape}/sp=True"]
    assert on["flops"] == off["flops"]
    port = _rows(arch, shape)
    if shape != "train_4k":
        assert on == off
        assert _same_counts(*port)
        return
    assert port[1]["flops"] == port[0]["flops"]
    assert on["collectives"]["all-reduce"] >= off["collectives"]["all-reduce"]
    assert set(on["collectives"]) - {"all-reduce"}
    assert _coll(port[1], "all-reduce")["bytes"] < _coll(port[0], "all-reduce")["bytes"]


@pytest.mark.parametrize("arch,shape", TRAIN_CASES)
def test_zero_dp_false_arguments_match_repro_on_the_mesh(arch, shape, repro_switches):
    want = repro_switches[f"{arch}/{shape}/zero_dp=False"]["argument"]
    cfg, _, rshape = _reduced(arch, shape)
    counter, _, args, _ = dryrun.build_cell(cfg, rshape, LMMesh(*MESH), zero_dp=False)
    assert sum(counter.local_bytes(t) for t in args) == pytest.approx(want, abs=0.5)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "command-r-plus-104b"])
def test_zero_dp_false_arguments_match_repro_memory_analysis(arch):
    want = _repro_costs(arch, "train_4k", zero_dp=False)
    cfg, _, shape = _reduced(arch, "train_4k")
    row = dryrun.dryrun_cell(arch, "train_4k", "reduced", cfg=cfg, shape=shape,
                             mesh=LMMesh((1, 1), ("data", "model")), verbose=False, zero_dp=False)
    assert row["mem"]["argument_gb"] * 1e9 == pytest.approx(want["argument"], abs=0.5)
    assert row["zero_dp"] is False


@pytest.mark.parametrize("arch", treg.ARCHS)
def test_zero_dp_false_production_arguments_match_repro(arch):
    """Every runnable train cell of ``arch`` on both production meshes; with
    ZeRO-DP off a rank holds more optimizer state wherever a leaf was large
    enough to split."""
    for a, shape in treg.runnable_cells():
        if a != arch or tshapes.SHAPES[shape].kind != "train":
            continue
        for mesh_name in ("single", "multipod"):
            cells = [dryrun.build_cell(treg.get_config(arch), tshapes.SHAPES[shape],
                                       dryrun._mesh(mesh_name), zero_dp=z) for z in (True, False)]
            got = [sum(c.local_bytes(t) for t in args) for c, _, args, _ in cells]
            want = _repro_arguments(arch, shape, mesh_name, zero_dp=False)
            assert got[1] == pytest.approx(want, rel=1e-9), (arch, shape, mesh_name)
            assert got[1] > got[0]


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------
def test_cli_takes_the_switches(tmp_path, capsys):
    out = tmp_path / "rows.jsonl"
    dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k", "--mesh", "single",
                 "--seq-parallel", "--bf16-silu", "--out", str(out)])
    row = json.loads(out.read_text())
    assert row["status"] == "ok" and row["seq_parallel"] and row["bf16_silu"]
    assert row["zero_dp"] is True


def test_cli_all_resumes_keyed_on_seq_parallel(tmp_path, capsys, monkeypatch):
    from repro_torch.configs import registry

    monkeypatch.setattr(registry, "all_cells", lambda: [("whisper-base", "decode_32k", None),
                                                        ("whisper-base", "x", "skipped")])
    out = tmp_path / "rows.jsonl"
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--all", "--out", str(out)])
    assert done.value.code == 0
    with pytest.raises(SystemExit):
        dryrun.main(["--all", "--seq-parallel", "--out", str(out)])
    text = capsys.readouterr().out
    assert "done already" not in text and "SKIP whisper-base x x" in text
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["mesh"], r["seq_parallel"]) for r in rows] == [
        ("single", False), ("multipod", False), ("single", True), ("multipod", True)]
    with pytest.raises(SystemExit):
        dryrun.main(["--all", "--seq-parallel", "--out", str(out)])
    assert capsys.readouterr().out.count("done already") == 2
    assert len(out.read_text().splitlines()) == 4


def test_timeout_makes_a_failed_row(tmp_path, monkeypatch, capsys):
    def slow(*a, **k):
        time.sleep(5)

    monkeypatch.setattr(dryrun, "dryrun_cell", slow)
    t0 = time.monotonic()
    row = dryrun.run_cell("tinyllama-1.1b", "train_4k", "single", timeout=0.2,
                          seq_parallel=True)
    assert time.monotonic() - t0 < 2
    assert row["status"].startswith("FAILED TimeoutError") and row["seq_parallel"] is True
    out = tmp_path / "rows.jsonl"
    with pytest.raises(SystemExit) as failed:
        dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "train_4k", "--timeout", "0.2",
                     "--out", str(out)])
    assert failed.value.code == 1
    assert json.loads(out.read_text())["status"].startswith("FAILED TimeoutError")


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1]))
