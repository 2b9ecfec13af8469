"""The port's dry run on the CPU against `repro`'s.

  * The cell grid: `SHAPES`, `all_cells`, `runnable_cells`,
    `cell_skip_reason` and `reduced_shape` equal `repro`'s for all 40
    cells; `input_specs` gives `repro`'s keys, shapes and dtypes for every
    runnable cell (meta tensors where `repro` has ``ShapeDtypeStruct``s).
  * Counted costs (`repro_torch.parallel.cost_count` through
    `launch.dryrun.dryrun_cell`) against `repro`'s `analyze_compiled` on
    the same reduced step (the registry's ``reduced()`` archs: 2 layers,
    d 32-64; `reduced_shape`: batch 2, seq 32), `repro`'s step lowered
    and compiled as its dry run does by default (``seq_parallel=False``:
    ``sp=False`` is passed explicitly; the switches are
    ``tests/test_torch_dryrun_switches.py``'s):
      - FLOPs within 1 %. Prefill and decode with the kernels' plain
        versions in their meta routes' place (their dots are what `repro`'s
        XLA attention and scans compute), one device and a (data 2,
        model 2) mesh: the port's counts equal `repro`'s. The dry run's own
        count differs from that by K4's causal skip alone, pinned exactly.
        Training: the port's count plus `repro`'s attention recompute
        (its reduced configs checkpoint every 16 x 16 tile of the chunked
        attention, so the backward recomputes q.k twice and p.v once more:
        3 products of 2·B·Hq·S²·D a layer) for the dense archs.
      - bytes within a factor of 4 either way: eager PyTorch fuses nothing,
        XLA fuses elementwise chains (seen: 0.28-2.6).
      - argument bytes equal `repro`'s ``memory_analysis`` (one device).
      - collective bytes on the (2, 2) mesh within 1 %: prefill and decode
        all-reduces equal, training's within 1 % (`repro`'s step run in a
        subprocess under 4 forced host devices, this module as a program).
        Training's all-reduces: the port's count is 80-92 B (0.03 %) under
        XLA's (tinyllama-1.1b 296,792 against 296,884): XLA reduces the
        loss's per-chunk row statistics as 640 B where the port's
        ``logsumexp`` and target ``gather`` reduce 512, and its scalars
        (the loss, the token count, the clip norm) as 52 B against the
        port's 88. The embedding's gradient (a scatter-add into the
        vocab-split table) is summed over "data" at the table's per-rank
        size, as XLA does (16,384 B: the counter gives the gradient the
        table's split before it books the sum).
    Not compared, and why: `repro`'s rwkv6-3b prefill runs its chunked
    form (``_wkv_chunked``, other dot shapes; the scan is compared by
    choosing a chunk that does not divide the prompt); internvl2-1b's
    prefill in `repro`'s dry run sizes the cache without the patches
    (ROADMAP §3), so `repro` is given the port's cache size, and its
    prompt is cut to 24 tokens so that the 8 patches and the prompt fill
    whole 16-row tiles of `repro`'s reduced attention (a ragged tile is
    padded and its padding counted); the train
    step of the MoE, MLA, Mamba2, RWKV6, VLM and encoder-decoder archs
    differs from `repro`'s in its backward's recomputation and chunked
    forms; on the mesh, XLA's partitioner adds cache-write all-gathers to
    decode and resharding all-gathers, all-to-alls and permutes to
    training, and replicates MoE, MLA, Mamba2 and RWKV6 work that the
    counter's Megatron plan splits (their per-device FLOPs are not
    `repro`'s one-device count over 4), so only the all-reduces of the
    dense, VLM and encoder-decoder archs are compared (and the training
    FLOPs of the dense archs); whisper-base's decode arguments (XLA leaves
    out the encoder's parameters, which the decode step never reads).
  * The production meshes: every runnable cell's per-rank argument bytes
    (`build_cell`) equal `repro`'s from its own spec functions (what its
    jitted step takes as arguments). ``fits_hbm`` is compared where
    `repro`'s verdict is decided by its arguments alone (more than its 16
    GiB of HBM: deepseek-v2-236b); elsewhere `repro`'s verdict rests on
    XLA's temporaries from a full-size 256- or 512-device compile, which
    this CPU cannot hold.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import LMMesh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list(treg.ARCHS)
DENSE = ["tinyllama-1.1b", "command-r-plus-104b", "h2o-danube-3-4b", "stablelm-1.6b"]
MESH_ARCHS = DENSE + ["internvl2-1b", "whisper-base"]
FLOP_RTOL = 0.01
BYTES_FACTOR = 4.0
COLL_RTOL = 0.01
SCAN_BYTES_FACTOR = 1.25        # RWKV6's counted scan against the looped one (seen: 0.91-0.94)
TPU_HBM = 16 * 1024**3          # `repro`'s HBM_BYTES
UNUSED_DECODE_ARGS = {"whisper-base"}


def _reduced(arch: str, shape: str):
    """The port's and `repro`'s reduced configs and the reduced shape; an
    RWKV6 chunk that does not divide the prompt, so `repro` scans."""
    from repro.configs.registry import get_config

    changes = {"rwkv_chunk": 24} if arch == "rwkv6-3b" else {}
    cfg = treg.get_config(arch).reduced(**changes)
    # a VLM's patches and prompt fill whole 16-row tiles of `repro`'s
    # reduced attention, which pads a ragged last tile
    seq = 32 - cfg.n_patches if cfg.family == "vlm" else 32
    return cfg, get_config(arch).reduced(**changes), treg.reduced_shape(shape, seq=seq)


def _repro_costs(arch: str, shape_name: str, dims=(1, 1), *, sp: bool = False,
                 zero_dp: bool = True, bf16_silu: bool = False) -> dict:
    """`repro`'s dry-run lowering of the reduced cell on a (data, model)
    mesh of ``dims``, under its dry run's switches (``sp`` its
    ``seq_parallel``): `analyze_compiled` and `memory_analysis`."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs.registry import input_specs
    from repro.launch.mesh import make_mesh_compat
    from repro.models import init_cache, init_lm
    from repro.optim.adamw import OptConfig
    from repro.parallel import (analyze_compiled, batch_specs, cache_specs, param_specs,
                                zero_dp_specs)
    from repro.parallel.act_sharding import use_activation_sharding
    from repro.train.step import (init_train_state, make_decode_step, make_prefill_step,
                                  make_train_step)

    _, cfg, shape = _reduced(arch, shape_name)
    mesh = make_mesh_compat(dims, ("data", "model"))

    def named(t):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                            is_leaf=lambda x: isinstance(x, P))

    key = jax.ShapeDtypeStruct((2,), np.uint32)
    p_shape = jax.eval_shape(lambda k: init_lm(cfg, k), key)
    p_specs = param_specs(p_shape, cfg=cfg, mesh=mesh)
    b_in = input_specs(cfg, shape)
    with use_activation_sharding(mesh, enabled=True, sp=sp, bf16_silu=bf16_silu):
        if shape.kind == "train":
            opt = OptConfig()
            state = jax.eval_shape(lambda k: init_train_state(cfg, opt, k), key)
            z = zero_dp_specs(p_specs, p_shape, mesh) if zero_dp else p_specs
            s_specs = {"params": p_specs, "opt": {"master": z, "m": z, "v": z, "count": P()},
                       "step": P()}
            lowered = jax.jit(make_train_step(cfg, opt),
                              in_shardings=(named(s_specs), named(batch_specs(b_in, mesh))),
                              out_shardings=(named(s_specs), NamedSharding(mesh, P())),
                              donate_argnums=(0,)).lower(state, b_in)
        elif shape.kind == "prefill":
            # the port's cache size: a VLM's prefill writes its patches too
            s_max = shape.seq_len + (cfg.n_patches if cfg.family == "vlm" else 0)
            lowered = jax.jit(make_prefill_step(cfg, s_max),
                              in_shardings=(named(p_specs), named(batch_specs(b_in, mesh)))
                              ).lower(p_shape, b_in)
        else:
            cache = jax.eval_shape(lambda: init_cache(cfg, shape.global_batch, shape.seq_len))
            lowered = jax.jit(make_decode_step(cfg), in_shardings=(
                named(p_specs), named(cache_specs(cfg, cache, mesh)),
                named(batch_specs(b_in, mesh)["token"]))).lower(p_shape, cache, b_in["token"])
        compiled = lowered.compile()
    costs = analyze_compiled(compiled)
    mem = compiled.memory_analysis()
    return {"flops": costs.flops, "bytes": costs.bytes,
            "collectives": {k: v["bytes"] for k, v in costs.collectives.items()},
            "argument": mem.argument_size_in_bytes}


def _port_row(arch: str, shape_name: str, dims=(1, 1), *, plain: bool = False,
              monkeypatch=None, **switches) -> dict:
    """The port's dry-run row of the reduced cell under ``switches``
    (`dryrun_cell`'s); with ``plain`` the kernels' meta routes run their
    plain versions (on meta: nothing is allocated) and count those."""
    from repro_torch.kernels import ops

    cfg, _, shape = _reduced(arch, shape_name)
    if plain:
        route = ops._route
        monkeypatch.setattr(ops, "_route", lambda t, what, meta=False: (
            "cpu" if t.device.type == "meta" else route(t, what, meta=meta)))
    return dryrun.dryrun_cell(arch, shape_name, "reduced", cfg=cfg, shape=shape,
                              mesh=LMMesh(dims, ("data", "model")), verbose=False, **switches)


def _attention_recompute(cfg, shape) -> float:
    """`repro`'s extra training FLOPs over the port's in a dense arch: 3
    more products of 2·B·Hq·S²·D a layer (module docstring)."""
    b, s = shape.global_batch, shape.seq_len
    return 3 * 2 * b * cfg.n_heads * s * s * cfg.head_dim * cfg.n_layers


# --------------------------------------------------------------------------
# the cell grid
# --------------------------------------------------------------------------
def test_shapes_equal_repro():
    from repro.configs import shapes as jshapes

    assert tshapes.SHAPE_NAMES == jshapes.SHAPE_NAMES
    assert {k: dataclasses.astuple(v) for k, v in tshapes.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_grid_equals_repro(arch):
    from repro.configs import registry as jreg

    assert list(treg.ARCHS) == list(jreg.ARCHS)
    assert list(treg.all_cells()) == list(jreg.all_cells())
    assert treg.runnable_cells() == jreg.runnable_cells()
    for shape in tshapes.SHAPE_NAMES:
        assert treg.cell_skip_reason(arch, shape) == jreg.cell_skip_reason(arch, shape)
        for kw in ({}, {"seq": 48, "batch": 3}):
            assert dataclasses.astuple(treg.reduced_shape(shape, **kw)) == \
                dataclasses.astuple(jreg.reduced_shape(shape, **kw))
            assert dataclasses.astuple(treg.reduced_shape(tshapes.SHAPES[shape], **kw)) == \
                dataclasses.astuple(jreg.reduced_shape(shape, **kw))
    assert len(list(treg.all_cells())) == 40 and len(treg.runnable_cells()) == 33


@pytest.mark.parametrize("arch,shape", treg.runnable_cells())
def test_input_specs_match_repro(arch, shape):
    from repro.configs import registry as jreg

    got = treg.input_specs(treg.get_config(arch), shape)
    want = jreg.input_specs(jreg.get_config(arch), shape)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k
    with pytest.raises(ValueError):
        treg.input_specs(treg.get_config(arch), tshapes.ShapeSpec("x", 8, 2, "serve"))


# --------------------------------------------------------------------------
# counted costs against `repro`'s on reduced steps, one device
# --------------------------------------------------------------------------
SERVE_CASES = [(a, s) for a in ARCHS for s in ("prefill_32k", "decode_32k")]


@pytest.mark.parametrize("arch,shape", SERVE_CASES)
def test_serving_costs_match_repro(arch, shape, monkeypatch):
    want = _repro_costs(arch, shape)
    got = _port_row(arch, shape, plain=True, monkeypatch=monkeypatch)
    assert got["flops"] == pytest.approx(want["flops"], rel=FLOP_RTOL)
    assert 1 / BYTES_FACTOR <= got["bytes"] / want["bytes"] <= BYTES_FACTOR
    mem = got["mem"]["argument_gb"] * 1e9
    if shape == "decode_32k" and arch in UNUSED_DECODE_ARGS:
        assert mem > want["argument"]
    else:
        assert mem == pytest.approx(want["argument"], abs=0.5)


@pytest.mark.parametrize("arch", DENSE)
def test_train_costs_match_repro(arch):
    cfg, _, shape = _reduced(arch, "train_4k")
    want = _repro_costs(arch, "train_4k")
    got = _port_row(arch, "train_4k")
    assert got["flops"] + _attention_recompute(cfg, shape) == \
        pytest.approx(want["flops"], rel=FLOP_RTOL)
    assert 1 / BYTES_FACTOR <= got["bytes"] / want["bytes"] <= BYTES_FACTOR
    assert got["mem"]["argument_gb"] * 1e9 == pytest.approx(want["argument"], abs=0.5)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "h2o-danube-3-4b", "whisper-base"])
def test_kernel_routes_count_their_own_work(arch, monkeypatch):
    """The dry run's count is the plain versions' less what K4 skips: the
    (query, key) pairs the mask kills, 4·D FLOPs a pair and head; K5 counts
    the whole cache as its plain version does."""
    from repro_torch.kernels.flash_attention import attention_pairs

    cfg, _, shape = _reduced(arch, "prefill_32k")
    own = _port_row(arch, "prefill_32k")
    plain = _port_row(arch, "prefill_32k", plain=True, monkeypatch=monkeypatch)
    b, s, d = shape.global_batch, shape.seq_len, cfg.head_dim
    if cfg.family == "encdec":            # the decoder's causal self-attention only
        skipped = cfg.n_layers * 4 * d * b * cfg.n_heads * (
            s * s - attention_pairs(s, s, causal=True, window=None))
    else:
        skipped = cfg.n_layers * 4 * d * b * cfg.n_heads * (
            s * s - attention_pairs(s, s, causal=True, window=cfg.window))
    assert plain["flops"] - own["flops"] == skipped
    monkeypatch.undo()
    assert _port_row(arch, "decode_32k")["flops"] == \
        _port_row(arch, "decode_32k", plain=True, monkeypatch=monkeypatch)["flops"]


# --------------------------------------------------------------------------
# the (data 2, model 2) mesh: `repro` in a subprocess under 4 host devices
# --------------------------------------------------------------------------
MESH_CASES = [(a, s) for a in MESH_ARCHS for s in ("prefill_32k", "decode_32k", "train_4k")
              if not (s == "train_4k" and a == "whisper-base")]


def _worker(out: str) -> int:
    assert jax.device_count() >= 4, f"needs 4 host devices, has {jax.device_count()}"
    rows = {f"{a}/{s}": _repro_costs(a, s, (2, 2)) for a, s in MESH_CASES}
    with open(out, "w") as f:
        json.dump(rows, f)
    return 0


@pytest.fixture(scope="module")
def repro_mesh(tmp_path_factory):
    out = tmp_path_factory.mktemp("repro_dryrun_mesh") / "costs.json"
    env = dict(os.environ)
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_force_host_platform_device_count")]
    env["XLA_FLAGS"] = " ".join(flags + ["--xla_force_host_platform_device_count=4"])
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("arch,shape", MESH_CASES)
def test_mesh_costs_match_repro(arch, shape, repro_mesh, monkeypatch):
    want = repro_mesh[f"{arch}/{shape}"]
    plain = shape != "train_4k"
    got = _port_row(arch, shape, (2, 2), plain=plain, monkeypatch=monkeypatch)
    cfg, _, rshape = _reduced(arch, shape)
    if shape != "train_4k":
        assert got["flops"] == pytest.approx(want["flops"], rel=FLOP_RTOL)
    elif arch in DENSE:
        assert got["flops"] + _attention_recompute(cfg, rshape) / 4 == \
            pytest.approx(want["flops"], rel=FLOP_RTOL)
    all_reduce = (got["collectives"] or {}).get("all-reduce", {}).get("bytes", 0.0)
    assert all_reduce == pytest.approx(want["collectives"]["all-reduce"], rel=COLL_RTOL)
    if shape == "prefill_32k":          # XLA issues nothing but the all-reduces
        assert got["collective_bytes"] == pytest.approx(sum(want["collectives"].values()),
                                                        rel=COLL_RTOL)


def test_kv_heads_below_the_model_axis(monkeypatch):
    """8 q heads over 2 KV heads on 4 model ranks: the specs replicate the
    K and V projections (2 heads do not split 4 ways) and split the q
    heads, so a rank does all of the K and V products and a quarter of
    everything else; the attention's heads, viewed as [KV head, group],
    carry the model axis cut into parts (2 x 2)."""
    from repro_torch.configs.registry import get_config

    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(), n_heads=8, n_kv=2,
                              d_model=128)
    shape = treg.reduced_shape("prefill_32k")
    from repro_torch.kernels import ops

    route = ops._route
    monkeypatch.setattr(ops, "_route", lambda t, what, meta=False: (
        "cpu" if t.device.type == "meta" else route(t, what, meta=meta)))
    rows = [dryrun.dryrun_cell("x", "prefill_32k", "reduced", cfg=cfg, shape=shape,
                               mesh=LMMesh(dims, ("data", "model")), verbose=False)
            for dims in ((1, 1), (1, 4))]
    tokens = shape.global_batch * shape.seq_len
    kv = 2 * tokens * cfg.d_model * 2 * cfg.n_kv * cfg.head_dim * cfg.n_layers
    assert rows[1]["flops"] == (rows[0]["flops"] - kv) / 4 + kv


def test_counted_scan_matches_the_looped_scan():
    """RWKV6's training scan on meta counts one token's step S times over
    (`cost_count.repeat`): within 1 % of the FLOPs of the port's scan run
    token by token (`rwkv6.looped_scan`) and its bytes within
    SCAN_BYTES_FACTOR, its collectives once. At 128 tokens a loop whose
    backward writes a whole-sequence gradient a token (S^2 bytes) is
    beyond that factor."""
    from repro_torch.models import rwkv6

    cfg, _, _ = _reduced("rwkv6-3b", "train_4k")
    shape = treg.reduced_shape("train_4k", seq=128)
    mesh = LMMesh((2, 2), ("data", "model"))
    counted = dryrun.dryrun_cell("x", "train_4k", "reduced", cfg=cfg, shape=shape, mesh=mesh,
                                 verbose=False)
    apply = rwkv6._CountedScan.apply
    try:
        rwkv6._CountedScan.apply = rwkv6.looped_scan
        looped = dryrun.dryrun_cell("x", "train_4k", "reduced", cfg=cfg, shape=shape,
                                    mesh=mesh, verbose=False)
    finally:
        rwkv6._CountedScan.apply = apply
    assert counted["flops"] == pytest.approx(looped["flops"], rel=FLOP_RTOL)
    assert 1 / SCAN_BYTES_FACTOR <= counted["bytes"] / looped["bytes"] <= SCAN_BYTES_FACTOR
    assert counted["collectives"]["all-reduce"]["count"] <= \
        looped["collectives"]["all-reduce"]["count"]


def test_scan_step_grads_match_autograd():
    from repro_torch.models.rwkv6 import _scan_step, _scan_step_grads

    g = torch.Generator().manual_seed(0)
    b, h, n = 2, 3, 5
    xs = [torch.randn(b, h, n, generator=g, dtype=torch.float64) for _ in range(4)]
    u = torch.randn(h, n, generator=g, dtype=torch.float64)
    state = torch.randn(b, h, n, n, generator=g, dtype=torch.float64)
    gy = torch.randn(b, h, n, generator=g, dtype=torch.float64)
    gnext = torch.randn(b, h, n, n, generator=g, dtype=torch.float64)
    leaves = [x.clone().requires_grad_() for x in xs + [u, state]]
    y, nxt = _scan_step(*leaves)
    want = torch.autograd.grad((y, nxt), leaves, (gy, gnext))
    for got, w in zip(_scan_step_grads(*xs, u, state, gy, gnext), want):
        torch.testing.assert_close(got, w)


def test_collectives_report_through_the_hook():
    """`collectives.count_collective` reaches the counter counting on this
    thread, once each even inside `repeat`, and nothing otherwise; a
    collective over axes of one rank is not counted."""
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.cost_count import CostCounter, repeat

    C.count_collective("all-reduce", 64)
    with CostCounter(LMMesh((2, 1), ("data", "model"))) as c:
        C.count_collective("all-reduce", 128, ("data",))
        with repeat(5):
            C.count_collective("all-reduce", 36, ("data",))
        C.count_collective("all-gather", 12)
        C.count_collective("all-reduce", 99, ("model",))
    C.count_collective("all-reduce", 64)
    assert c.collectives["all-reduce"] == {"count": 2, "bytes": 128 + 36}
    assert c.collectives["all-gather"] == {"count": 1, "bytes": 12}
    assert c.collective_bytes == 128 + 36 + 12


def test_partitioner_kernels_raise_on_meta():
    from repro_torch.kernels import ops

    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.la_update(x, x, x, 0.1, 0.1)


# --------------------------------------------------------------------------
# the production meshes
# --------------------------------------------------------------------------
def _repro_arguments(arch: str, shape_name: str, mesh_name: str, *,
                     zero_dp: bool = True) -> float:
    """Per-device bytes of `repro`'s dry-run step's arguments, from its spec
    functions: each leaf's bytes over the mesh sizes its spec splits it by."""
    from jax.sharding import PartitionSpec as P

    from repro.configs.registry import get_config, input_specs
    from repro.configs.shapes import SHAPES
    from repro.models import init_cache, init_lm
    from repro.optim.adamw import OptConfig
    from repro.parallel import batch_specs, cache_specs, param_specs, zero_dp_specs
    from repro.train.step import init_train_state

    cfg, shape = get_config(arch), SHAPES[shape_name]
    # `repro`'s spec functions read a mesh's axis names and sizes only
    sizes = {"pod": 2, "data": 16, "model": 16} if mesh_name == "multipod" else \
        {"data": 16, "model": 16}
    mesh = SimpleNamespace(shape=sizes, axis_names=tuple(sizes))

    def local(tree, specs):
        leaves = jax.tree.leaves(tree)
        spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
        total = 0.0
        for x, spec in zip(leaves, spec_leaves):
            f = math.prod(sizes[a] for part in spec if part is not None
                          for a in (part if isinstance(part, tuple) else (part,)))
            total += math.prod(x.shape) * x.dtype.itemsize / f
        return total

    key = jax.ShapeDtypeStruct((2,), np.uint32)
    p_shape = jax.eval_shape(lambda k: init_lm(cfg, k), key)
    p_specs = param_specs(p_shape, cfg=cfg, mesh=mesh)
    b_in = input_specs(cfg, shape)
    total = local(b_in, batch_specs(b_in, mesh)) + local(p_shape, p_specs)
    if shape.kind == "train":
        state = jax.eval_shape(lambda k: init_train_state(cfg, OptConfig(), k), key)
        z = zero_dp_specs(p_specs, p_shape, mesh) if zero_dp else p_specs
        for k in ("master", "m", "v"):
            total += local(state["opt"][k], z)
        total += 4 + 4                                    # count, step
    elif shape.kind == "decode":
        cache = jax.eval_shape(lambda: init_cache(cfg, shape.global_batch, shape.seq_len))
        total += local(cache, cache_specs(cfg, cache, mesh))
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_production_arguments_match_repro(arch):
    for a, shape in treg.runnable_cells():
        if a != arch:
            continue
        for mesh_name in ("single", "multipod"):
            counter, _, args, _ = dryrun.build_cell(
                treg.get_config(arch), tshapes.SHAPES[shape], dryrun._mesh(mesh_name))
            got = sum(counter.local_bytes(t) for t in args)
            want = _repro_arguments(arch, shape, mesh_name)
            assert got == pytest.approx(want, rel=1e-9), (arch, shape, mesh_name)


@pytest.mark.parametrize("shape,mesh_name", [("decode_32k", "single"),
                                             ("decode_32k", "multipod"),
                                             ("prefill_32k", "single")])
def test_fits_hbm_reproduces_repro_where_arguments_decide(shape, mesh_name):
    arch = "deepseek-v2-236b"
    assert _repro_arguments(arch, shape, mesh_name) > TPU_HBM    # `repro`: does not fit
    row = dryrun.dryrun_cell(arch, shape, mesh_name, verbose=False)
    assert sum(row["mem"].values()) * 1e9 > TPU_HBM       # the port: does not fit either
    assert row["mem"]["argument_gb"] * 1e9 > TPU_HBM
    for k in ("compute_s", "memory_s", "collective_s", "bottleneck", "flops", "bytes"):
        assert k in row
    assert row["provenance"]["schema_version"] == 2


def test_indivisible_cell_raises(monkeypatch):
    """A spec that does not divide its leaf raises (`validate_specs`), as in
    `repro`; the rules' own specs always divide (they drop what does not),
    so a rule is replaced by one that does not."""
    from repro_torch.parallel import sharding

    rules = sharding.param_specs

    def bad(tree, **kw):
        specs = rules(tree, **kw)
        specs["embed"]["emb"] = sharding.P(("data", "model"), None)
        return specs

    monkeypatch.setattr(sharding, "param_specs", bad)
    cfg = dataclasses.replace(treg.get_config("tinyllama-1.1b").reduced(), vocab=126)
    with pytest.raises(ValueError, match="indivisible param shardings"):
        dryrun.build_cell(cfg, treg.reduced_shape("decode_32k"), LMMesh((2, 2), ("data", "model")))


def test_cli_single_cell_writes_a_row(tmp_path, capsys):
    out = tmp_path / "rows.jsonl"
    dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k", "--mesh", "single",
                 "--out", str(out)])
    row = json.loads(out.read_text())
    assert row["status"] == "ok" and row["chips"] == 256 and row["fits_hbm"] is True
    assert "roofline:" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        dryrun.main(["--seq-parallel"])


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1]))
