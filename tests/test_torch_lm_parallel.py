"""The port's LM parallelism on the CPU against `repro`, from the same
parameters and inputs (made with numpy and handed to both packages).

  * The sharding rules (`repro_torch.parallel.sharding`): `param_specs`
    (plain and ``moe_ep2d``), `cache_specs`, `batch_specs`, `zero_dp_specs`
    and `validate_specs` equal to `repro`'s, leaf by leaf, for all ten archs
    at full size on the production meshes (16, 16) and (2, 16, 16); the
    port's parameter trees come from a fake-tensor init (`param_shapes`),
    its caches from the meta device. `shard_tree` / `unshard_tree` round
    trip bit-equal, the shards views on one device.
  * The expert-parallel MoE paths (`repro_torch.models.moe`): the port's
    ``_apply_moe_shardmap`` on (data 2, model 2) and ``_apply_moe_ep2d`` on
    (pod 2, data 2, model 2), each over a repeated-CPU `LMMesh`, against
    `repro`'s own, which run in a subprocess under 8 forced host devices
    (this module run as a program; the device count is fixed when JAX's
    backend starts, as tests/test_system.py does): outputs and the
    gradients of every parameter and of the input, at capacity factor 8.0
    and at 1.25, where the per-rank capacities decide the drops. Then the
    dispatch selection.
  * The collectives: `lse_combine`, `sharded_decode_attention` (through
    K5's plain version) and `ef_int8_psum` against `repro`'s under
    ``jax.vmap(..., axis_name=...)``, where ``pmax`` and ``psum`` are
    defined; the mesh context thread-local and nesting; the roofline's
    `param_counts` for all ten archs and `model_flops` for train, prefill
    and decode.

Tolerances: f32 1e-5 for outputs and 1e-4 for gradients (the two
frameworks sum in different orders; the port's psum runs in f64 and the
combine sums a token's K outputs where `repro` scatter-adds them);
``ATTN_TOL`` f32 (1e-4) for the sharded flash-decode; the int8 codes and
scales exactly.
"""
import functools
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
ATTN_TOL = dict(atol=1e-4, rtol=1e-4)
CPU = torch.device("cpu")

# (name, mesh shape, axes, capacity factor); x [4, 64, 32], 8 experts top 2
MOE_CASES = [
    ("shardmap-8.0", (2, 2), ("data", "model"), 8.0),
    ("shardmap-1.25", (2, 2), ("data", "model"), 1.25),
    ("ep2d-8.0", (2, 2, 2), ("pod", "data", "model"), 8.0),
    ("ep2d-1.25", (2, 2, 2), ("pod", "data", "model"), 1.25),
]
MOE_SPEC = dict(d_model=32, n_experts=8, top_k=2, d_ff_expert=64, n_shared=1)
X_SHAPE = (4, 64, 32)


def _moe_inputs(seed: int = 0) -> dict:
    """`repro`'s MoE parameters (its init's scales) and an input, as numpy."""
    rng = np.random.default_rng(seed)
    d, e, f = MOE_SPEC["d_model"], MOE_SPEC["n_experts"], MOE_SPEC["d_ff_expert"]
    fs = f * MOE_SPEC["n_shared"]
    n = lambda *s, scale: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    # inputs off-centre: the experts' mean logits differ, the loads skew,
    # and capacity 1.25 drops
    return {"router_w": n(d, e, scale=d ** -0.5), "w_gate": n(e, d, f, scale=d ** -0.5),
            "w_up": n(e, d, f, scale=d ** -0.5), "w_down": n(e, f, d, scale=f ** -0.5),
            "s_gate": n(d, fs, scale=d ** -0.5), "s_up": n(d, fs, scale=d ** -0.5),
            "s_down": n(fs, d, scale=fs ** -0.5), "x": n(*X_SHAPE, scale=1.0) + 0.5}


def _jax_params(a: dict) -> dict:
    return {"router": {"w": jnp.asarray(a["router_w"])}, "w_gate": jnp.asarray(a["w_gate"]),
            "w_up": jnp.asarray(a["w_up"]), "w_down": jnp.asarray(a["w_down"]),
            "shared": {"w_gate": {"w": jnp.asarray(a["s_gate"])},
                       "w_up": {"w": jnp.asarray(a["s_up"])},
                       "w_down": {"w": jnp.asarray(a["s_down"])}}}


# --------------------------------------------------------------------------
# `repro`'s mesh paths, in a subprocess under 8 forced host devices
# --------------------------------------------------------------------------
def _worker(out_dir: str) -> int:
    import repro.models.moe as M

    assert jax.device_count() >= 8, f"needs 8 host devices, has {jax.device_count()}"
    a = _moe_inputs()
    p, x = _jax_params(a), jnp.asarray(a["x"])
    for name, shape, axes, cf in MOE_CASES:
        spec = M.MoESpec(**MOE_SPEC, capacity_factor=cf)
        mesh = jax.make_mesh(shape, axes, axis_types=(jax.sharding.AxisType.Auto,) * len(axes))
        fn = M._apply_moe_ep2d if "pod" in axes else M._apply_moe_shardmap
        with jax.set_mesh(mesh):
            y = jax.jit(lambda p, x: fn(p, x, spec, mesh))(p, x)
            gp, gx = jax.jit(jax.grad(lambda p, x: (fn(p, x, spec, mesh) * x).sum(),
                                      argnums=(0, 1)))(p, x)
        np.savez(os.path.join(out_dir, name + ".npz"), y=np.asarray(y), gx=np.asarray(gx),
                 **{"g_" + "/".join(str(k.key) for k in path): np.asarray(v)
                    for path, v in jax.tree_util.tree_flatten_with_path(gp)[0]})
    return 0


@pytest.fixture(scope="module")
def jax_moe(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_moe_mesh")
    env = dict(os.environ)
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_force_host_platform_device_count")]
    env["XLA_FLAGS"] = " ".join(flags + ["--xla_force_host_platform_device_count=8"])
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return out


def _port_moe(a: dict, requires_grad: bool = False):
    """The port's MoE from `_moe_inputs`, and its tensors by input name (the
    module's parameters and ``x``)."""
    from repro_torch.models import moe as tmoe
    from repro_torch.models.common import Dense
    from repro_torch.models.mlp import MLP

    t = {k: torch.from_numpy(v.copy()) for k, v in a.items()}
    shared = MLP("swiglu", w_gate=Dense(t["s_gate"]), w_up=Dense(t["s_up"]),
                 w_down=Dense(t["s_down"]))
    m = tmoe.MoE(Dense(t["router_w"]), t["w_gate"], t["w_up"], t["w_down"], shared)
    m.requires_grad_(requires_grad)
    named = {"router_w": m.router.w, "w_gate": m.w_gate, "w_up": m.w_up, "w_down": m.w_down,
             "s_gate": shared.w_gate.w, "s_up": shared.w_up.w, "s_down": shared.w_down.w,
             "x": t["x"].requires_grad_(requires_grad)}
    return m, named


GRAD_NAMES = {"router/w": "router_w", "w_gate": "w_gate", "w_up": "w_up", "w_down": "w_down",
              "shared/w_gate/w": "s_gate", "shared/w_up/w": "s_up", "shared/w_down/w": "s_down"}


@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_mesh_paths_match_repro_outputs_and_gradients(jax_moe, case):
    from repro_torch.launch.mesh import LMMesh
    from repro_torch.models import moe as tmoe
    from repro_torch.parallel.act_sharding import use_activation_sharding

    name, shape, axes, cf = case
    with np.load(os.path.join(jax_moe, name + ".npz")) as z:
        want = dict(z)
    a = _moe_inputs()
    spec = tmoe.MoESpec(**MOE_SPEC, capacity_factor=cf)
    mesh = LMMesh(shape, axes, [CPU] * int(np.prod(shape)))
    moe, t = _port_moe(a, requires_grad=True)
    with use_activation_sharding(mesh, moe_ep2d="pod" in axes), \
            tmoe.record_dispatch() as rec:
        y = tmoe.apply_moe(moe, t["x"], spec)
    assert [r["path"] for r in rec] == ["ep2d" if "pod" in axes else "shardmap"]
    torch.testing.assert_close(y.detach(), torch.from_numpy(want["y"]), **MOE_TOL)
    (y * t["x"]).sum().backward()
    torch.testing.assert_close(t["x"].grad, torch.from_numpy(want["gx"]), **GRAD_TOL)
    for jname, tname in GRAD_NAMES.items():
        torch.testing.assert_close(t[tname].grad, torch.from_numpy(want["g_" + jname]),
                                   **GRAD_TOL, msg=lambda m, n=jname: f"{n}: {m}")
    dropped = int(rec[0]["dropped"])
    if cf < 2:   # the per-rank capacities bind: drops happen, and they change the output
        assert dropped > 0
        local = tmoe.apply_moe(moe, t["x"], tmoe.MoESpec(**MOE_SPEC, capacity_factor=8.0))
        assert float((local - y).detach().abs().max()) > 1e-3
    else:
        assert dropped == 0


def test_shardmap_drops_equal_the_local_paths_at_one_data_rank():
    """With data = 1 every model rank sees every token and sizes its
    capacity from all of them, so the ranks drop exactly the pairs the
    single-device path drops, and the outputs agree."""
    from repro_torch.launch.mesh import LMMesh
    from repro_torch.models import moe as tmoe
    from repro_torch.parallel.act_sharding import use_activation_sharding

    a = _moe_inputs(3)
    moe, t = _port_moe(a)
    spec = tmoe.MoESpec(**MOE_SPEC, capacity_factor=0.75)
    with tmoe.record_dispatch() as rec:
        y_local = tmoe.apply_moe(moe, t["x"], spec)
        with use_activation_sharding(LMMesh((1, 4), ("data", "model"), [CPU] * 4)):
            y_ep = tmoe.apply_moe(moe, t["x"], spec)
    assert [r["path"] for r in rec] == ["local", "shardmap"]
    assert int(rec[0]["dropped"]) == int(rec[1]["dropped"]) > 0
    torch.testing.assert_close(y_ep, y_local, **MOE_TOL)


@pytest.mark.parametrize("shape,axes,kw,want", [
    ((2, 2), ("data", "model"), {}, "shardmap"),
    ((2, 2, 2), ("pod", "data", "model"), {"moe_ep2d": True}, "ep2d"),
    ((2, 2, 2), ("pod", "data", "model"), {}, "shardmap"),        # no ep2d switch
    ((4, 1), ("data", "model"), {}, "local"),                       # model 1
    ((1, 3), ("data", "model"), {}, "local"),                       # 8 experts % 3
    ((1, 2), ("data", "model"), {"moe_shardmap": False}, "local"),
    ((2, 1, 3), ("pod", "data", "model"), {"moe_ep2d": True}, "local"),   # 8 % 6
])
def test_dispatch_selection_is_repros(shape, axes, kw, want):
    from repro_torch.launch.mesh import LMMesh
    from repro_torch.models import moe as tmoe
    from repro_torch.parallel.act_sharding import use_activation_sharding

    moe, t = _port_moe(_moe_inputs(1))
    spec = tmoe.MoESpec(**MOE_SPEC, capacity_factor=8.0)
    x = t["x"]
    mesh = LMMesh(shape, axes, [CPU] * int(np.prod(shape)))
    with use_activation_sharding(mesh, **kw), tmoe.record_dispatch() as rec:
        y = tmoe.apply_moe(moe, x, spec)
        tmoe.apply_moe(moe, x, spec, return_stats=True)      # stats: always local
    assert [r["path"] for r in rec] == [want, "local"]
    torch.testing.assert_close(y, tmoe.moe_ref(moe, x, spec), **MOE_TOL)


def test_dispatch_local_matches_repros():
    import repro.models.moe as M
    from repro_torch.models import moe as tmoe

    a = _moe_inputs(2)
    rng = np.random.default_rng(5)
    x2 = a["x"].reshape(-1, 32)[:96]
    flat_e = rng.integers(-1, 4, 96).astype(np.int32)       # -1 and 2, 3: not this rank's
    flat_w = rng.random(96).astype(np.float32)
    wg, wu, wd = a["w_gate"][:2], a["w_up"][:2], a["w_down"][:2]
    want = M._dispatch_local(jnp.asarray(x2), jnp.asarray(flat_e), jnp.asarray(flat_w), 2, 16,
                             jnp.asarray(wg), jnp.asarray(wu), jnp.asarray(wd), jnp.float32)
    t = lambda v: torch.from_numpy(v)                       # noqa: E731
    got, dropped = tmoe._dispatch_local(t(x2), t(flat_e), t(flat_w), 2, 16, t(wg), t(wu), t(wd),
                                        torch.float32, return_dropped=True)
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), **MOE_TOL)
    counts = np.bincount(flat_e[(flat_e >= 0) & (flat_e < 2)], minlength=2)
    assert int(dropped) == int(np.maximum(counts - 16, 0).sum()) > 0


# --------------------------------------------------------------------------
# sharding rules, all ten archs, full size
# --------------------------------------------------------------------------
class FakeMesh:
    """Spec-validation stand-in of `repro`'s tests (no devices)."""

    def __init__(self, shape_map):
        self.shape = shape_map
        self.axis_names = tuple(shape_map)


def _archs():
    from repro.configs.registry import ARCHS
    return sorted(ARCHS)


@functools.lru_cache(maxsize=None)
def _shapes(arch: str):
    from repro.configs.registry import get_config as jget
    from repro.models import init_lm as jinit_lm
    from repro_torch.configs.registry import get_config
    from repro_torch.parallel.sharding import param_shapes

    jshapes = jax.eval_shape(lambda k: jinit_lm(jget(arch), k),
                             jax.ShapeDtypeStruct((2,), np.uint32))
    return jshapes, param_shapes(get_config(arch))


def _flat_jax(tree) -> dict:
    def key(path):
        return "/".join(str(k.key) if hasattr(k, "key") else str(k.idx) for k in path)
    return {key(p): v for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree) -> dict:
    from repro_torch.parallel.sharding import tree_map_with_path
    out = {}
    tree_map_with_path(lambda p, v: out.__setitem__("/".join(map(str, p)), v), tree)
    return out


def _same_specs(jspecs, tspecs) -> None:
    j, t = _flat_jax(jspecs), _flat_port(tspecs)
    assert set(j) == set(t)
    bad = {k: (tuple(j[k]), tuple(t[k])) for k in j if tuple(j[k]) != tuple(t[k])}
    assert not bad, bad


MESHES = {"single-pod": {"data": 16, "model": 16}, "multi-pod": {"pod": 2, "data": 16, "model": 16}}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", _archs())
def test_param_specs_match_repros_for_all_archs(arch, mesh_name):
    from repro.configs.registry import get_config as jget
    from repro.parallel import sharding as js
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel import sharding as ts

    jshapes, tshapes = _shapes(arch)
    assert {k: tuple(v.shape) for k, v in _flat_jax(jshapes).items()} == \
        {k: tuple(v.shape) for k, v in _flat_port(tshapes).items()}
    jmesh = FakeMesh(MESHES[mesh_name])
    tmesh = make_production_mesh(multi_pod=mesh_name == "multi-pod")
    assert tmesh.shape == jmesh.shape and tmesh.axis_names == jmesh.axis_names
    if mesh_name == "single-pod" and jget(arch).moe:   # EP2D storage names "pod"
        with pytest.raises(KeyError, match="pod"):
            js.param_specs(jshapes, cfg=jget(arch), mesh=jmesh, moe_ep2d=True)
        with pytest.raises(KeyError, match="pod"):
            ts.param_specs(tshapes, cfg=get_config(arch), mesh=tmesh, moe_ep2d=True)
    for ep2d in (False, True) if mesh_name == "multi-pod" else (False,):
        jspecs = js.param_specs(jshapes, cfg=jget(arch), mesh=jmesh, moe_ep2d=ep2d)
        tspecs = ts.param_specs(tshapes, cfg=get_config(arch), mesh=tmesh, moe_ep2d=ep2d)
        _same_specs(jspecs, tspecs)
        assert ts.validate_specs(tspecs, tshapes, tmesh) == \
            js.validate_specs(jspecs, jshapes, jmesh) == []
        _same_specs(js.zero_dp_specs(jspecs, jshapes, jmesh),
                    ts.zero_dp_specs(tspecs, tshapes, tmesh))
    # no mesh: the base rules alone
    _same_specs(js.param_specs(jshapes), ts.param_specs(tshapes))


@pytest.mark.parametrize("arch", _archs())
def test_cache_and_batch_specs_match_repros_for_all_archs(arch):
    from repro.configs.registry import get_config as jget
    from repro.models import init_cache as jinit_cache
    from repro.parallel import sharding as js
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import init_cache
    from repro_torch.parallel import sharding as ts

    cfg, jcfg = get_config(arch), jget(arch)
    for mesh_name in sorted(MESHES):
        jmesh = FakeMesh(MESHES[mesh_name])
        tmesh = make_production_mesh(multi_pod=mesh_name == "multi-pod")
        for batch, s_max in ((128, 1024), (1, 32768), (48, 4096)):
            jcache = jax.eval_shape(lambda: jinit_cache(jcfg, batch, s_max))
            tcache = init_cache(cfg, batch, s_max, "meta")
            assert {k: tuple(v.shape) for k, v in _flat_jax(jcache).items()} == \
                {k: tuple(v.shape) for k, v in _flat_port(tcache).items()}
            _same_specs(js.cache_specs(jcfg, jcache, jmesh), ts.cache_specs(cfg, tcache, tmesh))
            batch_tree = {"tokens": torch.empty((batch, 128), device="meta"),
                          "token": torch.empty((batch,), device="meta"),
                          "labels": torch.empty((batch, 128), device="meta")}
            jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.int32)
                      for k, v in batch_tree.items()}
            _same_specs(js.batch_specs(jbatch, jmesh), ts.batch_specs(batch_tree, tmesh))


def test_validate_specs_names_the_leaves_repro_names():
    from jax.sharding import PartitionSpec as JP
    from repro.parallel import sharding as js
    from repro_torch.parallel import sharding as ts

    shapes = {"a": {"w": (30, 32)}, "b": [(64,), (17, 3)]}
    jshapes = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32), shapes,
                           is_leaf=lambda x: isinstance(x, tuple) and isinstance(x[0], int))
    tshapes = {"a": {"w": torch.empty(30, 32, device="meta")},
               "b": [torch.empty(64, device="meta"), torch.empty(17, 3, device="meta")]}
    mesh = FakeMesh({"data": 4, "model": 8})
    jspecs = {"a": {"w": JP("data", "model")}, "b": [JP(("data", "model")), JP("model", None)]}
    tspecs = {"a": {"w": ts.P("data", "model")},
              "b": [ts.P(("data", "model")), ts.P("model", None)]}
    names = lambda bad: [b.split(":")[0] for b in bad]      # noqa: E731
    assert names(ts.validate_specs(tspecs, tshapes, mesh)) == \
        names(js.validate_specs(jspecs, jshapes, mesh)) == ["a/w", "b/1"]


def test_spec_type_compares_equal_to_partition_spec():
    from jax.sharding import PartitionSpec as JP
    from repro_torch.parallel.sharding import P

    for entries in [(None, "model"), (("data",), None), (("pod", "data"), None, "model"), ()]:
        assert tuple(P(*entries)) == tuple(JP(*entries))
    assert P(("data",)) == P("data") and P("data") != P("model")


# --------------------------------------------------------------------------
# shards
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape,axes", [((2, 2), ("data", "model")),
                                        ((2, 2, 2), ("pod", "data", "model"))])
def test_shard_tree_round_trip_is_bit_equal_and_shards_are_views(shape, axes):
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import LMMesh
    from repro_torch.models import init_cache, init_lm
    from repro_torch.models.convert import lm_params_to_tree
    from repro_torch.parallel import sharding as ts

    cfg = get_config("deepseek-v2-lite-16b").reduced()
    mesh = LMMesh(shape, axes, [CPU] * int(np.prod(shape)))
    model = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    tree = lm_params_to_tree(model)
    cache = init_cache(cfg, 4, 32, "cpu")
    cache["main"][0].normal_(generator=torch.Generator().manual_seed(1))
    for t, specs in ((tree, ts.param_specs(tree, cfg=cfg, mesh=mesh, moe_ep2d="pod" in axes)),
                     (cache, ts.cache_specs(cfg, cache, mesh))):
        shards = ts.shard_tree(t, specs, mesh)
        assert len(shards) == mesh.n_ranks
        n_split = 0
        for path, leaf in _flat_port(t).items():
            spec = _flat_port(specs)[path]
            for r in range(mesh.n_ranks):
                piece = _flat_port(shards[r])[path]
                assert piece.untyped_storage().data_ptr() == leaf.untyped_storage().data_ptr()
                n_split += piece.numel() < leaf.numel()
            want = [leaf.shape[ax] // (1 if s is None else ts._size(mesh, s))
                    for ax, s in enumerate(tuple(spec) + (None,) * (leaf.ndim - len(spec)))]
            assert list(_flat_port(shards[-1])[path].shape) == want
        assert n_split > 0
        back = ts.unshard_tree(shards, specs, mesh)
        for path, leaf in _flat_port(t).items():
            assert torch.equal(_flat_port(back)[path], leaf), path


def test_lm_mesh_coordinates_groups_and_builders():
    from repro_torch.launch.mesh import (LMMesh, make_host_mesh, make_mesh_compat,
                                         make_production_mesh)

    m = LMMesh((2, 2, 2), ("pod", "data", "model"), ["cpu"] * 8)
    assert m.coords(5) == {"pod": 1, "data": 0, "model": 1} and m.rank_of(pod=1, model=1) == 5
    assert m.groups("model") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert m.groups("pod") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert m.groups(("pod", "model")) == [[0, 1, 4, 5], [2, 3, 6, 7]]
    assert [m.axis_index(r, ("pod", "model")) for r in range(8)] == [0, 1, 0, 1, 2, 3, 2, 3]
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    mp = make_production_mesh(multi_pod=True)
    assert mp.shape == {"pod": 2, "data": 16, "model": 16} and mp.n_ranks == 512
    with pytest.raises(ValueError, match="specs only"):
        mp.device_of(0)
    h = make_host_mesh(device="cpu")
    assert h.shape == {"data": 1, "model": 1} and h.devices == (CPU,)
    assert make_mesh_compat((2, 4), ("data", "model"), device="cpu").devices == (CPU,) * 8
    with pytest.raises(ValueError):
        LMMesh((2, 2), ("data", "model"), ["cpu"] * 3)
    with pytest.raises(ValueError):
        LMMesh((2,), ("blocks",), ["cpu"] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_host_mesh()


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------
def _decode_shards(seed, b, hq, hkv, lens, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = [rng.standard_normal((b, hkv, n, d)).astype(np.float32) for n in lens]
    v = [rng.standard_normal((b, hkv, n, d)).astype(np.float32) for n in lens]
    return q, k, v


@pytest.mark.parametrize("rows,kv_len", [
    ([16, 16, 16, 16], [40, 64]),         # shard-local lengths from a global one
    ([24, 24, 24], [72, 1]),              # one row in shard 0 only
])
def test_sharded_decode_attention_matches_repro_and_the_whole_cache(rows, kv_len):
    from repro.parallel.collectives import sharded_decode_attention as jsda
    from repro_torch.kernels import decode_attention as k5
    from repro_torch.launch.mesh import BlocksMesh
    from repro_torch.parallel.collectives import sharded_decode_attention

    b, hq, hkv, d = 2, 8, 2, 32
    q, k, v = _decode_shards(4, b, hq, hkv, rows, d)
    starts = np.cumsum([0] + rows[:-1])
    lens = [np.clip(np.asarray(kv_len) - s, 0, n).astype(np.int32) for s, n in zip(starts, rows)]
    f = jax.vmap(lambda kk, vv, ll: jsda(jnp.asarray(q), kk, vv, ll, "s", interpret=True),
                 axis_name="s")
    want = np.asarray(f(jnp.asarray(np.stack(k)), jnp.asarray(np.stack(v)),
                        jnp.asarray(np.stack(lens))))
    t = torch.from_numpy
    mesh = BlocksMesh([CPU] * len(rows))
    got = sharded_decode_attention(t(q), [t(x) for x in k], [t(x) for x in v],
                                   [t(x) for x in lens], mesh)
    assert len(got) == len(rows)
    for s in range(len(rows)):
        torch.testing.assert_close(got[s], t(want[s]), **ATTN_TOL)
    whole = k5.decode_attention_plain(t(q), torch.cat([t(x) for x in k], 2),
                                      torch.cat([t(x) for x in v], 2),
                                      torch.tensor(kv_len, dtype=torch.int32))
    torch.testing.assert_close(got[0], whole, **ATTN_TOL)


def test_lse_combine_matches_repros():
    from repro.parallel.collectives import lse_combine_psum
    from repro_torch.parallel.collectives import lse_combine

    rng = np.random.default_rng(7)
    o = rng.standard_normal((3, 2, 4, 16)).astype(np.float32)
    m = (rng.standard_normal((3, 2, 4)) * 4).astype(np.float32)
    l_ = rng.random((3, 2, 4)).astype(np.float32) * 10
    want = jax.vmap(lambda a, b, c: lse_combine_psum(a, b, c, "s"), axis_name="s")(
        jnp.asarray(o), jnp.asarray(m), jnp.asarray(l_))
    t = torch.from_numpy
    got = lse_combine(list(t(o)), list(t(m)), list(t(l_)))
    assert len(got) == 1
    torch.testing.assert_close(got[0], t(np.asarray(want)[0]), **MOE_TOL)


@pytest.mark.parametrize("n_ranks,shape", [(4, (256,)), (3, (17, 33))])
def test_ef_int8_psum_matches_repros(n_ranks, shape):
    from repro.parallel.collectives import _quantize_int8 as jq
    from repro.parallel.collectives import ef_int8_psum as jef
    from repro_torch.parallel.collectives import _quantize_int8, ef_int8_psum

    rng = np.random.default_rng(n_ranks)
    g = (rng.standard_normal((n_ranks,) + shape) * 3).astype(np.float32)
    err = (rng.standard_normal((n_ranks,) + shape) * 0.01).astype(np.float32)
    want_g, want_err = jax.vmap(lambda a, b: jef(a, b, "s"), axis_name="s")(
        jnp.asarray(g), jnp.asarray(err))
    t = torch.from_numpy
    got_g, got_err = ef_int8_psum(list(t(g)), list(t(err)))
    torch.testing.assert_close(got_g[0], t(np.asarray(want_g)[0]), **MOE_TOL)
    for r in range(n_ranks):
        torch.testing.assert_close(got_err[r], t(np.asarray(want_err)[r]), **MOE_TOL)
        q, scale = _quantize_int8(t(g[r] + err[r]))
        jqr, jscale = jq(jnp.asarray(g[r] + err[r]))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(jqr))
        assert scale.item() == float(jscale)


def test_ef_int8_quantization_properties():
    """`repro`'s property (tests/test_system.py): the error is within half a
    step, and 50 rounds of error feedback average to the input within one
    step."""
    from repro_torch.parallel.collectives import _quantize_int8

    x = torch.from_numpy((np.random.default_rng(0).standard_normal(256) * 3).astype(np.float32))
    q, scale = _quantize_int8(x)
    assert float((x - q.float() * scale).abs().max()) <= float(scale) * 0.5 + 1e-6
    err, acc = torch.zeros_like(x), torch.zeros_like(x)
    for _ in range(50):
        xe = x + err
        q, scale = _quantize_int8(xe)
        deq = q.float() * scale
        err, acc = xe - deq, acc + deq
    torch.testing.assert_close(acc / 50, x, atol=float(scale), rtol=0)


def test_mesh_context_is_thread_local_and_nests():
    import threading

    from repro_torch.launch.mesh import LMMesh, make_host_mesh
    from repro_torch.parallel.act_sharding import current_mesh, get_ctx, use_activation_sharding

    outer = make_host_mesh(device="cpu")
    inner = LMMesh((1, 2), ("data", "model"), [CPU] * 2)
    seen = {}
    assert get_ctx() is None
    with use_activation_sharding(outer):
        with use_activation_sharding(inner, moe_ep2d=True):
            assert current_mesh() is inner and get_ctx().moe_ep2d
            other = threading.Thread(target=lambda: seen.update(ctx=get_ctx()))
            other.start()
            other.join()
            with use_activation_sharding(None):
                assert get_ctx() is None
            assert current_mesh() is inner
        assert current_mesh() is outer and get_ctx().moe_shardmap and not get_ctx().moe_ep2d
    assert get_ctx() is None and seen == {"ctx": None}
    _switch_rules_match_repro(outer)


def _one(spec) -> tuple:
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in spec)


def _switch_rules_match_repro(outer):
    """`repro`'s ``enabled`` / ``sp`` / ``bf16_silu`` rules: ``sp`` defaults
    to ``enabled``, ``bf16_silu`` and the MoE switches are carried as given,
    and the hooks' layouts follow its divisibility rules (dim 0 over the
    data axes, dim 1 over "model", each only where it divides), read from
    the specs `repro`'s hooks hand XLA (its mesh and constraint stubbed)."""
    import contextlib

    from repro.parallel import act_sharding as J
    from repro_torch.launch.mesh import LMMesh
    from repro_torch.parallel import act_sharding as T

    seen = []
    stubs = pytest.MonkeyPatch()
    stubs.setattr(jax, "set_mesh", lambda mesh: contextlib.nullcontext(), raising=False)
    stubs.setattr(jax.lax, "with_sharding_constraint",
                  lambda x, spec: seen.append(tuple(spec)) or x)
    try:
        for dims, axes in (((2, 4), ("data", "model")), ((2, 3, 4), ("pod", "data", "model"))):
            jmesh = SimpleNamespace(shape=dict(zip(axes, dims)), axis_names=axes)
            tmesh = LMMesh(dims, axes)
            for kw in ({}, {"enabled": False}, {"sp": True, "enabled": False},
                       {"sp": False}, {"bf16_silu": True, "moe_shardmap": False},
                       {"moe_ep2d": True}):
                with J.use_activation_sharding(jmesh, **kw):
                    want = J.get_ctx()
                    with T.use_activation_sharding(tmesh, **kw):
                        got = T.get_ctx()
                        assert got.mesh is tmesh
                        for k in ("sp", "bf16_silu", "moe_shardmap", "moe_ep2d"):
                            assert getattr(got, k) == getattr(want, k), (kw, k)
                    for shape in ((4, 8, 16), (3, 8, 16), (4, 6, 16), (24, 12), (5,)):
                        seen.clear()
                        J.maybe_shard_hidden(np.zeros(shape))
                        J.maybe_gather_hidden(np.zeros(shape))
                        if want.sp:             # `P` writes a one-axis tuple as the axis
                            split = T.shard_spec(shape, tmesh)
                            whole = split[:1] + (None,) * (len(shape) - 1)
                            assert seen == [_one(split), _one(whole)]
                        else:
                            assert seen == []
        with T.use_activation_sharding(outer, sp=True):   # identities outside a counter
            x = torch.ones(2, 4, 8)
            assert T.maybe_shard_hidden(x) is x and T.maybe_gather_hidden(x) is x
    finally:
        stubs.undo()


# --------------------------------------------------------------------------
# roofline
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", _archs())
def test_param_counts_and_model_flops_match_repros(arch):
    from repro.configs.registry import get_config as jget
    from repro.parallel import roofline as jr
    from repro_torch.configs.registry import get_config
    from repro_torch.parallel import roofline as tr

    counts = tr.param_counts(get_config(arch))
    assert counts == jr.param_counts(jget(arch))
    for kind, b, s in (("train", 256, 4096), ("prefill", 32, 8192), ("decode", 128, 1)):
        shape = SimpleNamespace(kind=kind, global_batch=b, seq_len=s)
        assert tr.model_flops(get_config(arch), kind, b, s, n_active=counts[1]) == \
            jr.model_flops(jget(arch), shape)


def test_roofline_from_costs_names_the_bottleneck():
    from repro_torch.configs.registry import get_config
    from repro_torch.parallel import roofline as tr

    cfg = get_config("tinyllama-1.1b")
    n = 1_100_048_384
    row = tr.roofline_from_costs(tr.Costs(flops=2.0 * n * 8, bytes=2.2e9, collective_bytes=1e6),
                                 cfg=cfg, kind="decode", global_batch=8, seq_len=1,
                                 mesh_name="1x1", chips=1, device_mem_bytes=3 * 10**9,
                                 n_active=n)
    assert row.bottleneck == "memory" and row.fits_hbm
    assert row.memory_s == pytest.approx(2.2e9 / tr.HBM_BW)
    assert row.useful_ratio == pytest.approx(1.0)
    assert row.row()["arch"] == cfg.name
    with pytest.raises(ValueError, match="kind"):
        tr.model_flops(cfg, "serve", 1, 1, n_active=n)


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1]))
