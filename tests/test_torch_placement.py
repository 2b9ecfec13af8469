"""The port's expert placement (`repro_torch.core.placement`) on the CPU
against `repro.core.placement`, from the same routing (made with numpy).

  * `coactivation_graph`: the CSR arrays and the weights (in `repro`'s
    first-sample order) bit-equal on random routing over several seeds and
    widths, on clustered routing, and on top-1 routing (the ring).
  * The balance repair, the device-major permutation and `_cross_fraction`
    bit-equal given the same partition labels: `repro`'s ``place_experts``
    runs with the name ``run_partitioner`` inside `repro.core.placement`
    replaced (monkeypatched; no file is edited) by one that returns the
    port's labels.
  * `apply_placement`: the permuted leaves equal `repro`'s, the input left
    unchanged, and a placed MoE's output equal to the unplaced one
    (single-device and expert-parallel).
  * End to end on clustered routing over 3 seeds: Revolver's cross
    fraction at least 0.3 below the naive contiguous placement's, exactly
    E/devices experts a device, and within `repro`'s spread over the same
    seeds (torch's Philox draws cannot replay JAX's threefry, so runs are
    compared in distribution).
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.core import placement as jpl
from repro_torch.core import placement as tpl

MOE_TOL = dict(atol=1e-5, rtol=1e-5)


def _random_top(seed: int, t: int, e: int, k: int) -> np.ndarray:
    """Distinct random picks a token, as a router's top-k gives them."""
    rng = np.random.default_rng(seed)
    return np.argsort(rng.random((t, e)), axis=1)[:, :k].astype(np.int32)


def _clustered_top(seed: int, e: int = 64, dev: int = 8, t: int = 4000, k: int = 6,
                   noise: float = 0.0) -> np.ndarray:
    """`examples/expert_placement.py`'s clustered routing (experts drawn
    within a hidden group, with repeats), a share ``noise`` of the tokens
    routed at random instead."""
    rng = np.random.default_rng(seed)
    clusters = rng.permutation(e).reshape(dev, e // dev)
    grp = rng.integers(0, dev, t)
    top = clusters[grp[:, None], rng.integers(0, e // dev, (t, k))]
    rand = rng.random(t) < noise
    top[rand] = rng.integers(0, e, (int(rand.sum()), k))
    return top


def _graph_equal(gj, gt) -> None:
    fields = [f.name for f in dataclasses.fields(gj)]
    assert {"row_ptr", "col_idx", "adj_ptr", "adj_idx", "adj_w", "deg_out"} <= set(fields)
    for f in fields:
        a, b = np.asarray(getattr(gj, f)), np.asarray(getattr(gt, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


ROUTINGS = {
    "random-64x6": lambda: _random_top(0, 3000, 64, 6),
    "random-8x2": lambda: _random_top(1, 500, 8, 2),
    "random-160x6": lambda: _random_top(2, 1000, 160, 6),
    "clustered": lambda: _clustered_top(3),
    "clustered-noisy": lambda: _clustered_top(4, noise=0.3),
    "top1": lambda: _random_top(5, 200, 16, 1),
}


@pytest.mark.parametrize("name", sorted(ROUTINGS))
def test_coactivation_graph_is_bit_equal_to_repros(name):
    top = ROUTINGS[name]()
    e = int(top.max()) + 1 if name != "top1" else 16
    gj, wj = jpl.coactivation_graph(top, e)
    gt, wt = tpl.coactivation_graph(top, e)
    _graph_equal(gj, gt)
    assert wj.dtype == wt.dtype and np.array_equal(wj, wt)
    if name == "top1":                              # the ring fallback
        assert np.array_equal(wt, np.ones(e))


def _port_result(labels):
    return SimpleNamespace(labels=labels, steps=0, local_edges=0.0, max_norm_load=0.0)


@pytest.mark.parametrize("name", ["random-64x6", "clustered", "clustered-noisy", "random-8x2"])
@pytest.mark.parametrize("n_devices", [4, 8])
def test_balance_permutation_and_cross_fraction_match_repros(name, n_devices, monkeypatch):
    top = ROUTINGS[name]()
    e = int(top.max()) + 1
    pl = tpl.place_experts(top, e, n_devices, max_steps=30, device="cpu")
    counts = np.bincount(pl.expert_to_device, minlength=n_devices)
    assert counts.min() == counts.max() == e // n_devices
    # repro's repair on the port's labels, and on labels that overflow a device
    rng = np.random.default_rng(n_devices)
    for labels in (np.asarray(pl.result.labels), rng.integers(0, n_devices // 2, e)):
        monkeypatch.setattr(jpl, "run_partitioner", lambda *a, labels=labels, **kw:
                            _port_result(labels))
        want = jpl.place_experts(top, e, n_devices)
        assign = tpl.balance(labels, e, n_devices)
        assert np.array_equal(assign, want.expert_to_device)
        assert np.array_equal(np.argsort(assign, kind="stable"), want.permutation)
        assert tpl._cross_fraction(top, assign) == want.cross_coactivation
    assert np.array_equal(np.argsort(pl.expert_to_device, kind="stable"), pl.permutation)
    assert pl.cross_coactivation == jpl._cross_fraction(top, pl.expert_to_device)


def _moe_pair(seed: int, e: int = 16):
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    from repro_torch.models.common import Dense
    from repro_torch.models.mlp import MLP

    kw = dict(d_model=16, n_experts=e, top_k=2, d_ff_expert=24, n_shared=1,
              capacity_factor=e / 2)
    jspec = jmoe.MoESpec(**kw)
    params = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed), jspec, jnp.float32))
    t = lambda a: torch.from_numpy(np.array(a))                   # noqa: E731
    tp = tmoe.MoE(Dense(t(params["router"]["w"])), t(params["w_gate"]), t(params["w_up"]),
                  t(params["w_down"]),
                  MLP("swiglu", **{k: Dense(t(v["w"])) for k, v in params["shared"].items()}))
    return jspec, tmoe.MoESpec(**kw), params, tp


def test_apply_placement_leaves_equal_repros_and_outputs_unchanged():
    from repro_torch.launch.mesh import LMMesh
    from repro_torch.models import moe as tmoe
    from repro_torch.parallel.act_sharding import use_activation_sharding

    jspec, spec, params, moe = _moe_pair(0)
    top = _clustered_top(6, e=16, dev=4, t=600, k=2)
    pl = tpl.place_experts(top, 16, 4, max_steps=40, device="cpu")
    want = jpl.apply_placement(params, SimpleNamespace(permutation=pl.permutation))
    before = {k: v.clone() for k, v in moe.state_dict().items()}
    placed = tpl.apply_placement(moe, pl)
    for k, v in before.items():                                   # the input is unchanged
        assert torch.equal(moe.state_dict()[k], v)
    for k in ("w_gate", "w_up", "w_down"):
        assert np.array_equal(getattr(placed, k).numpy(), np.asarray(want[k]))
    assert np.array_equal(placed.router.w.numpy(), np.asarray(want["router"]["w"]))
    assert placed.shared is moe.shared
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 24, 16)).astype(np.float32))
    torch.testing.assert_close(tmoe.moe_ref(placed, x, spec), tmoe.moe_ref(moe, x, spec),
                               **MOE_TOL)
    y = tmoe.apply_moe(moe, x, spec)
    assert torch.equal(tmoe.apply_moe(placed, x, spec), y)
    # expert-parallel over 4 ranks: rank r holds the experts placed on device r
    with use_activation_sharding(LMMesh((1, 4), ("data", "model"), ["cpu"] * 4)), \
            tmoe.record_dispatch() as rec:
        y_ep = tmoe.apply_moe(placed, x, spec)
    assert [r["path"] for r in rec] == ["shardmap"]
    torch.testing.assert_close(y_ep, y, **MOE_TOL)


def test_placed_model_serves_the_unplaced_models_tokens():
    """Every MoE layer of a reduced deepseek-v2-lite-16b replaced by its
    placed copy, layer by layer: the prefill's and 3 greedy decode steps'
    logits bit-equal (the router's softmax runs on its sorted logits, the
    experts' products are batched per expert, the combine sums a token's K
    choices in their ranked order: no step depends on where an expert
    sits)."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_cache, init_lm, lm_decode_step, lm_prefill
    from repro_torch.models import moe as tmoe

    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b").reduced(), capacity_factor=1.25)
    model = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)

    def run():
        cache = init_cache(cfg, 2, 16, "cpu")
        logits, cache = lm_prefill(model, cfg, cache, {"tokens": toks})
        out = [logits]
        for _ in range(3):
            logits, cache = lm_decode_step(model, cfg, cache, logits.argmax(-1).int())
            out.append(logits)
        return torch.stack(out)

    with torch.inference_mode(), tmoe.record_dispatch():
        want = run()
        stats = []
        for blk in model.blocks:
            _, st = tmoe.apply_moe(blk.moe, torch.randn(40, cfg.d_model,
                                                        generator=torch.Generator().manual_seed(2)),
                                   tmoe.MoESpec(cfg.d_model, cfg.n_experts, cfg.top_k,
                                                cfg.d_ff_expert, cfg.n_shared_experts),
                                   return_stats=True)
            stats.append(st["top_idx"])
        for blk, top in zip(model.blocks, stats):
            pl = tpl.place_experts(top, cfg.n_experts, 4, max_steps=20, device="cpu")
            blk.moe = tpl.apply_placement(blk.moe, pl)
        got = run()
    assert torch.equal(got, want)


def test_clustered_routing_gain_and_balance_are_within_repros_spread():
    """`examples/expert_placement.py`'s routing (64 experts on 8 devices,
    4,000 tokens, top 6) over 3 seeds: the port's Revolver cuts at least 0.3
    less co-activation than the naive contiguous placement, with exactly 8
    experts a device, and its mean cross fraction lies within `repro`'s
    range over the same routings widened by 0.05. (The partitioner sees the
    graph unweighted: routing with random tokens mixed in fills it towards
    the complete graph, where neither package finds the groups.)"""
    e, dev = 64, 8
    naive = np.arange(e) // (e // dev)
    port, ref = [], []
    for seed in range(3):
        top = _clustered_top(10 + seed)
        pl = tpl.place_experts(top, e, dev, seed=seed, max_steps=120, device="cpu")
        counts = np.bincount(pl.expert_to_device, minlength=dev)
        assert counts.min() == counts.max() == e // dev
        assert pl.cross_coactivation <= tpl._cross_fraction(top, naive) - 0.3
        port.append(pl.cross_coactivation)
        ref.append(jpl.place_experts(top, e, dev, seed=seed, max_steps=120).cross_coactivation)
    assert min(ref) - 0.05 <= float(np.mean(port)) <= max(ref) + 0.05, (port, ref)


def test_place_experts_reads_tensors_and_refuses_a_missing_card():
    top = torch.from_numpy(_random_top(7, 300, 16, 2))
    pl = tpl.place_experts(top, 16, 4, max_steps=10, device="cpu")
    assert pl.expert_to_device.shape == (16,) and sorted(pl.permutation) == list(range(16))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tpl.place_experts(top, 16, 4, max_steps=10)
