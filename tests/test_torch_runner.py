"""The port's flat runner and CLI end to end, its device contract, the
unported options, and the guards that keep the port free of JAX and of
silent fallbacks."""
import ast
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import run_partitioner as jax_run_partitioner
from repro.graphs import load_dataset as jax_load_dataset

from repro_torch.core import run_partitioner
from repro_torch.graphs import load_dataset
from repro_torch.launch import partition as cli
from repro_torch.launch.mesh import BlocksMesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_end_to_end_quality_matches_reference():
    """WIKI at scale 0.002, k=8, seeds 0-2: torch's generator cannot replay
    JAX's threefry streams, so the runs are compared in distribution, by
    the repo's own gates — mean local edges >= 0.97x the reference mean and
    every max normalized load <= 1.30."""
    g = load_dataset("WIKI", scale=0.002)
    g_ref = jax_load_dataset("WIKI", scale=0.002)
    ours = [run_partitioner("revolver", g, 8, seed=s, device="cpu",
                            track_history=False) for s in range(3)]
    ref = [jax_run_partitioner("revolver", g_ref, 8, seed=s,
                               track_history=False) for s in range(3)]
    le = np.mean([r.local_edges for r in ours])
    le_ref = np.mean([r.local_edges for r in ref])
    assert le >= 0.97 * le_ref, (le, le_ref)
    assert all(r.max_norm_load <= 1.30 for r in ours), [r.max_norm_load for r in ours]
    assert all(r.labels.shape == (g.n,) for r in ours)


def test_same_seed_gives_bit_identical_labels():
    g = load_dataset("WIKI", scale=0.0005)
    a = run_partitioner("revolver", g, 4, seed=3, max_steps=20, device="cpu",
                        keep_probs=True)
    b = run_partitioner("revolver", g, 4, seed=3, max_steps=20, device="cpu",
                        keep_probs=True)
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.probs, b.probs)
    assert a.history == b.history
    c = run_partitioner("revolver", g, 4, seed=4, max_steps=20, device="cpu")
    assert not np.array_equal(a.labels, c.labels)


def test_sync_every_window_keeps_the_trajectory():
    """Fetching scores every 4 supersteps changes only when convergence is
    noticed, never what a superstep computes."""
    g = load_dataset("WIKI", scale=0.0005)
    a = run_partitioner("revolver", g, 4, seed=1, max_steps=12, device="cpu")
    b = run_partitioner("revolver", g, 4, seed=1, max_steps=12, device="cpu",
                        sync_every=4)
    assert a.steps == b.steps == 12
    np.testing.assert_array_equal(a.labels, b.labels)
    assert a.history == b.history


def test_warm_start_matches_reference_init_from_labels():
    """The carried state is `repro`'s: labels spliced in, probs carried and
    sharpened toward the carried labels, loads recomputed."""
    from repro.core.device_graph import prepare_device_graph as jax_prepare
    from repro.core.revolver import (
        RevolverConfig as JaxConfig,
        revolver_init_from_labels as jax_init_from_labels,
    )
    from repro_torch.core.device_graph import prepare_device_graph
    from repro_torch.core.revolver import (
        RevolverConfig,
        make_generator,
        revolver_init_from_labels,
    )

    g = load_dataset("WIKI", scale=0.0005)
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 4, g.n).astype(np.int32)
    dg = prepare_device_graph(g, device="cpu")
    probs = rng.dirichlet(np.ones(4), dg.n_pad).astype(np.float32)
    ours = revolver_init_from_labels(dg, RevolverConfig(k=4), make_generator(0, "cpu"),
                                     labels, probs=probs, prob_sharpen=0.5)
    want = jax_init_from_labels(jax_prepare(g), JaxConfig(k=4), jax.random.PRNGKey(0),
                                labels, probs=probs, prob_sharpen=0.5)
    for name in ("labels", "lam", "loads", "probs"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    res = run_partitioner("revolver", g, 4, seed=0, max_steps=2, device="cpu",
                          init_labels=labels, init_probs=probs, init_sharpen=0.5)
    assert res.steps == 2
    with pytest.raises(TypeError, match="init_labels"):
        run_partitioner("revolver", g, 4, device="cpu", init_sharpen=0.5)


def test_cli_runs_on_cpu(capsys, tmp_path):
    """Without --algo the CLI runs every registered algorithm, one row each."""
    out = tmp_path / "labels.npz"
    cli.main(["--device", "cpu", "--dataset", "WIKI", "--scale", "0.0005",
              "--k", "4", "--max-steps", "10", "--json", "--labels-out", str(out)])
    rows = json.loads(capsys.readouterr().out)
    assert [r["algo"] for r in rows] == ["hash", "range", "restream", "revolver", "spinner"]
    for r in rows:
        assert 0.0 < r["local_edges"] <= 1.0 and r["steps"] <= 10
    n = load_dataset("WIKI", scale=0.0005).n
    assert all(np.load(out)[r["algo"]].shape == (n,) for r in rows)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = load_dataset("WIKI", scale=0.0005)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_partitioner("revolver", g, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--dataset", "WIKI", "--scale", "0.0005", "--json"])


_CPU2 = BlocksMesh([torch.device("cpu")] * 2)


# the ids these cases had while all six raised
@pytest.mark.parametrize("kwargs", [
    {"chunk_schedule": "sharded"},
    {"chunk_schedule": "async"},
    {"mesh": _CPU2, "chunk_schedule": "sharded"},
    {"assignment": "locality", "chunk_schedule": "sharded", "mesh": _CPU2},
    {"hub_replication": True},
    {"staleness_bound": 1, "chunk_schedule": "async", "mesh": _CPU2},
], ids=["chunk_schedule=sharded", "chunk_schedule=async", "mesh=<object obje",
        "assignment=locality", "hub_replication=True", "staleness_bound=1"])
def test_unported_options_raise(kwargs):
    """ROADMAP queue 1 item 9's options, all ported now: the schedules, the
    mesh, the assignment, the staleness bound and hub replication run (a
    1-shard sharded run is the sequential one, bit for bit; hubs on the
    sequential schedule are the oracle a 1-shard halo hub run equals)."""
    g = load_dataset("WIKI", scale=0.0005)
    if "hub_replication" in kwargs:
        kw = dict(device="cpu", max_steps=3, n_blocks=4, hub_quantile=0.9, **kwargs)
        res = run_partitioner("revolver", g, 4, **kw)
        one = run_partitioner("revolver", g, 4, chunk_schedule="halo", halo_threshold=2.0,
                              mesh=BlocksMesh([torch.device("cpu")]), **kw)
        assert res.steps == 3 and res.labels.shape == (g.n,)
        np.testing.assert_array_equal(res.labels, one.labels)
        return
    res = run_partitioner("revolver", g, 4, device="cpu", max_steps=3, n_blocks=4, **kwargs)
    assert res.steps == 3 and res.labels.shape == (g.n,)
    assert 0.0 < res.local_edges <= 1.0 and res.max_norm_load >= 1.0
    if kwargs == {"chunk_schedule": "sharded"}:
        seq = run_partitioner("revolver", g, 4, device="cpu", max_steps=3, n_blocks=4)
        np.testing.assert_array_equal(res.labels, seq.labels)


@pytest.mark.parametrize("option", ["trace", "checkpoint_dir", "guard", "resume"])
def test_crash_safety_and_tracing_options_run(option, tmp_path):
    """The options that raised until tracing, checkpoints and the guard were
    ported now run and leave the result as the plain run's."""
    from repro_torch.obs import Tracer

    g = load_dataset("WIKI", scale=0.0005)
    common = dict(device="cpu", seed=1, max_steps=6, sync_every=2)
    kwargs = {"trace": dict(trace=Tracer()),
              "checkpoint_dir": dict(checkpoint_dir=str(tmp_path), checkpoint_every=2),
              "guard": dict(guard="raise"),
              "resume": dict(checkpoint_dir=str(tmp_path), resume=True)}[option]
    plain = run_partitioner("revolver", g, 4, **common)
    res = run_partitioner("revolver", g, 4, **common, **kwargs)
    np.testing.assert_array_equal(res.labels, plain.labels)
    assert res.steps == plain.steps and res.history == plain.history
    if option == "trace":
        assert kwargs["trace"].summary()["spans"]["superstep"]["count"] == res.steps
    if option == "checkpoint_dir":
        assert sorted(p.name for p in tmp_path.iterdir()) == [
            "step_00000004", "step_00000006"]
    if option == "resume":
        assert res.resumed_from == 0        # nothing on disk: a fresh run


def test_impl_knobs_are_gone_and_unknown_keys_raise():
    g = load_dataset("WIKI", scale=0.0005)
    for kwargs in ({"hist_impl": "pallas"}, {"la_impl": "jnp"}, {"capacty_mode": "x"}):
        with pytest.raises(TypeError, match="unknown config kwargs"):
            run_partitioner("revolver", g, 4, device="cpu", **kwargs)
    # the "off" value of an unported option is what already runs
    res = run_partitioner("revolver", g, 4, device="cpu", max_steps=1,
                          mode="flat", guard="off", chunk_schedule="sequential")
    assert res.steps == 1


def _port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


def test_port_imports_neither_jax_nor_repro():
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_no_except_in_the_kernels_swallows_a_failure():
    """A build or launch error must reach the caller: every handler in the
    kernel package re-raises, and none calls a plain version."""
    for path in sorted((PORT / "kernels").rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for handler in (n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)):
            assert isinstance(handler.body[-1], ast.Raise), \
                f"{path}:{handler.lineno}: except without re-raise"
            called = {c.func.id if isinstance(c.func, ast.Name) else
                      getattr(c.func, "attr", "")
                      for c in ast.walk(handler) if isinstance(c, ast.Call)}
            assert not any(name.endswith("_plain") for name in called), \
                f"{path}:{handler.lineno}: falls back to a plain version"
