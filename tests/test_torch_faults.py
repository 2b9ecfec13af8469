"""Crash safety of the port (`repro_torch.faults`, checkpointed resume, the
state guard) on the CPU, case for case with tests/test_faults.py (the
async-schedule SIGKILL case waits for the port's multi-GPU schedules), plus
checks against `repro`: the same fault plans from the same specs, and the
guard's ``reinit`` repair bit-equal to `repro`'s run when the port replays
`repro`'s random draws."""
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import faults as jax_faults
from repro.core import engine as jax_engine
from repro.core.registry import get_algorithm as jax_get_algorithm
from repro.core.device_graph import prepare_device_graph as jax_prepare
from repro.core.runner import run_partitioner as jax_run_partitioner
from repro.graphs import load_dataset as jax_load_dataset

from repro_torch import faults
from repro_torch.core import engine
from repro_torch.core.runner import PartitionStateError, run_partitioner
from repro_torch.graphs import load_dataset
from repro_torch.streaming.runner import StreamConfig, StreamRunner
from repro_torch.streaming.stream import stream_from_graph

from test_torch_superstep import replayed_draws

G = load_dataset("WIKI", scale=0.002, seed=0)
K = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = ["kill@superstep=12,kill@save,nan@superstep=8,kill@delta=2,"
         "badlabel@superstep=3,kill@save-payload,kill@save=1",
         "nan@superstep=2", " kill@delta ,", ""]


def _run(algo, **kw):
    return run_partitioner(algo, G, K, device="cpu", **kw)


# --------------------------------------------------------------------------
# fault-plan grammar
# --------------------------------------------------------------------------
def test_parse_faults_grammar():
    plan = faults.parse_faults(SPECS[0])
    assert len(plan.actions) == 7
    a = plan.actions[0]
    assert (a.action, a.point, a.index) == ("kill", "superstep", 12)
    assert plan.actions[1].index is None
    assert plan.actions[6].index == 1
    assert faults.ENV_VAR == jax_faults.ENV_VAR == "REPRO_FAULTS"


@pytest.mark.parametrize("spec", SPECS)
def test_parse_faults_equals_reference(spec):
    ours, ref = faults.parse_faults(spec), jax_faults.parse_faults(spec)
    assert [(a.action, a.point, a.index) for a in ours.actions] == \
        [(a.action, a.point, a.index) for a in ref.actions]


@pytest.mark.parametrize("bad", [
    "explode@superstep=1",
    "kill@lunch",
    "nan@save",
    "kill@superstep=x",
    "kill",
])
def test_parse_faults_rejects(bad):
    with pytest.raises(ValueError):
        faults.parse_faults(bad)
    with pytest.raises(ValueError):
        jax_faults.parse_faults(bad)


def test_fire_consumes_actions_once():
    with faults.use_plan("nan@superstep=2"):
        assert faults.fire("superstep", 1) is None
        assert faults.fire("superstep", 2) == "nan"
        assert faults.fire("superstep", 2) is None
    assert faults.fire("superstep", 2) is None


def test_poison_is_out_of_place():
    """`repro`'s poison is an ``.at[0].set``; the port's clones first, so
    the poisoned state aliases neither the caller's tensors nor a
    snapshot taken of them."""
    from repro_torch.core.revolver import RevolverState

    probs = torch.full((2, 3, 4), 0.25)
    labels = torch.zeros(6, dtype=torch.int32)
    s = RevolverState(labels, labels.clone(), probs, torch.zeros(4),
                      torch.Generator(), 0, torch.zeros(()))
    p = faults.poison(s, "nan")
    assert torch.isnan(p.probs.view(-1)[0]) and torch.isfinite(probs).all()
    b = faults.poison(s, "badlabel")
    assert int(b.labels[0]) == 2**30 and int(labels[0]) == 0


# --------------------------------------------------------------------------
# batch kill-and-resume (in-process: the "kill" is a step-budget cut at a
# mid-window or on-window superstep)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("algo", ["revolver", "spinner", "restream"])
@pytest.mark.parametrize("cut", [9, 12])
def test_resume_bit_identical(algo, cut):
    common = dict(seed=3, max_steps=20, sync_every=4, track_history=False)
    ref = _run(algo, **common)
    with tempfile.TemporaryDirectory() as td:
        _run(algo, checkpoint_dir=td, checkpoint_every=4, **dict(common, max_steps=cut))
        res = _run(algo, checkpoint_dir=td, checkpoint_every=4, resume=True, **common)
        assert res.resumed_from == 4 * (cut // 4)
        assert res.steps == ref.steps
        np.testing.assert_array_equal(ref.labels, res.labels)


def test_resume_with_checkpointing_changes_nothing():
    common = dict(seed=3, max_steps=16, sync_every=4, track_history=False)
    ref = _run("revolver", keep_probs=True, **common)
    with tempfile.TemporaryDirectory() as td:
        on = _run("revolver", checkpoint_dir=td, checkpoint_every=4, keep_probs=True, **common)
        np.testing.assert_array_equal(ref.labels, on.labels)
        np.testing.assert_array_equal(ref.probs, on.probs)
        fresh = _run("revolver", checkpoint_dir=td + "/empty", resume=True, **common)
        assert fresh.resumed_from == 0
        np.testing.assert_array_equal(ref.labels, fresh.labels)


def test_resume_skips_corrupt_newest_checkpoint():
    common = dict(seed=3, max_steps=16, sync_every=4, track_history=False)
    ref = _run("revolver", **common)
    with tempfile.TemporaryDirectory() as td:
        _run("revolver", checkpoint_dir=td, checkpoint_every=4, keep_checkpoints=4, **common)
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(td))
        assert len(steps) >= 2
        newest = os.path.join(td, f"step_{steps[-1]:08d}", "arrays.npz")
        with open(newest, "wb") as f:
            f.write(b"garbage")
        res = _run("revolver", checkpoint_dir=td, checkpoint_every=4, resume=True, **common)
        assert res.resumed_from == steps[-2]
        np.testing.assert_array_equal(ref.labels, res.labels)


def test_checkpoint_validation_errors():
    with pytest.raises(ValueError):
        _run("revolver", checkpoint_every=4)
    with pytest.raises(ValueError):
        _run("revolver", resume=True)
    with pytest.raises(ValueError):
        _run("revolver", guard="rollback")
    with pytest.raises(ValueError):
        _run("revolver", guard="nonsense")
    with pytest.raises(TypeError):
        _run("hash", guard="raise")
    with tempfile.TemporaryDirectory() as td:
        _run("revolver", seed=3, max_steps=8, sync_every=4, checkpoint_dir=td,
             checkpoint_every=4, track_history=False)
        res = run_partitioner("revolver", G, K + 1, seed=3, max_steps=8, sync_every=4,
                              checkpoint_dir=td, resume=True, track_history=False,
                              device="cpu")
        assert res.resumed_from == 0


def test_reference_checkpoint_is_refused_and_the_run_starts_fresh():
    """`repro` and the port share the file format, not the random state:
    a `repro` partition checkpoint carries a threefry key and no device
    type, so the port refuses it as written by a different run."""
    common = dict(seed=3, max_steps=8, sync_every=4, track_history=False)
    ref = _run("revolver", **common)
    g_ref = jax_load_dataset("WIKI", scale=0.002, seed=0)
    with tempfile.TemporaryDirectory() as td:
        jax_run_partitioner("revolver", g_ref, K, checkpoint_dir=td, checkpoint_every=4,
                            **common)
        assert os.listdir(td)
        res = _run("revolver", checkpoint_dir=td, resume=True, **common)
        assert res.resumed_from == 0
        np.testing.assert_array_equal(ref.labels, res.labels)


# --------------------------------------------------------------------------
# streaming kill-and-resume
# --------------------------------------------------------------------------
def _deltas():
    return list(stream_from_graph(G, n_deltas=4, seed=7))


def _stream(cfg, **kw):
    return StreamRunner(G.n, cfg, algo="revolver", seed=5, device="cpu", **kw)


def test_stream_resume_bit_identical():
    cfg = StreamConfig(k=K, n_blocks=8, refine_max_steps=8, sync_every=2)
    ref = _stream(cfg)
    ref.run(_deltas())
    with tempfile.TemporaryDirectory() as td:
        r1 = _stream(cfg, checkpoint_dir=td)
        for d in _deltas()[:2]:
            r1.ingest(d)
        r1.finish()
        r2 = _stream(cfg, checkpoint_dir=td, resume=True)
        assert r2.delta_base == 2
        reports = r2.run(_deltas())
        r2.finish()
        assert [r.delta_idx for r in reports] == [2, 3]
        np.testing.assert_array_equal(ref.labels, r2.labels)
        np.testing.assert_array_equal(ref.probs, r2.probs)
        assert ref.total_steps == r2.total_steps
        assert [r.local_edges for r in ref.reports[2:]] == [r.local_edges for r in reports]


def test_stream_resume_rejects_other_stream():
    cfg = StreamConfig(k=K, n_blocks=8, refine_max_steps=4, sync_every=2)
    with tempfile.TemporaryDirectory() as td:
        r1 = _stream(cfg, checkpoint_dir=td)
        r1.ingest(_deltas()[0])
        r1.finish()
        other = _stream(StreamConfig(k=K + 1, n_blocks=8, refine_max_steps=4, sync_every=2),
                        checkpoint_dir=td, resume=True)
        assert other.delta_base == 0


def test_stream_kill_at_delta_point():
    cfg = StreamConfig(k=K, n_blocks=8, refine_max_steps=4, sync_every=2)
    with faults.use_plan(faults.parse_faults("nan@superstep=999")):
        r = _stream(cfg)
        r.ingest(_deltas()[0])
        assert len(r.reports) == 1


# --------------------------------------------------------------------------
# guard policies (poison injection via use_plan)
# --------------------------------------------------------------------------
def test_guard_raise_on_nan_probs():
    with faults.use_plan("nan@superstep=5"):
        with pytest.raises(PartitionStateError):
            _run("revolver", seed=3, max_steps=16, sync_every=4, track_history=False,
                 guard="raise")


def test_guard_raise_on_bad_labels():
    # the poison lands on the last step of a window, where the guard sees
    # it before a superstep or a metric indexes by the bad label
    with faults.use_plan("badlabel@superstep=7"):
        with pytest.raises(PartitionStateError):
            _run("spinner", seed=3, max_steps=16, sync_every=4, track_history=False,
                 guard="raise")


def test_guard_off_lets_corruption_through():
    with faults.use_plan("badlabel@superstep=7"):
        res = _run("spinner", seed=3, max_steps=8, sync_every=4, track_history=False)
        assert (res.labels >= K).any()


def test_guard_reinit_recovers():
    with faults.use_plan("nan@superstep=5"):
        res = _run("revolver", seed=3, max_steps=16, sync_every=4, track_history=False,
                   guard="reinit-affected-vertices", keep_probs=True)
    assert res.steps == 16
    assert ((res.labels >= 0) & (res.labels < K)).all()
    assert np.isfinite(res.probs).all()


def test_guard_rollback_recovers_and_rollback_without_ckpt_escalates():
    common = dict(seed=3, max_steps=20, sync_every=4, track_history=False)
    with tempfile.TemporaryDirectory() as td:
        with faults.use_plan("nan@superstep=9"):
            res = _run("revolver", checkpoint_dir=td, checkpoint_every=4,
                       guard="rollback-to-last-checkpoint", **common)
        assert ((res.labels >= 0) & (res.labels < K)).all()
    with tempfile.TemporaryDirectory() as td:
        with faults.use_plan("nan@superstep=2"):
            with pytest.raises(PartitionStateError):
                _run("revolver", checkpoint_dir=td, checkpoint_every=100, guard="rollback",
                     **common)
    # the generator rewinds with the state: the replay from step 8 draws
    # what the first pass drew, so the run that rolled back (at the window
    # of steps 8-11) and replayed 8 of its 20 loop steps ends where the plain
    # run ends at step 16
    short = _run("revolver", **dict(common, max_steps=16))
    np.testing.assert_array_equal(res.labels, short.labels)


def test_guard_rollback_waits_for_inflight_save(monkeypatch):
    """The only clean checkpoint is still being written when the guard
    trips: the rollback waits for it instead of finding none."""
    from repro_torch.checkpoint import store as ckpt_store

    real = ckpt_store._write_npz

    def slow(f, arrays):
        time.sleep(1.0)
        real(f, arrays)

    common = dict(seed=3, max_steps=20, sync_every=4, track_history=False)
    plain = _run("revolver", **dict(common, max_steps=16))
    monkeypatch.setattr(ckpt_store, "_write_npz", slow)
    with tempfile.TemporaryDirectory() as td:
        with faults.use_plan("nan@superstep=5"):
            res = _run("revolver", checkpoint_dir=td, checkpoint_every=4, guard="rollback",
                       **common)
    # rolled back from the window of steps 4-7 to the save at 4, so 4 of
    # the 20 loop steps were replayed
    np.testing.assert_array_equal(res.labels, plain.labels)


class _Recorder:
    """Keeps the newest state a superstep returned."""

    def __init__(self, fn):
        self.fn, self.last = fn, None

    def __call__(self, *a, **kw):
        self.last = self.fn(*a, **kw)
        return self.last


@pytest.mark.parametrize("poison", ["nan", "badlabel"])
def test_guard_reinit_matches_reference_with_replayed_draws(poison, monkeypatch):
    """`repro` and the port run Revolver from the same labels, the port
    replaying `repro`'s draws; a poison after superstep 3 is caught at the
    window of steps 0-3 and repaired by ``reinit``; after 8 supersteps the
    labels, lambda, LA probabilities and loads are bit-equal."""
    g_ref = jax_load_dataset("WIKI", scale=0.002, seed=0)
    steps, seed = 8, 3
    labels0 = np.random.default_rng(seed).integers(0, K, G.n).astype(np.int32)
    dg = jax_prepare(g_ref, n_blocks=8)
    algo = jax_get_algorithm("revolver")
    cfg = algo.config_cls(k=K)
    st = algo.init_from_labels(dg, cfg, jax.random.PRNGKey(seed), labels0)
    draws = replayed_draws(st.key, steps, dg.n_blocks, dg.block_v, K)
    common = dict(seed=seed, max_steps=steps, sync_every=4, track_history=False,
                  init_labels=labels0, guard="reinit")
    jrec, trec = _Recorder(jax_engine.superstep), _Recorder(engine.superstep)
    monkeypatch.setattr(jax_engine, "superstep", jrec)
    monkeypatch.setattr(engine, "superstep", trec)
    with jax_faults.use_plan(f"{poison}@superstep=3"):
        jres = jax_run_partitioner("revolver", g_ref, K, **common)
    with faults.use_plan(f"{poison}@superstep=3"):
        res = _run("revolver", draws=draws, **common)
    assert res.steps == jres.steps == steps
    want = jax.device_get(jrec.last._asdict())
    for name in ("labels", "lam", "probs", "loads"):
        np.testing.assert_array_equal(getattr(trec.last, name).numpy(), want[name],
                                      err_msg=name)
    np.testing.assert_array_equal(res.labels, jres.labels)


# --------------------------------------------------------------------------
# one real SIGKILL through the port's CLI
# --------------------------------------------------------------------------
def test_subprocess_sigkill_and_resume_exact():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("REPRO_FAULTS", None)
    with tempfile.TemporaryDirectory() as td:
        base = [sys.executable, "-m", "repro_torch.launch.partition", "--device", "cpu",
                "--dataset", "WIKI", "--scale", "0.005", "--k", "4",
                "--algo", "revolver", "--seed", "3", "--max-steps", "16",
                "--sync-every", "4", "--json"]
        ref_out = os.path.join(td, "ref.npz")
        r = subprocess.run(base + ["--labels-out", ref_out], env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
        ckpt = base + ["--checkpoint-dir", os.path.join(td, "ckpt"),
                       "--checkpoint-every", "4"]
        victim = subprocess.run(ckpt, env=dict(env, REPRO_FAULTS="kill@superstep=9"),
                                capture_output=True, text=True, timeout=300)
        assert victim.returncode == -signal.SIGKILL, (
            victim.returncode, victim.stdout + victim.stderr)
        res_out = os.path.join(td, "res.npz")
        r = subprocess.run(ckpt + ["--resume", "--labels-out", res_out],
                           env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
        assert '"resumed_from": 8' in r.stdout
        with np.load(ref_out) as a, np.load(res_out) as b:
            np.testing.assert_array_equal(a["revolver"], b["revolver"])


def test_kill_resume_tool_passes_on_the_cpu():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "torch_kill_resume_check.py"),
         "--device", "cpu", "--scale", "0.002", "--k", "4", "--max-steps", "12",
         "--kill-at", "6"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1] == "PASS"
