"""Elastic restore and the V-cycle's fine-level schedule knobs, on the CPU.

  * **Elastic restore.** A checkpoint is in original vertex order, so it
    restores onto a layout of another shard count (`repro`'s contract,
    `repro/core/runner.py`): the sharded trajectory is specific to the shard
    count, so across a count change the gate is transport exactness — the
    checkpoint restored onto the new count with the run capped at its step
    gives the checkpointed labels and probabilities bit for bit (4 -> 2,
    4 -> 1 and 4 -> the sequential schedule), and the run then continues on
    the new count. At an unchanged count a resumed hub run is bit-equal to
    the uninterrupted one (halo, and async at staleness 1).
  * **The V-cycle with a sharded finest level.** The coarse levels run the
    sequential schedule whatever the fine-level knobs, so they equal the
    sequential V-cycle's level by level (seed 0); the finest level runs
    halo with hubs on 4 shards. Its quality is held to `repro`'s same V-cycle (4
    forced host devices, in a subprocess: this module run as a program)
    over 3 seeds at WIKI 0.002: mean local edges >= 0.97x `repro`'s, every
    max normalized load <= 1.30.
"""
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.core import run_partitioner  # noqa: E402
from repro_torch.core import runner as runner_mod  # noqa: E402
from repro_torch.graphs import load_dataset  # noqa: E402
from repro_torch.launch.mesh import BlocksMesh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
K = 8
VCYCLE = dict(dataset="WIKI", scale=0.002, seeds=(0, 1, 2), shards=4, quantile=0.95)
FINE = dict(chunk_schedule="halo", halo_threshold=2.0, hub_replication=True,
            hub_quantile=VCYCLE["quantile"])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small CPU ops: torch's intra-op threads buy little here and
    contend with the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wiki():
    return load_dataset("WIKI", scale=0.002, seed=0)


def _mesh(n):
    return BlocksMesh([CPU] * n)


# --------------------------------------------------------------------------
# elastic restore
# --------------------------------------------------------------------------
@pytest.mark.parametrize("writer,reader", [
    (dict(chunk_schedule="halo", assignment="locality", **{k: v for k, v in FINE.items()
                                                            if k != "chunk_schedule"}),
     dict(chunk_schedule="halo", shards=2, **{k: v for k, v in FINE.items()
                                              if k != "chunk_schedule"})),
    (dict(chunk_schedule="halo", halo_threshold=2.0),
     dict(chunk_schedule="halo", shards=1, halo_threshold=2.0)),
    (dict(chunk_schedule="sharded"), dict(chunk_schedule="sequential")),
], ids=["halo-hubs-4-to-2", "halo-4-to-1", "sharded-4-to-sequential"])
def test_transport_exact_onto_another_shard_count(wiki, writer, reader):
    writer, reader = dict(writer), dict(reader)
    common = dict(seed=2, n_blocks=16, device="cpu", keep_probs=True, track_history=False,
                  patience=10_000, sync_every=3, checkpoint_every=3)
    with tempfile.TemporaryDirectory() as td:
        cut = run_partitioner("revolver", wiki, K, checkpoint_dir=td, max_steps=9,
                              mesh=_mesh(4), **writer, **common)
        shards = reader.pop("shards", None)
        if shards is not None:
            reader["mesh"] = _mesh(shards)
        moved = run_partitioner("revolver", wiki, K, checkpoint_dir=td, resume=True,
                                max_steps=9, **reader, **common)
        assert moved.resumed_from == 9 and moved.steps == 9
        np.testing.assert_array_equal(moved.labels, cut.labels)
        np.testing.assert_array_equal(moved.probs, cut.probs)
        # the run continues on the new count from the restored state
        more = run_partitioner("revolver", wiki, K, checkpoint_dir=td, resume=True,
                               max_steps=12, **reader, **common)
        assert more.resumed_from == 9 and more.steps == 12
        assert ((more.labels >= 0) & (more.labels < K)).all()
        assert not np.array_equal(more.labels, cut.labels)


@pytest.mark.parametrize("schedule", ["halo", "async"])
def test_hub_resume_bit_identical_at_an_unchanged_shard_count(wiki, schedule):
    kw = dict(seed=1, max_steps=14, sync_every=3, n_blocks=16, device="cpu", mesh=_mesh(4),
              chunk_schedule=schedule, keep_probs=True, track_history=False,
              halo_threshold=2.0, hub_replication=True, hub_quantile=VCYCLE["quantile"],
              checkpoint_every=3)
    if schedule == "async":
        kw["staleness_bound"] = 1
    with tempfile.TemporaryDirectory() as td:
        ref = run_partitioner("revolver", wiki, K, checkpoint_dir=td + "/ref", **kw)
        run_partitioner("revolver", wiki, K, checkpoint_dir=td + "/cut",
                        **dict(kw, max_steps=8))
        res = run_partitioner("revolver", wiki, K, checkpoint_dir=td + "/cut", resume=True,
                              **kw)
    assert res.resumed_from == 6 and res.steps == ref.steps
    np.testing.assert_array_equal(ref.labels, res.labels)
    np.testing.assert_array_equal(ref.probs, res.probs)


# --------------------------------------------------------------------------
# the V-cycle with a sharded, halo, hub finest level
# --------------------------------------------------------------------------
def _jax_vcycles() -> dict:
    from repro.core.runner import run_partitioner as jrun
    from repro.graphs import load_dataset as jload
    from repro.launch.mesh import make_blocks_mesh as jmesh

    g = jload(VCYCLE["dataset"], scale=VCYCLE["scale"], seed=0)
    out = []
    for seed in VCYCLE["seeds"]:
        r = jrun("revolver", g, K, seed=seed, mode="vcycle", track_history=False,
                 mesh=jmesh(VCYCLE["shards"]), **FINE)
        out.append({"local_edges": r.local_edges, "max_norm_load": r.max_norm_load})
    return {"vcycle": out}


def _worker(out_path: str) -> int:
    assert jax.device_count() >= VCYCLE["shards"], jax.device_count()
    with open(out_path, "w") as f:
        json.dump(_jax_vcycles(), f)
    return 0


@pytest.fixture(scope="module")
def jax_vcycles(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_elastic") / "vcycle.json"
    env = dict(os.environ)
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_force_host_platform_device_count")]
    env["XLA_FLAGS"] = " ".join(
        flags + [f"--xla_force_host_platform_device_count={VCYCLE['shards']}"])
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(out) as f:
        return json.load(f)["vcycle"]


def _levels(monkeypatch):
    """Record every level run of a V-cycle: (vertices, schedule, labels)."""
    calls = []
    run = runner_mod.run_partitioner

    def recording(algo, graph, k, **kw):
        res = run(algo, graph, k, **kw)
        calls.append((graph.n, kw.get("chunk_schedule", "sequential"), res.labels))
        return res

    monkeypatch.setattr(runner_mod, "run_partitioner", recording)
    return calls


def test_vcycle_fine_level_schedule_knobs(monkeypatch, jax_vcycles):
    g = load_dataset(VCYCLE["dataset"], scale=VCYCLE["scale"], seed=0)
    seq_calls = _levels(monkeypatch)
    seq = run_partitioner("revolver", g, K, seed=VCYCLE["seeds"][0], mode="vcycle",
                          device="cpu", track_history=False)
    monkeypatch.undo()
    ours = []
    for seed in VCYCLE["seeds"]:
        fine_calls = _levels(monkeypatch)
        res = run_partitioner("revolver", g, K, seed=seed, mode="vcycle", device="cpu",
                              track_history=False, mesh=_mesh(VCYCLE["shards"]), **FINE)
        monkeypatch.undo()
        assert fine_calls[-1][:2] == (g.n, "halo")
        assert all(sched == "sequential" for _, sched, _ in fine_calls[:-1])
        assert res.vcycle["level_n_blocks"][0] % VCYCLE["shards"] == 0
        assert res.labels.shape == (g.n,) and ((res.labels >= 0) & (res.labels < K)).all()
        ours.append(res)
        if seed == VCYCLE["seeds"][0]:
            # the coarse levels equal the sequential V-cycle's, level by level
            assert len(seq_calls) == len(fine_calls) > 2
            for (n_a, _, lab_a), (n_b, _, lab_b) in zip(seq_calls[:-1], fine_calls[:-1]):
                assert n_a == n_b
                np.testing.assert_array_equal(lab_a, lab_b)
            assert res.vcycle["steps_per_level"][1:] == seq.vcycle["steps_per_level"][1:]
    le = np.mean([r.local_edges for r in ours])
    le_ref = np.mean([r["local_edges"] for r in jax_vcycles])
    assert le >= 0.97 * le_ref, (le, le_ref)
    assert all(r.max_norm_load <= 1.30 for r in ours), [r.max_norm_load for r in ours]


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1]))
