"""The port's checkpoint store (`repro_torch.checkpoint`) on the CPU, case
for case with tests/test_checkpoint.py (the elastic re-shard case waits
for the port's multi-GPU schedules), plus its format against
`repro.checkpoint.store`: each reads what the other writes, bf16 leaves
included, and the serving CLI restores a `repro`-written parameter
checkpoint."""
import json
import os
import shutil
import tempfile
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
ml_dtypes = pytest.importorskip("ml_dtypes")

from repro.checkpoint import load_checkpoint_arrays as jax_load_arrays
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import registry as jregistry
from repro.models import init_lm as jinit_lm

from repro_torch.checkpoint import (
    CheckpointError,
    all_steps,
    latest_step,
    load_checkpoint_arrays,
    load_checkpoint_tensors,
    load_manifest,
    restore_checkpoint,
    save_checkpoint,
    unflatten,
)
from repro_torch.configs import registry
from repro_torch.launch import serve as serve_cli
from repro_torch.models import init_cache, lm_prefill
from repro_torch.models.convert import lm_params_from_numpy

TREE = {"a": torch.arange(12.0, dtype=torch.float32).reshape(3, 4),
        "b": {"c": torch.ones(5, dtype=torch.int32)}}


def _step_dir(td, step):
    return os.path.join(td, f"step_{step:08d}")


def _like(tree, **dtypes):
    return {"a": torch.empty(3, 4, dtype=dtypes.get("a", torch.float32), device="meta"),
            "b": {"c": torch.empty(5, dtype=dtypes.get("c", torch.int32), device="meta")}}


def test_async_wait_reraises_writer_failure():
    with tempfile.TemporaryDirectory() as td:
        blocker = os.path.join(td, "blocker")
        with open(blocker, "w") as f:
            f.write("x")
        handle = save_checkpoint(os.path.join(blocker, "nested"), 1, TREE, async_save=True)
        with pytest.raises(OSError):
            handle.wait()
        handle.wait()


def test_async_save_completes_and_loads():
    with tempfile.TemporaryDirectory() as td:
        save_checkpoint(td, 5, TREE, async_save=True, meta={"tag": 7}).wait()
        arrays, manifest = load_checkpoint_arrays(td, 5)
        assert manifest["meta"] == {"tag": 7}
        np.testing.assert_array_equal(arrays["a"], TREE["a"].numpy())
        np.testing.assert_array_equal(arrays["b/c"], TREE["b"]["c"].numpy())


def test_async_save_snapshots_before_returning():
    """The engine updates its state tensors in place right after a save is
    started: the checkpoint holds the values at the call."""
    state = {"x": torch.arange(6.0)}
    with tempfile.TemporaryDirectory() as td:
        handle = save_checkpoint(td, 1, state, async_save=True)
        state["x"].add_(100.0)
        handle.wait()
        np.testing.assert_array_equal(load_checkpoint_arrays(td, 1)[0]["x"], np.arange(6.0))


def test_corrupt_npz_is_checkpoint_error():
    with tempfile.TemporaryDirectory() as td:
        save_checkpoint(td, 1, TREE)
        with open(os.path.join(_step_dir(td, 1), "arrays.npz"), "wb") as f:
            f.write(b"not a zip archive")
        with pytest.raises(CheckpointError):
            load_checkpoint_arrays(td, 1)
        with pytest.raises(CheckpointError):
            restore_checkpoint(td, 1, _like(TREE))


def test_truncated_npz_is_checkpoint_error():
    with tempfile.TemporaryDirectory() as td:
        save_checkpoint(td, 1, TREE)
        path = os.path.join(_step_dir(td, 1), "arrays.npz")
        data = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(data[: len(data) // 2])
        with pytest.raises(CheckpointError):
            load_checkpoint_arrays(td, 1)


def test_payload_missing_manifest_key_is_checkpoint_error():
    with tempfile.TemporaryDirectory() as td:
        save_checkpoint(td, 1, TREE)
        path = os.path.join(_step_dir(td, 1), "arrays.npz")
        with np.load(path) as z:
            partial = {k: z[k] for k in z.files if k != "a"}
        np.savez(path, **partial)
        with pytest.raises(CheckpointError):
            load_checkpoint_arrays(td, 1)


def test_missing_or_invalid_manifest_skipped_by_latest_step():
    with tempfile.TemporaryDirectory() as td:
        for s in (1, 2, 3):
            save_checkpoint(td, s, TREE)
        os.remove(os.path.join(_step_dir(td, 3), "manifest.json"))
        mpath = os.path.join(_step_dir(td, 2), "manifest.json")
        with open(mpath, "w") as f:
            f.write('{"step": 2, "ke')
        assert all_steps(td) == [1]
        assert latest_step(td) == 1
        with open(mpath, "w") as f:
            json.dump({"something": "else"}, f)
        assert latest_step(td) == 1
        with pytest.raises(CheckpointError):
            load_manifest(td, 2)


def test_leftover_tmp_dirs_ignored():
    with tempfile.TemporaryDirectory() as td:
        save_checkpoint(td, 4, TREE)
        shutil.copytree(_step_dir(td, 4), _step_dir(td, 9) + ".tmp")
        os.makedirs(os.path.join(td, "step_junk"))
        os.makedirs(os.path.join(td, "unrelated"))
        assert all_steps(td) == [4]
        assert latest_step(td) == 4


def test_restore_dtype_cast_and_shape_mismatch():
    with tempfile.TemporaryDirectory() as td:
        save_checkpoint(td, 1, TREE)
        out = restore_checkpoint(td, 1, _like(TREE, a=torch.float16, c=torch.float32),
                                 device="cpu")
        assert out["a"].dtype == torch.float16 and out["a"].device.type == "cpu"
        assert out["b"]["c"].dtype == torch.float32
        bad = {"a": torch.empty(4, 3, device="meta"),
               "b": {"c": torch.empty(5, dtype=torch.int32, device="meta")}}
        with pytest.raises(ValueError):
            restore_checkpoint(td, 1, bad, device="cpu")
        with pytest.raises(KeyError):
            restore_checkpoint(td, 1, dict(_like(TREE), extra=torch.empty(1, device="meta")),
                               device="cpu")


def test_npz_payload_is_what_np_savez_writes():
    """The payload writer hands each array to its zip member in one write;
    the file holds what ``np.savez`` would (C and Fortran order, 0-dim,
    empty, bool and 2-byte void leaves)."""
    from repro_torch.checkpoint.store import _write_npz

    grid = np.arange(10, dtype=np.float32).reshape(2, 5)
    arrays = {"c": grid, "f": grid.T, "s": np.float32(3.5), "v": np.zeros(3, "V2"),
              "e": np.zeros(0, np.int64), "b": np.array([True, False])}
    with tempfile.TemporaryDirectory() as td:
        ours, ref = os.path.join(td, "ours.npz"), os.path.join(td, "ref.npz")
        with open(ours, "wb") as f:
            _write_npz(f, arrays)
        np.savez(ref, **arrays)
        assert os.path.getsize(ours) == os.path.getsize(ref)
        with np.load(ours) as a, np.load(ref) as b:
            assert a.files == b.files
            for key in b.files:
                assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
                assert a[key].tobytes() == b[key].tobytes()


def test_keep_prunes_only_oldest():
    with tempfile.TemporaryDirectory() as td:
        for s in (1, 2, 3, 4):
            save_checkpoint(td, s, TREE, keep=2)
        assert all_steps(td) == [3, 4]


class _Pair(NamedTuple):
    labels: torch.Tensor
    probs: torch.Tensor


def test_named_tuples_lists_and_scalars_round_trip():
    tree = {"state": _Pair(torch.arange(4, dtype=torch.int32), torch.rand(2, 3)),
            "hist": [torch.zeros(2), np.ones(3, np.int64)], "step": np.int64(7)}
    with tempfile.TemporaryDirectory() as td:
        save_checkpoint(td, 2, tree)
        _, manifest = load_checkpoint_arrays(td, 2)
        assert sorted(manifest["keys"]) == ["hist/0", "hist/1", "state/labels",
                                            "state/probs", "step"]
        like = {"state": _Pair(torch.empty(4, dtype=torch.int32, device="meta"),
                               torch.empty(2, 3, device="meta")),
                "hist": [torch.empty(2, device="meta"),
                         torch.empty(3, dtype=torch.int64, device="meta")],
                "step": torch.empty((), dtype=torch.int64, device="meta")}
        out = restore_checkpoint(td, 2, like, device="cpu")
        assert isinstance(out["state"], _Pair) and isinstance(out["hist"], list)
        assert torch.equal(out["state"].probs, tree["state"].probs)
        assert int(out["step"]) == 7


def _mixed_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16),
                       "b": rng.standard_normal(5).astype(np.float32)},
            "step": np.arange(3, dtype=np.int32), "gen": np.arange(16, dtype=np.uint8)}


def test_reads_reference_checkpoints_bf16_included():
    """A `repro`-written checkpoint: the port's raw load equals `repro`'s
    (arrays and manifest), and its tensors carry the bf16 bits exactly."""
    tree = _mixed_tree()
    with tempfile.TemporaryDirectory() as td:
        jax_save_checkpoint(td, 3, tree, meta={"steps": 3})
        ours, our_manifest = load_checkpoint_arrays(td, 3)
        ref, ref_manifest = jax_load_arrays(td, 3)
        assert our_manifest == ref_manifest
        assert ours.keys() == ref.keys()
        for key in ref:
            assert ours[key].dtype == ref[key].dtype
            assert ours[key].tobytes() == ref[key].tobytes()
        tensors = load_checkpoint_tensors(td, 3)
        w = tensors["params/w"]
        assert w.dtype == torch.bfloat16
        np.testing.assert_array_equal(w.view(torch.int16).numpy(),
                                      tree["params"]["w"].view(np.int16))
        np.testing.assert_array_equal(tensors["gen"].numpy(), tree["gen"])
        assert unflatten(tensors)["params"].keys() == {"w", "b"}


def test_reference_reads_port_checkpoints_bf16_included():
    tree = _mixed_tree(1)
    ours = {"params": {"w": torch.from_numpy(tree["params"]["w"].view(np.int16)).view(
        torch.bfloat16), "b": torch.from_numpy(tree["params"]["b"])},
        "step": torch.from_numpy(tree["step"]), "gen": torch.from_numpy(tree["gen"])}
    with tempfile.TemporaryDirectory() as td, tempfile.TemporaryDirectory() as tr:
        save_checkpoint(td, 3, ours, meta={"steps": 3})
        jax_save_checkpoint(tr, 3, tree, meta={"steps": 3})
        got, got_manifest = jax_load_arrays(td, 3)
        want, want_manifest = jax_load_arrays(tr, 3)
        assert got_manifest == want_manifest
        for key in want:
            assert got[key].dtype == want[key].dtype
            assert got[key].tobytes() == want[key].tobytes()


def test_serve_cli_restores_a_reference_parameter_checkpoint(monkeypatch, capsys, tmp_path):
    """``--ckpt-dir`` restores the ``params`` tree of `repro`'s newest
    checkpoint of a reduced tinyllama: the model served has the prefill
    logits of `lm_params_from_numpy` on the same tree."""
    arch = "tinyllama-1.1b"
    jcfg, cfg = jregistry.get_config(arch).reduced(), registry.get_config(arch).reduced()
    params = jax.tree.map(np.asarray, jax.device_get(jinit_lm(jcfg, jax.random.PRNGKey(4))))
    jax_save_checkpoint(str(tmp_path), 2, {"params": jinit_lm(jcfg, jax.random.PRNGKey(9))})
    jax_save_checkpoint(str(tmp_path), 7, {"params": params})
    served = []
    real_engine = serve_cli.Engine

    def engine(cfg_, model, **kw):
        served.append(model)
        return real_engine(cfg_, model, **kw)

    monkeypatch.setattr(serve_cli, "Engine", engine)
    serve_cli.main(["--arch", arch, "--reduced", "--device", "cpu", "--ckpt-dir",
                    str(tmp_path), "--batch", "2", "--prompt-len", "8", "--max-new", "2"])
    assert "restored params from step 7" in capsys.readouterr().out
    want = lm_params_from_numpy(cfg, params, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)).astype(
        np.int32))
    got_l, _ = lm_prefill(served[0], cfg, init_cache(cfg, 2, 16, "cpu"), {"tokens": tokens})
    want_l, _ = lm_prefill(want, cfg, init_cache(cfg, 2, 16, "cpu"), {"tokens": tokens})
    assert torch.equal(got_l, want_l)
