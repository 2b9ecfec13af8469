"""Checkpointing of nested tensor trees: npz payload + JSON manifest, async
save (the port of `repro.checkpoint.store`, one device, same file format).

Layout:  <dir>/step_<n>/arrays.npz  +  <dir>/step_<n>/manifest.json
Array keys are the tree paths joined by ``/`` (``::`` inside the npz), the
manifest is ``{"format": 1, "step", "keys": {path: {shape, dtype}},
"meta"}``. Writes go to a tmp dir renamed into place after the payload and
manifest are fsynced, so a checkpoint directory is either absent or
complete and durable — a crash mid-save leaves only a ``.tmp`` dir that
`latest_step` ignores. Checkpoints written by `repro`'s store read here,
and the other way round.

A tree is nested dicts, NamedTuples, lists and tuples; its leaves are
tensors, numpy arrays or scalars. Saving snapshots the leaves without
blocking (`Snapshot`): CUDA tensors are copied into pinned host buffers
with ``non_blocking=True`` on their current stream, behind which a CUDA
event is recorded; the writer waits on that event before it reads the
buffers. CPU tensors are cloned at once (the engine updates its state
tensors in place). bf16 leaves are written as their 2-byte patterns, as
`repro` writes them (``np.load`` returns them as ``|V2``), and rebuilt from
the manifest's dtype string through an int16 view on restore.

The manifest's opaque ``meta`` dict carries host-side loop state (score
stall counters, step counts) that must survive a crash with the state.

Fault-injection points (`repro_torch.faults`, no-ops unless a plan is
active): ``save-payload`` after the npz write, ``save`` right before the
atomic rename — the two torn-write shapes a resume must tolerate.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
from typing import List, Optional

import numpy as np
import torch

from repro_torch import faults

_FORMAT = 1


class CheckpointError(ValueError):
    """An on-disk checkpoint exists but cannot be read back (corrupt or
    truncated payload, unreadable manifest). Subclasses ValueError so
    callers catching the store's shape/dtype errors catch this too."""


def _children(node):
    """``[(key, child)]`` of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return sorted(node.items())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(node._asdict().items())
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _flatten(tree, prefix: str = "") -> dict:
    """``{"a/b/0": leaf}`` in `repro`'s key order (sorted dict keys)."""
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out = {}
    for key, child in kids:
        out.update(_flatten(child, f"{prefix}/{key}" if prefix else str(key)))
    return out


def _rebuild(like, leaf_fn, prefix: str = ""):
    """``like``'s structure with every leaf replaced by ``leaf_fn(path,
    leaf)``."""
    kids = _children(like)
    if kids is None:
        return leaf_fn(prefix, like)
    built = {key: _rebuild(child, leaf_fn, f"{prefix}/{key}" if prefix else str(key))
             for key, child in kids}
    if isinstance(like, dict):
        return built
    if hasattr(like, "_fields"):
        return type(like)(**built)
    return type(like)(built[i] for i in range(len(like)))


def unflatten(flat: dict) -> dict:
    """Nested dicts from ``{"a/b": leaf}`` keys (list indices stay string
    keys)."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *inner, last = path.split("/")
        for part in inner:
            node = node.setdefault(part, {})
        node[last] = leaf
    return out


def _dtype_name(t: torch.Tensor) -> str:
    return "bfloat16" if t.dtype == torch.bfloat16 else str(t.numpy().dtype)


def _host_numpy(v) -> np.ndarray:
    """A host leaf as numpy: bf16 tensors as their 2-byte patterns (``V2``,
    what `repro`'s store writes for them)."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view("V2")
        return v.numpy()
    return np.asarray(v)


def tensor_from_array(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A CPU tensor from a loaded npz array; a bf16 leaf (``|V2`` without
    ``ml_dtypes``) is rebuilt from the manifest's dtype string."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


class Snapshot:
    """Host copies of a tree's leaves, taken without blocking the host.

    CUDA leaves are copied into pinned buffers with ``non_blocking=True``;
    an event recorded behind the copies tells `host_arrays` when they have
    landed. A caller that fetches anything afterwards on the same stream
    (the runner's window drain) has them complete by the time that fetch
    returns."""

    def __init__(self, tree):
        self.leaves: dict = {}
        self.dtypes: dict = {}
        self._events = []
        for key, v in _flatten(tree).items():
            if isinstance(v, torch.Tensor):
                v = v.detach()
                if v.device.type == "cuda":
                    host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    host.copy_(v, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(v.device))
                    self._events.append(event)
                else:
                    host = v.clone()
                self.leaves[key] = host
                self.dtypes[key] = _dtype_name(host)
            else:
                host = np.array(v)
                self.leaves[key] = host
                self.dtypes[key] = str(host.dtype)
        self.nbytes = sum(int(v.numel() * v.element_size()) if isinstance(v, torch.Tensor)
                          else int(v.nbytes) for v in self.leaves.values())

    def host_arrays(self) -> dict:
        """Wait for the copies, then ``{path: numpy array}``."""
        for event in self._events:
            event.synchronize()
        return {k: _host_numpy(v) for k, v in self.leaves.items()}


def _write_npz(f, arrays: dict) -> None:
    """The file ``np.savez(f, **arrays)`` writes (a stored zip of ``.npy``
    members), each array's bytes handed to its member in one write, so the
    CRC and the file write run with the GIL released. ``np.savez`` copies
    16 MiB chunks under the GIL, which a writer thread then takes from the
    thread that dispatches the supersteps."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in arrays.items():
            arr = np.asarray(arr)
            if not arr.flags.c_contiguous:
                arr = arr.copy(order="C")
            with zf.open(key + ".npy", "w", force_zip64=True) as out:
                np.lib.format.write_array_header_1_0(
                    out, np.lib.format.header_data_from_array_1_0(arr))
                out.write(memoryview(arr.reshape(-1).view(np.uint8)))


def _fsync_dir(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class Handle:
    """Async-save handle. `wait()` joins the writer thread and re-raises
    anything it raised — a swallowed ENOSPC is a checkpoint that does not
    exist when the resume needs it. ``wait_s`` / ``write_s``: the writer's
    seconds waiting on the snapshot's copies and writing the files."""

    def __init__(self, thread: Optional[threading.Thread] = None):
        self._thread = thread
        self._exc: Optional[BaseException] = None
        self.wait_s = 0.0
        self.write_s = 0.0

    def done(self) -> bool:
        return self._thread is None or not self._thread.is_alive()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


def save_checkpoint(ckpt_dir: str, step: int, tree, *, async_save=False,
                    meta: Optional[dict] = None,
                    keep: Optional[int] = None) -> Handle:
    """Write one checkpoint; returns a `Handle` (`wait()` is a no-op when
    synchronous, and re-raises writer-thread failures when async).

    ``tree`` is a tree of tensors / arrays or a `Snapshot` of one. The
    snapshot is taken *before* this returns, so async saves are safe
    against the next superstep's in-place updates. ``meta`` is stored in
    the manifest; ``keep`` prunes all but the newest N complete
    checkpoints after the rename (crash-safe: pruning only ever removes
    older, complete steps).
    """
    snap = tree if isinstance(tree, Snapshot) else Snapshot(tree)
    handle = Handle()

    def _write():
        t0 = time.perf_counter()
        host = snap.host_arrays()
        t1 = time.perf_counter()
        handle.wait_s = t1 - t0
        os.makedirs(ckpt_dir, exist_ok=True)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            _write_npz(f, {k.replace("/", "::"): v for k, v in host.items()})
            f.flush()
            os.fsync(f.fileno())
        faults.fire("save-payload")
        manifest = {
            "format": _FORMAT,
            "step": step,
            "keys": {k: {"shape": list(v.shape), "dtype": snap.dtypes[k]}
                     for k, v in host.items()},
            "meta": meta or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        faults.fire("save")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(ckpt_dir)
        if keep is not None and keep > 0:
            for old in all_steps(ckpt_dir)[:-keep]:
                shutil.rmtree(os.path.join(ckpt_dir, f"step_{old:08d}"),
                              ignore_errors=True)
        handle.write_s = time.perf_counter() - t1

    if async_save:
        def _guarded():
            try:
                _write()
            except BaseException as e:   # re-raised by Handle.wait
                handle._exc = e

        handle._thread = threading.Thread(target=_guarded, daemon=True)
        handle._thread.start()
        return handle
    _write()
    return handle


def _manifest_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")


def load_manifest(ckpt_dir: str, step: int) -> dict:
    """Read one checkpoint's manifest; `CheckpointError` if unreadable."""
    try:
        with open(_manifest_path(ckpt_dir, step)) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointError(
            f"unreadable manifest for step {step} in {ckpt_dir}: {e}") from e
    if "step" not in manifest or "keys" not in manifest:
        raise CheckpointError(
            f"manifest for step {step} in {ckpt_dir} lacks required keys")
    return manifest


def _valid(ckpt_dir: str, step: int) -> bool:
    try:
        load_manifest(ckpt_dir, step)
        return True
    except CheckpointError:
        return False


def all_steps(ckpt_dir: str) -> List[int]:
    """Sorted steps of *complete* checkpoints: a ``step_<n>`` dir counts
    only if its manifest exists and parses — half-written ``.tmp`` dirs and
    directories with a missing/corrupt manifest are skipped, never
    returned as a resume candidate."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        if not d.startswith("step_") or d.endswith(".tmp"):
            continue
        try:
            step = int(d.split("_")[1])
        except (IndexError, ValueError):
            continue
        if _valid(ckpt_dir, step):
            steps.append(step)
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _under(path: str, prefix: Optional[str]) -> bool:
    return prefix is None or path == prefix or path.startswith(prefix + "/")


def load_checkpoint_arrays(ckpt_dir: str, step: int, prefix: Optional[str] = None):
    """Raw host-side load: ``(arrays, manifest)`` with numpy arrays keyed
    by the flattened tree path, as ``np.load`` returns them (bf16 leaves as
    ``|V2``). The entry point for callers whose array shapes are
    data-dependent (the streaming state) and for tools inspecting a
    checkpoint directly. With ``prefix`` (a subtree's path, e.g.
    ``"params"``) only that subtree's arrays are read from the file."""
    manifest = load_manifest(ckpt_dir, step)
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    try:
        with np.load(path) as z:
            arrays = {k.replace("::", "/"): z[k] for k in z.files
                      if _under(k.replace("::", "/"), prefix)}
    except Exception as e:
        raise CheckpointError(
            f"corrupt checkpoint payload for step {step} in {ckpt_dir}: "
            f"{e}") from e
    missing = {k for k in manifest["keys"] if _under(k, prefix)} - set(arrays)
    if missing:
        raise CheckpointError(
            f"checkpoint payload for step {step} lacks arrays listed in its "
            f"manifest: {sorted(missing)[:5]} ...")
    return arrays, manifest


def load_checkpoint_tensors(ckpt_dir: str, step: int, device="cpu",
                            prefix: Optional[str] = None) -> dict:
    """``{path: tensor}`` on ``device``, bf16 leaves rebuilt (see
    `tensor_from_array`); with ``prefix``, only that subtree's."""
    arrays, manifest = load_checkpoint_arrays(ckpt_dir, step, prefix)
    return {k: tensor_from_array(a, manifest["keys"].get(k, {}).get("dtype", "")).to(device)
            for k, a in arrays.items()}


def restore_checkpoint(ckpt_dir: str, step: int, like, *, device=None):
    """Restore into the structure of ``like`` (a tree of tensors, e.g. on
    the ``meta`` device): every leaf a tensor of the ``like`` leaf's shape
    and dtype, on ``device`` (default: the ``like`` leaf's device).
    KeyError for a path the checkpoint lacks, ValueError for a shape that
    differs."""
    arrays, manifest = load_checkpoint_arrays(ckpt_dir, step)
    flat_like = _flatten(like)
    missing = set(flat_like) - set(arrays)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")

    def leaf(path, want):
        arr = arrays[path]
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"{path}: ckpt {arr.shape} vs expected {tuple(want.shape)}")
        t = tensor_from_array(arr, manifest["keys"].get(path, {}).get("dtype", ""))
        dev = want.device if device is None else torch.device(device)
        return t.to(device=dev, dtype=want.dtype)

    return _rebuild(like, leaf)
