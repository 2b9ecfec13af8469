"""Build and bind the hand-written CUDA kernels (nvcc + ctypes).

Each source under ``csrc/`` (with the headers it includes from there) is
compiled on first use into its own shared library with a plain C
interface, under ``build/repro_torch/`` at the root of the checkout, and
loaded with `ctypes`. Library names carry a hash of the source, the
headers and the flags, so an edited source never loads a stale build.
Nothing is built or loaded at import time: the CPU tests import every
module on a machine without ``nvcc``.

Each C entry point enqueues its kernel on the stream it is given and returns
``cudaGetLastError()``; `check` raises on a non-zero code. Pointers and the
stream are passed as ``c_void_p``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

from repro_torch import obs

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"

_COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# per-source extra flags: the LA update and the hub reconcile must not fuse
# multiply-adds, so their rounding matches the plain versions' separate
# tensor ops
_EXTRA_FLAGS = {"edge_phase": (), "la_update": ("-fmad=false",),
                "edge_histogram": (), "flash_attention": (),
                "decode_attention": (), "wkv6": (), "hub_reconcile": ("-fmad=false",),
                "swiglu": ()}
_VOID = ctypes.c_void_p
_ARGTYPES = {
    # dst, w, row_ptr, spans, hubs, labels, lam, actions, feasible, hist,
    # wacc, partial; nb, e_max, block_v, k, neighbor, n_span, n_hub,
    # row_cap, vec, smem; stream
    "edge_phase": ([_VOID] * 12 + [ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_int] * 8 + [_VOID]),
    "la_update": ([_VOID] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_float,
                                 ctypes.c_int, _VOID]),
    # idx, vals, row_ptr, spans, hubs, labels, hist, partial; nb, e_max,
    # block_v, k, route, n_span, n_hub, row_cap, vec, smem; stream
    "edge_histogram": ([_VOID] * 8 + [ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_int] * 8 + [_VOID]),
    # q, k, v, o; b, hq, hkv, sq, skv, d, causal, window; scale; dtype; stream
    "flash_attention": ([_VOID] * 4 + [ctypes.c_int] * 8
                        + [ctypes.c_float, ctypes.c_int, _VOID]),
    # q, k, v, kv_len, o, m, l; b, hq, hkv, s_max, d, n_split, chunk; scale;
    # dtype; stream
    "decode_attention": ([_VOID] * 7 + [ctypes.c_int] * 7
                         + [ctypes.c_float, ctypes.c_int, _VOID]),
    # r, k, v, logw, u, state, y, s_loc, r_eff, w_tot; b, s, h, n; stream
    "wkv6": [_VOID] * 10 + [ctypes.c_int] * 4 + [_VOID],
    # votes, cur, deg, owner, loads, cap, winners, list; hub_pad, k; stream
    "hub_reconcile": [_VOID] * 8 + [ctypes.c_int] * 2 + [_VOID],
    # gate, up, out; n; stream
    "swiglu": [_VOID] * 3 + [ctypes.c_longlong, _VOID],
}
KERNELS = tuple(_EXTRA_FLAGS)

_lock = threading.Lock()
_libs: dict = {}


class LaunchCounter:
    """How often a wrapper launched its kernel (plain-version calls and
    failed launches are not counted)."""

    def __init__(self) -> None:
        self.count = 0

    def add(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin; "
                       "the CUDA kernels cannot be built")


def _flags(name: str) -> tuple:
    return _COMMON_FLAGS + _EXTRA_FLAGS[name]


def library_path(name: str) -> pathlib.Path:
    """Where kernel ``name``'s library is built: named by a hash of its
    source, the shared headers under ``csrc/`` and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict:
    """Compile the named kernels that have no current build, all nvcc
    processes started together. Returns ``{name: ptxas report}`` for what
    was compiled here; raises RuntimeError with nvcc's output on failure."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)       # atomic: a reader sees no partial library
        reports[name] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The bound library of kernel ``name``, built first if needed; a
    compile event (`repro_torch.obs.record_compile`, region = the kernel's
    name) is recorded on its first use in a process when a tracer is
    current."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            t0 = time.perf_counter()
            built = bool(build((name,)))
            # the port's counterpart of a jit compile: the kernel's first use
            # in this process (an nvcc build, or a cached library's load)
            obs.record_compile(name, kernel=name, built=built,
                               seconds=time.perf_counter() - t0)
            lib = ctypes.CDLL(str(library_path(name)))
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = _ARGTYPES[name]
            fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} ({msg})")
