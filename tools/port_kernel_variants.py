#!/usr/bin/env python3
"""A/B timing of the port's redesigned K1 (edge phase) and K6 (RWKV6
recurrence) kernels on one CUDA device, at the main path's shapes.

    python3 tools/port_kernel_variants.py [--skip-k1] [--skip-prefill] [--parent DIR]

Every variant is a copy of a kernel source with a compile-time constant
(or a function body) replaced, built with nvcc into ``build/variants/``.

K6 at the rwkv6-3b prefill shape [8, 1024, 32, 80] f32: copies of
``wkv6.cu`` with another chunk length (64 to 512; the wrapper's CHUNK is
set to match while the copy runs), block step or row parts of the local
pass, or token groups, row groups or columns of a
stitch CTA. Each is held to its plain version at WKV_TOL, then timed as a
CUDA-graph replay (median of 30, L2 flushed before each,
``chip_smoke.graph_ms``) in the order a, b, ..., ..., b, a, with the device
time of each kernel it launches under torch.profiler. Two ablations of the
local pass (timed only, their results wrong) show what its parts cost.
Then K6 below one chunk at [8, S, 32, 80] for S = 1 to 200: the committed
routing (the token-serial kernel below kSpreadFrom tokens, the spread
kernel from there), each kernel alone, and the spread kernel with a (b,
h)'s value columns split over 2 or 4 CTAs, or with a thread's state rows
contiguous (g N/16 + i) instead of interleaved (g + 16 i).

K1 at block 0 of the full WIKI layout (k = 8, both weight modes; the graph
is built on the host in a thread while K6 runs): span plans of 1024, 2048
and 4096 entries, CTAs of 32 (one warp a span), 256 and 512 threads, and
the committed shared atomics (one an entry) against warp-aggregated ones
(the lanes of a warp that share a key added first, __match_any_sync +
__reduce_add_sync, then one atomic). Each is held bit-equal to the plain
version, then timed eager as the main path calls it
(``chip_smoke.time_ms``) and as a graph replay.

With ``--parent DIR`` (a checkout of the parent commit, e.g. unpacked from
``git archive`` under ``build/``), the parent's K1 and K6 are built from
DIR and timed on the same inputs, in the order parent, change, change,
parent.

Prints the card's name and power limit, each variant's ptxas registers and
spills, then one JSON line per variant.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys
import threading

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "variants"

THREADS = "constexpr int kThreads = 256;"
ATOMIC_ADD = "  if (valid) atomicAdd(s + key, v);\n"
AGGREGATED_ADD = """  const unsigned live = __ballot_sync(0xffffffffu, valid);
  if (valid) {
    const unsigned group = __match_any_sync(live, key);
    const int sum = (int)__reduce_add_sync(group, (unsigned)v);
    if ((int)(threadIdx.x & 31) == __ffs(group) - 1) atomicAdd(s + key, sum);
  }
"""
CHUNK = "constexpr int kChunk = 256;"
BLOCK = "constexpr int kBlock = 4;"
ROW_PARTS = "constexpr int kRowParts = 4;"
GROUPS = "constexpr int kStitchGroups = 4;"
TOKENS = "constexpr int kStitchTokens = 2;"
STITCH_COLS = "constexpr int kStitchCols = 80;"
SPREAD_FROM = "constexpr int kSpreadFrom = 8;"
SPREAD_CTAS = "constexpr int kSpreadCtas = 1;"
SPREAD_ROWS = "  auto row = [&](int i) { return g + NG * i; };"
K6_VARIANTS = {  # name: (source substitutions, chunk)
    "committed (L 256)": ({}, 256),
    "local block step 1 token": ({BLOCK: "constexpr int kBlock = 1;"}, 256),
    "local block step 2 tokens": ({BLOCK: "constexpr int kBlock = 2;"}, 256),
    "local block step 8 tokens": ({BLOCK: "constexpr int kBlock = 8;"}, 256),
    "L 64": ({CHUNK: "constexpr int kChunk = 64;"}, 64),
    "L 128": ({CHUNK: "constexpr int kChunk = 128;"}, 128),
    "L 512": ({CHUNK: "constexpr int kChunk = 512;"}, 512),
    "stitch token groups 4": ({TOKENS: "constexpr int kStitchTokens = 4;"}, 256),
    "stitch row groups 2": ({GROUPS: "constexpr int kStitchGroups = 2;"}, 256),
    "stitch 16 columns a CTA": ({STITCH_COLS: "constexpr int kStitchCols = 16;"}, 256),
    "local row parts 2": ({ROW_PARTS: "constexpr int kRowParts = 2;"}, 256),
}
K6_DECODE_VARIANTS = {  # name: source substitutions
    "committed": {},
    "token-serial kernel only": {SPREAD_FROM: "constexpr int kSpreadFrom = 256;"},
    "spread kernel only": {SPREAD_FROM: "constexpr int kSpreadFrom = 1;"},
    "spread, 2 CTAs a (b, h)": {SPREAD_FROM: "constexpr int kSpreadFrom = 1;",
                                SPREAD_CTAS: "constexpr int kSpreadCtas = 2;"},
    "spread, rows contiguous": {SPREAD_FROM: "constexpr int kSpreadFrom = 1;",
                                SPREAD_ROWS: SPREAD_ROWS.replace("g + NG * i", "g * NPG + i")},
}
BLOCK_LOOP = "    for (int blk = 0; blk < nblk; ++blk) {"
K6_ABLATIONS = {  # the local pass with a part cut out: timed only
    "local pass without its block steps": {BLOCK_LOOP: BLOCK_LOOP.replace("blk < nblk", "blk < 0")},
    "local pass without its per-index pass": {"      if (n < N) {": "      if (n < 0) {"},
}
_VOID = ctypes.c_void_p
# the parent's C entry points: the row-walk K1, the token-serial K6
PARENT_ARGTYPES = {
    "edge_phase": [_VOID] * 9 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, _VOID],
    "wkv6": [_VOID] * 7 + [ctypes.c_int] * 4 + [_VOID],
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def device_ms_by_kernel(torch, fn, calls: int = 10) -> dict:
    """Device time per call of each kernel ``fn`` launches, by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            found = re.search(r"\w+_kernel\w*(<[^>]*>)?", e.name)
            name = found.group(0) if found else e.name[:60]
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / calls
    return out


def nvcc_library(src: pathlib.Path, kernel: str, name: str, argtypes) -> ctypes.CDLL:
    """Build ``src`` with the port's flags into ``build/variants/`` and bind
    its ``<kernel>_launch``."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    lib_path = OUT / (kernel + "_" + re.sub(r"\W+", "_", name) + ".so")
    log = subprocess.run([_build.nvcc_path(), *_build._flags(kernel), "-o", str(lib_path),
                          str(src)], check=True, capture_output=True, text=True).stdout
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas[{kernel} {name}] {line.strip()}", flush=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, f"{kernel}_launch")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def build_variant(kernel: str, name: str, subs: dict) -> ctypes.CDLL:
    """The committed library, or a copy of ``csrc/<kernel>.cu`` with
    ``subs`` applied, built and bound like `_build.load`'s libraries."""
    from repro_torch.kernels import _build

    if not subs:
        return _build.load(kernel)
    src = (_build.CSRC / f"{kernel}.cu").read_text()
    for old, new in subs.items():
        if old not in src:
            raise RuntimeError(f"{old!r} is not in {kernel}.cu")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / (kernel + "_" + re.sub(r"\W+", "_", name) + ".cu")
    path.write_text(src)
    return nvcc_library(path, kernel, name, _build._ARGTYPES[kernel])


def with_lib(kernel: str, lib, fn, chunk: int | None = None):
    """Call ``fn`` with ``lib`` bound as ``kernel``'s library (and K6's
    wrapper sizing its scratch for chunks of ``chunk`` tokens)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import wkv6 as k6

    saved, saved_chunk = _build._libs.get(kernel), k6.CHUNK
    _build._libs[kernel] = lib
    k6.CHUNK = chunk or saved_chunk
    try:
        return fn()
    finally:
        _build._libs[kernel] = saved
        k6.CHUNK = saved_chunk


def check_launch(lib, code: int) -> None:
    if code:
        raise RuntimeError(f"parent launch failed: {lib.repro_error_string(code).decode()}")


def timed(cs, torch, calls: dict, flush, eager: bool = False) -> dict:
    """{name: [graph ms, ...]} (and eager ms) in the order a, b, ..., b, a."""
    names = list(calls)
    out = {name: {"graph_ms": [], "eager_ms": []} for name in names}
    for name in names + names[::-1]:
        out[name]["graph_ms"].append(cs.graph_ms(torch, calls[name], flush))
        if eager:
            out[name]["eager_ms"].append(cs.time_ms(torch, calls[name], flush))
    return out


def parent_wkv6(torch, parent, args, state, y):
    """A call of the parent's token-serial K6 on ``args`` (state written over
    ``state``), or None without ``--parent``."""
    if parent is None:
        return None
    lib = parent["wkv6"]
    b, s, h, n = args[0].shape
    return lambda: check_launch(lib, lib.wkv6_launch(
        *(t.data_ptr() for t in args[:5]), state.data_ptr(), y.data_ptr(),
        b, s, h, n, torch.cuda.current_stream().cuda_stream)) or (y, state)


def k6_ab(torch, cs, flush, args, state, calls: dict, label: str) -> None:
    """Hold each call (a None is left out) to the plain version at WKV_TOL,
    each writing its final state over ``state``, then time them all."""
    from repro_torch.kernels import wkv6 as k6

    calls = {name: call for name, call in calls.items() if call is not None}
    want = k6.wkv6_plain(*args[:5], args[5].clone())
    s = args[0].shape[1]
    for name, call in calls.items():
        state.copy_(args[5])
        got = call()
        cs.check_close(torch, got[0], want[0], cs.WKV_TOL, f"K6 {name} S {s} y")
        cs.check_close(torch, state, want[1], cs.WKV_TOL, f"K6 {name} S {s} state")
    for name, ms in timed(cs, torch, calls, flush).items():
        emit({"kernel": "wkv6", label: f"[8,{s},32,80]", "variant": name,
              "graph_ms": ms["graph_ms"],
              "device_ms_by_kernel": device_ms_by_kernel(torch, calls[name])})


def k6_variants(torch, cs, flush, parent, prefill: bool) -> None:
    from repro_torch.kernels import wkv6 as k6

    gen = torch.Generator(device="cuda").manual_seed(5)
    if prefill:
        libs = {name: build_variant("wkv6", name, subs)
                for name, (subs, _) in K6_VARIANTS.items()}
        args = cs.wkv6_inputs(torch, gen, 8, 1024, 32, 80, "cuda")
        state = args[5].clone()      # the timed calls write their state over it
        calls = {name: (lambda lib=libs[name], c=K6_VARIANTS[name][1]: with_lib(
            "wkv6", lib, lambda: k6.wkv6_cuda(*args[:5], state), chunk=c))
            for name in K6_VARIANTS}
        calls["parent"] = parent_wkv6(torch, parent, args, state, torch.empty_like(args[0]))
        k6_ab(torch, cs, flush, args, state, calls, "shape")
        for name, subs in K6_ABLATIONS.items():
            lib = build_variant("wkv6", name, subs)
            emit({"kernel": "wkv6", "shape": "[8,1024,32,80]", "ablation": name,
                  "device_ms_by_kernel": device_ms_by_kernel(torch, lambda: with_lib(
                      "wkv6", lib, lambda: k6.wkv6_cuda(*args[:5], state)))})
        del args, state, calls
    libs = {name: build_variant("wkv6", name, subs) for name, subs in K6_DECODE_VARIANTS.items()}
    for s in (1, 2, 4, 8, 16, 64, 200):
        args = cs.wkv6_inputs(torch, gen, 8, s, 32, 80, "cuda")
        state = args[5].clone()
        calls = {name: (lambda lib=libs[name]: with_lib(
            "wkv6", lib, lambda: k6.wkv6_cuda(*args[:5], state))) for name in libs}
        calls["parent"] = parent_wkv6(torch, parent, args, state, torch.empty_like(args[0]))
        k6_ab(torch, cs, flush, args, state, calls, "decode_shape")


def k1_variants(torch, np, cs, flush, g, parent) -> None:
    from repro_torch.core.device_graph import SpanPlan, prepare_device_graph
    from repro_torch.kernels import edge_phase as k1

    dg = prepare_device_graph(g, n_blocks=8, device="cuda")
    args, labels, lam, actions, feasible, live = cs.check_k1_block(torch, dg, cs.SEED)
    bv, k = dg.block_v, cs.K
    host_ptr = dg.blk_row_ptr[:1].cpu().numpy()
    emit({"k1_block": 0, "live_entries": live, "block_v": bv,
          "max_row_entries": int(np.diff(host_ptr[0]).max())})
    adds = {"atomics": {}, "aggregate": {ATOMIC_ADD: AGGREGATED_ADD}}
    libs = {(acc, th): build_variant(
        "edge_phase", f"{acc} {th}",
        {**adds[acc], **({} if th == 256 else {THREADS: f"constexpr int kThreads = {th};"})})
        for acc in adds for th in (32, 256, 512)}
    plans = {se: SpanPlan.from_row_ptr(host_ptr, "cuda", span_edges=se)
             for se in (1024, 2048, 4096)}
    variants = [("atomics", 2048, 256)] + [
        (acc, se, th) for acc in adds for se in plans for th in (32, 256, 512)
        if (acc, se, th) != ("atomics", 2048, 256)]
    for mode in k1.WEIGHT_MODES:
        want = k1.fused_edge_phase_plain(*args, block_v=bv, k=k, weight_mode=mode)
        calls = {f"{acc} {se} {th}": (lambda acc=acc, se=se, th=th: with_lib(
            "edge_phase", libs[acc, th], lambda: k1.fused_edge_phase_cuda(
                dg.blk_dst[:1], dg.blk_w[:1], dg.blk_row_ptr[:1], plans[se], labels, lam,
                actions, feasible, block_v=bv, k=k, weight_mode=mode)))
            for acc, se, th in variants}
        if parent is not None:
            hist = torch.empty((1, bv, k), device="cuda")
            wacc = torch.empty((1, bv, k), device="cuda")
            lib = parent["edge_phase"]
            calls["parent"] = lambda mode=mode: check_launch(lib, lib.edge_phase_launch(
                dg.blk_dst.data_ptr(), dg.blk_w.data_ptr(), dg.blk_row_ptr.data_ptr(),
                labels.data_ptr(), lam.data_ptr(), actions.data_ptr(), feasible.data_ptr(),
                hist.data_ptr(), wacc.data_ptr(), 1, dg.e_max, bv, k,
                int(mode == "neighbor_lambda"),
                torch.cuda.current_stream().cuda_stream)) or (hist, wacc)
        for name, call in calls.items():
            for a, b in zip(call(), want):
                if not torch.equal(a, b):
                    raise RuntimeError(f"K1 {name} {mode} differs from the plain version")
        for name, ms in timed(cs, torch, calls, flush, eager=True).items():
            emit({"kernel": "fused_edge_phase", "weight_mode": mode, "variant": name, **ms})


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--skip-k1", action="store_true", help="time K6 only (no graph build)")
    parser.add_argument("--skip-prefill", action="store_true",
                        help="of K6, time the decode kernel only")
    parser.add_argument("--parent", type=pathlib.Path,
                        help="a checkout of the parent commit, to time its K1 and K6 beside")
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("port_kernel_variants: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    import chip_smoke as cs
    from repro_torch.graphs import load_dataset
    from repro_torch.kernels import _build

    print(cs.nvidia_smi_line(), flush=True)
    built = {}
    thread = threading.Thread(
        target=lambda: built.setdefault("g", load_dataset("WIKI", scale=1.0, seed=cs.SEED)),
        daemon=True)
    if not opts.skip_k1:
        thread.start()
    _build.build(("edge_phase", "wkv6"))
    parent = None
    if opts.parent is not None:
        csrc = opts.parent / "src" / "repro_torch" / "kernels" / "csrc"
        parent = {kernel: nvcc_library(csrc / f"{kernel}.cu", kernel, "parent", argtypes)
                  for kernel, argtypes in PARENT_ARGTYPES.items()}
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device="cuda")
    k6_variants(torch, cs, flush, parent, prefill=not opts.skip_prefill)
    if not opts.skip_k1:
        thread.join()
        if "g" not in built:
            raise RuntimeError("host graph build failed (traceback above)")
        k1_variants(torch, np, cs, flush, built["g"], parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
