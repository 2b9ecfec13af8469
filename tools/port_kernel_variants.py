#!/usr/bin/env python3
"""A/B timing of the port's redesigned K1 (edge phase), K2 (LA update), K3
(edge histogram) and K6 (RWKV6 recurrence) kernels on one CUDA device, at
the main path's shapes.

    python3 tools/port_kernel_variants.py [--kernels k1,k2,k3,k6] [--skip-prefill]
                                          [--parent DIR]

A source variant is a copy of a kernel source with a compile-time constant
(or a function body) replaced, built with nvcc into ``build/variants/``;
a plan variant runs the committed kernel over another span plan.

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
is built on the host in a thread while K6 runs): the committed kernel
over span plans of 1024, 2048 and 4096 entries, and copies with CTAs of
32 (one warp a span) or 512 threads, warp-aggregated adds (the lanes of a
warp that share a key added first, __match_any_sync + __reduce_add_sync,
then one atomic), a binary row search for every entry, or 8 entries a
lane (the last two are copies of the span code shared with K3). Each is
held bit-equal to the plain version, then timed eager as the main path
calls it (``chip_smoke.time_ms``) and as a graph replay.

K2 at [block_v, 8] on (a) random weights (``chip_smoke.check_k2``) and (b)
the input a self_lambda Revolver superstep gives it on the same layout
(``chip_smoke.capture_k2_inputs``): the committed kernel (per-slot factors
hoisted out of the passes, the floor's divisions only in warps that run a
penalty pass, 16-byte row loads), the same with scalar loads, with the
floor divided in every row, and with it divided in every pass. Each
is held to the plain version at K2_TOL, then timed eager, as a graph
replay and by its device time under torch.profiler.

K3 at Spinner's shape (all 8 blocks) and restream's (block 0) on random
labels: the span kernel over span plans of 1024, 2048 and 4096 entries
and 128 rows, and 4096 entries and 256, in the gather form (labels[dst] in-kernel) and the slots
form (a slot slab, gathered first or not), copies with CTAs of 128
threads, 8 entries a lane, or a binary row search for every entry, and the
row walk (the float route). Each is held bit-equal to the plain
version, then timed as a graph replay and eager.

With ``--parent DIR`` (a checkout of the parent commit, e.g. unpacked from
``git archive`` under ``build/``), the parent's kernels of those named are
built from DIR and timed on the same inputs, in the order parent, change,
change, parent (its K1, K2 and K6 take the committed wrappers' C
signatures; its K3 is the row walk alone, called through its own C
signature).

Prints the card's name and power limit, each library's ptxas registers
and spills, then one JSON line per variant.
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
K2_VEC = "  const bool vec = k % 4 == 0 &&"
K2_FLOOR = "__fadd_rn(kept, pen_floor[j])"
K2_FLOORS_IF = "  if (__any_sync(0xffffffffu, runs_pen)) {"
K2_VARIANTS = {  # name: source substitutions
    "committed (hoisted, vector)": {},
    "hoisted, scalar": {K2_VEC: "  const bool vec = false &&"},
    "floor divided in every row": {K2_FLOORS_IF: "  if (true) {"},
    "not hoisted (floor divided in each pass)": {
        K2_FLOOR: "__fadd_rn(kept, __fdiv_rn(__fmul_rn(beta, w[j]), km1))"},
}
K3_THREADS = "constexpr int kThreads = 256;   // threads of a span CTA"
ROW_STEP = """    row[0] = find_row(ptr_s, rows, ef);
#pragma unroll
    for (int j = 1; j < V; ++j) {
      row[j] = row[j - 1];
      while (row[j] + 1 < rows && ptr_s[row[j] + 1] <= ef + j) ++row[j];
    }
"""
# span_plan.cuh's row lookup before the step forward: a search an entry
ROW_SEARCHES = """#pragma unroll
    for (int j = 0; j < V; ++j) row[j] = find_row(ptr_s, rows, ef + j);
"""
VEC_ENTRIES = "constexpr int kVecEntries = 4;"
SPAN_SOURCE_VARIANTS = {  # name: substitutions, in K1's and K3's sources alike
    "a row search an entry": {ROW_STEP: ROW_SEARCHES},
    "8 entries a lane": {VEC_ENTRIES: "constexpr int kVecEntries = 8;"},
}
K3_SOURCE_VARIANTS = {  # name: source substitutions
    "128 threads": {K3_THREADS: "constexpr int kThreads = 128;"},
    "8 entries a lane, 128 threads": {K3_THREADS: "constexpr int kThreads = 128;",
                                      VEC_ENTRIES: "constexpr int kVecEntries = 8;"},
    **SPAN_SOURCE_VARIANTS,
}
K3_PLANS = ((1024, 128), (2048, 128), (4096, 128), (4096, 256))  # (span entries, rows)
_VOID = ctypes.c_void_p
# the parent's K3 C entry point (the row walk: slots, vals, row_ptr, hist;
# nb, e_max, block_v, k; stream); its K1, K2 and K6 take the committed ones'
PARENT_K3_ARGTYPES = [_VOID] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_int, _VOID]
KERNELS = ("k1", "k2", "k3", "k6")
LIBRARY = {"k1": "edge_phase", "k2": "la_update", "k3": "edge_histogram", "k6": "wkv6"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvcc_library(src: pathlib.Path, kernel: str, name: str, argtypes) -> ctypes.CDLL:
    """Build ``src`` with the port's flags into ``build/variants/`` and bind
    its ``<kernel>_launch``."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    lib_path = OUT / (kernel + "_" + re.sub(r"\W+", "_", name) + ".so")
    log = subprocess.run([_build.nvcc_path(), *_build._flags(kernel), "-o", str(lib_path),
                          str(src)], check=True, capture_output=True, text=True).stdout
    print_ptxas(log, f"{kernel} {name}")
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, f"{kernel}_launch")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def print_ptxas(log: str, label: str) -> None:
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas[{label}] {line.strip()}", flush=True)


def build_variant(kernel: str, name: str, subs: dict) -> ctypes.CDLL:
    """The committed library, or a copy of ``csrc/<kernel>.cu`` with
    ``subs`` applied, built and bound like `_build.load`'s libraries."""
    from repro_torch.kernels import _build

    if not subs:
        return _build.load(kernel)
    src = (_build.CSRC / f"{kernel}.cu").read_text()
    # the span kernels' shared header inlined, so a variant can replace its
    # code too
    header = (_build.CSRC / "span_plan.cuh").read_text().replace("#pragma once\n", "")
    src = src.replace('#include "span_plan.cuh"', header)
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


def parent_call(parent, kernel: str, fn):
    """``fn`` run with the parent's library of ``kernel`` bound in place of
    the committed one (same C signature), or None without ``--parent``."""
    if parent is None or kernel not in parent:
        return None
    return lambda: with_lib(kernel, parent[kernel], fn)


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
              "device_ms_by_kernel": cs.device_ms_by_kernel(torch, calls[name])})


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
        calls["parent"] = parent_call(parent, "wkv6", lambda: k6.wkv6_cuda(*args[:5], state))
        k6_ab(torch, cs, flush, args, state, calls, "shape")
        for name, subs in K6_ABLATIONS.items():
            lib = build_variant("wkv6", name, subs)
            emit({"kernel": "wkv6", "shape": "[8,1024,32,80]", "ablation": name,
                  "device_ms_by_kernel": cs.device_ms_by_kernel(torch, lambda: with_lib(
                      "wkv6", lib, lambda: k6.wkv6_cuda(*args[:5], state)))})
        del args, state, calls
    libs = {name: build_variant("wkv6", name, subs) for name, subs in K6_DECODE_VARIANTS.items()}
    for s in (1, 2, 4, 8, 16, 64, 200):
        args = cs.wkv6_inputs(torch, gen, 8, s, 32, 80, "cuda")
        state = args[5].clone()
        calls = {name: (lambda lib=libs[name]: with_lib(
            "wkv6", lib, lambda: k6.wkv6_cuda(*args[:5], state))) for name in libs}
        calls["parent"] = parent_call(parent, "wkv6", lambda: k6.wkv6_cuda(*args[:5], state))
        k6_ab(torch, cs, flush, args, state, calls, "decode_shape")


def k1_variants(torch, np, cs, flush, dg, parent) -> None:
    from repro_torch.core.device_graph import SpanPlan
    from repro_torch.kernels import edge_phase as k1

    args, labels, lam, actions, feasible, live = cs.check_k1_block(torch, dg, cs.SEED)
    bv, k = dg.block_v, cs.K
    host_ptr = dg.blk_row_ptr[:1].cpu().numpy()
    emit({"k1_block": 0, "live_entries": live, "block_v": bv,
          "max_row_entries": int(np.diff(host_ptr[0]).max())})
    sources = {"committed": {}, "32 threads": {THREADS: "constexpr int kThreads = 32;"},
               "512 threads": {THREADS: "constexpr int kThreads = 512;"},
               "warp-aggregated adds": {ATOMIC_ADD: AGGREGATED_ADD}, **SPAN_SOURCE_VARIANTS}
    libs = {name: build_variant("edge_phase", name, subs) for name, subs in sources.items()}
    plans = {se: SpanPlan.from_row_ptr(host_ptr, "cuda", span_edges=se)
             for se in (1024, 2048, 4096)}
    variants = [(name, 2048) for name in sources] + [("committed", 1024), ("committed", 4096)]
    for mode in k1.WEIGHT_MODES:
        want = k1.fused_edge_phase_plain(*args, block_v=bv, k=k, weight_mode=mode)

        def call(plan, mode=mode):
            return lambda: k1.fused_edge_phase_cuda(
                dg.blk_dst[:1], dg.blk_w[:1], dg.blk_row_ptr[:1], plan, labels, lam, actions,
                feasible, block_v=bv, k=k, weight_mode=mode)

        calls = {f"{name}, spans of {se}": (lambda lib=libs[name], c=call(plans[se]): with_lib(
            "edge_phase", lib, c)) for name, se in variants}
        calls["parent"] = parent_call(parent, "edge_phase", call(dg.blk_spans.block(0)))
        calls = {name: c for name, c in calls.items() if c is not None}
        for name, c in calls.items():
            for a, b in zip(c(), want):
                if not torch.equal(a, b):
                    raise RuntimeError(f"K1 {name} {mode} differs from the plain version")
        for name, ms in timed(cs, torch, calls, flush, eager=True).items():
            emit({"kernel": "fused_edge_phase", "weight_mode": mode, "variant": name, **ms})


def k2_variants(torch, cs, flush, dg, parent) -> None:
    from repro_torch.kernels import la_update as k2

    libs = {name: build_variant("la_update", name, subs) for name, subs in K2_VARIANTS.items()}
    inputs = {"random": cs.check_k2(torch, dg.device, dg.block_v, cs.K, cs.SEED)[0],
              "self_lambda superstep": cs.capture_k2_inputs(torch, dg)}
    for label, (p, w, r) in inputs.items():
        call = lambda: k2.la_update_cuda(p, w, r, 1.0, 0.1)  # noqa: E731
        calls = {name: (lambda lib=lib: with_lib("la_update", lib, call))
                 for name, lib in libs.items()}
        calls["parent"] = parent_call(parent, "la_update", call)
        calls = {name: c for name, c in calls.items() if c is not None}
        want = k2.la_update_plain(p, w, r, 1.0, 0.1)
        for name, c in calls.items():
            cs.check_close(torch, c(), want, cs.K2_TOL, f"K2 {name} on the {label} input")
        for name, ms in timed(cs, torch, calls, flush, eager=True).items():
            emit({"kernel": "la_update", "input": label, "variant": name, **ms,
                  "device_ms_by_kernel": cs.device_ms_by_kernel(torch, calls[name])})


def k3_variants(torch, cs, flush, dg, parent) -> None:
    from repro_torch.core.device_graph import SpanPlan
    from repro_torch.kernels import edge_histogram as k3

    libs = {name: build_variant("edge_histogram", name, subs)
            for name, subs in K3_SOURCE_VARIANTS.items()}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 5)
    labels = torch.randint(0, cs.K, (dg.n_pad,), generator=gen, device="cuda",
                           dtype=torch.int32)
    bv, k = dg.block_v, cs.K
    for label, nb in (("spinner", dg.n_blocks), ("restream", 1)):
        dst, rows, vals, row_ptr = (dg.blk_dst[:nb], dg.blk_row[:nb], dg.blk_w[:nb],
                                    dg.blk_row_ptr[:nb])
        host_ptr = row_ptr.cpu().numpy()
        plans = {(se, rc): SpanPlan.from_row_ptr(host_ptr, "cuda", span_edges=se, row_cap=rc)
                 for se, rc in K3_PLANS}
        slots = labels[dst]

        def spans(plan, form="gather"):
            idx, lab = (dst, labels) if form == "gather" else (slots, None)
            return lambda: k3.edge_histogram_spans_cuda(idx, vals, row_ptr, plan, block_v=bv,
                                                        k=k, labels=lab)

        calls = {f"{form}, spans of {se} entries, {rc} rows": spans(plan, form)
                 for form in ("gather", "slots") for (se, rc), plan in plans.items()}
        for name, lib in libs.items():
            for se, rc in ((2048, 128), (4096, 128)):
                calls[f"gather, {name}, spans of {se} entries, {rc} rows"] = (
                    lambda lib=lib, call=spans(plans[se, rc]): with_lib("edge_histogram", lib,
                                                                       call))
        calls["gather then slots, spans of 2048 entries"] = lambda: k3.edge_histogram_spans_cuda(
            labels[dst], vals, row_ptr, plans[2048, 128], block_v=bv, k=k)
        calls["row walk (float route)"] = lambda: k3.edge_histogram_cuda(
            slots, vals, row_ptr, block_v=bv, k=k)
        if parent is not None and "edge_histogram" in parent:
            hist = torch.empty((nb, bv, k), device="cuda")
            lib = parent["edge_histogram"]
            calls["parent"] = lambda: check_launch(lib, lib.edge_histogram_launch(
                slots.data_ptr(), vals.data_ptr(), row_ptr.data_ptr(), hist.data_ptr(), nb,
                dg.e_max, bv, k, torch.cuda.current_stream().cuda_stream)) or hist
        want = k3.edge_histogram_plain(slots, rows, vals, block_v=bv, k=k)
        for name, call in calls.items():
            if not torch.equal(call(), want):
                raise RuntimeError(f"K3 {name} at the {label} shape differs from plain")
        emit({"kernel": "edge_histogram", "shape": label, "live_entries": int((vals > 0).sum()),
              "spans": {f"{se} {rc}": int(plan.spans.shape[1]) for (se, rc), plan in plans.items()}})
        for name, ms in timed(cs, torch, calls, flush, eager=True).items():
            emit({"kernel": "edge_histogram", "shape": label, "variant": name, **ms})
        del slots, calls, want


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels", default=",".join(KERNELS),
                        help="comma-separated kernels to time, of " + ",".join(KERNELS))
    parser.add_argument("--skip-prefill", action="store_true",
                        help="of K6, time the kernels below one chunk only")
    parser.add_argument("--parent", type=pathlib.Path,
                        help="a checkout of the parent commit, to time its kernels beside")
    opts = parser.parse_args()
    todo = [name for name in opts.kernels.split(",") if name]
    if not set(todo) <= set(KERNELS):
        parser.error(f"--kernels takes names of {KERNELS}, got {todo}")
    import torch

    if not torch.cuda.is_available():
        print("port_kernel_variants: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    import chip_smoke as cs
    from repro_torch.core.device_graph import prepare_device_graph
    from repro_torch.graphs import load_dataset
    from repro_torch.kernels import _build

    print(cs.nvidia_smi_line(), flush=True)
    built = {}
    thread = threading.Thread(
        target=lambda: built.setdefault("g", load_dataset("WIKI", scale=1.0, seed=cs.SEED)),
        daemon=True)
    on_wiki = [name for name in todo if name != "k6"]
    if on_wiki:
        thread.start()
    for lib, log in _build.build(tuple(LIBRARY[name] for name in todo)).items():
        print_ptxas(log, f"{lib} committed")
    parent = None
    if opts.parent is not None:
        csrc = opts.parent / "src" / "repro_torch" / "kernels" / "csrc"
        parent = {LIBRARY[name]: nvcc_library(
            csrc / f"{LIBRARY[name]}.cu", LIBRARY[name], "parent",
            PARENT_K3_ARGTYPES if name == "k3" else _build._ARGTYPES[LIBRARY[name]])
            for name in todo}
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device="cuda")
    if "k6" in todo:
        k6_variants(torch, cs, flush, parent, prefill=not opts.skip_prefill)
    if on_wiki:
        thread.join()
        if "g" not in built:
            raise RuntimeError("host graph build failed (traceback above)")
        dg = prepare_device_graph(built["g"], n_blocks=8, device="cuda")
        steps = {"k1": lambda: k1_variants(torch, np, cs, flush, dg, parent),
                 "k2": lambda: k2_variants(torch, cs, flush, dg, parent),
                 "k3": lambda: k3_variants(torch, cs, flush, dg, parent)}
        for name in on_wiki:
            steps[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
