#!/usr/bin/env python3
"""H1 (the hub vote reconcile) on one CUDA device: the one-CTA design's
passes timed apart, and the committed kernel against a parent's and
against copies with another window on the same inputs.

    python3 tools/torch_h1_passes.py [--parent DIR] [--windows 64,128] [--groups 2,8]
                                     [--no-serial] [--ablations]
                                     [--state FILE] [--save-state FILE]
                                     [--no-mid-run] [--hub-runs STEPS]

Two inputs, k 8:

  * ``synthetic``: `chip_smoke.h1_synthetic`'s 90,000-slot table (seed
    SEED + 21, as phase 17h), loads within 6,000 of the capacity, so moves
    are refused densely;
  * ``mid_run``: phase 17h's mid-run state, full WIKI in 32 blocks on 8
    shards of the card with hubs at quantile 0.95, after 10 halo hub
    supersteps (`chip_smoke.h1_state_inputs`). It takes the full WIKI host
    build (~5 min); ``--state FILE`` loads the six inputs from an ``.npz``
    that ``--save-state FILE`` wrote on an earlier run instead.

On each: ``tools/hub_reconcile_stamped.cu`` (a copy of the one-CTA kernel
that H1 was before its redesign, with ``clock64()`` and ``%globaltimer``
stamps at its start, after pass 1 and after pass 2) is run 30 times with
the L2 flushed before each; the medians of pass 1's and pass 2's cycles
and nanoseconds are printed with the flagged count. Then the committed
kernel, copies of it with a window of w slots for each w of ``--windows``
(``kSpecWarps`` set to w / 32), for each g of ``--groups`` (serial steps
resolved g at a time, ``kGroup``) and, with ``--no-serial``, one that never
takes serial steps (``kSerialBelow`` 0), built into ``build/variants/``,
and with ``--parent DIR`` (a checkout of the parent commit, e.g. unpacked
from ``git archive`` under ``build/``) the parent's ``hub_reconcile.cu``
built from DIR, are each held bit-equal to the plain version (winners and
loads, two calls bit-equal; the committed kernel's and the copies' rounds
those of `hub_reconcile_schedule` at their window), then timed eager
(``chip_smoke.time_ms``) and replayed from a CUDA graph
(``chip_smoke.graph_ms``), median of 30 with the L2 flushed, in the order
a, b, ..., ..., b, a. With ``--ablations``, copies that return after
pass 1 (the walk kernel launched and left at once), and after the walk's
prologue and first chunk's staging, are timed the same way, their results
unchecked.

With ``--hub-runs STEPS`` (and ``--parent``), phase 17h's 8-shard halo
and async hub runs go through ``run_partitioner`` for STEPS supersteps
each, with the parent's H1 bound and then the committed one: supersteps,
local_edges, max_norm_load and labels must be equal.

Prints the card's name and power limit, its SM clocks, each library's
ptxas registers, then one JSON line per measurement.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "variants"
STAMPED = ROOT / "tools" / "hub_reconcile_stamped.cu"
_VOID = ctypes.c_void_p
INPUT_NAMES = ("votes", "cur", "deg", "owner", "loads", "cap")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvcc_library(src: pathlib.Path, name: str, symbol: str, argtypes) -> ctypes.CDLL:
    """Build ``src`` with H1's flags into ``build/variants/`` and bind
    ``symbol``."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    lib_path = OUT / f"hub_reconcile_{name}.so"
    log = subprocess.run([_build.nvcc_path(), *_build._flags("hub_reconcile"), "-o",
                          str(lib_path), str(src)], check=True, capture_output=True,
                         text=True).stdout
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas[hub_reconcile {name}] {line.strip()}", flush=True)
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def sm_clocks() -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    now, top = (float(x) for x in out.strip().splitlines()[0].split(","))
    return {"sm_clock_mhz": now, "max_sm_clock_mhz": top}


def hub_layout(torch, cs, dev: str = "cuda", scale: float = 1.0):
    """Phase 17h's layout: WIKI at ``scale`` in 32 blocks on 8 shards of
    ``dev`` with hubs at quantile 0.95; ``(graph, layout, mesh)``."""
    from repro_torch.core.device_graph import (
        device_graph_from_numpy,
        graph_host_arrays,
        sharded_layout,
    )
    from repro_torch.graphs import load_dataset
    from repro_torch.launch.mesh import BlocksMesh

    g = load_dataset("WIKI", scale=scale, seed=cs.SEED)
    spec8, _ = cs.hub_plans(g)
    cuda = torch.device(dev, 0 if dev == "cuda" else None)
    dg = device_graph_from_numpy(graph_host_arrays(g, cs.SHARD_BLOCKS), cuda)
    mesh = BlocksMesh([cuda] * cs.SHARDS)
    return g, sharded_layout(dg, mesh, None, spec8), mesh


def mid_run_state(torch, cs, layout):
    """Phase 17h's H1 inputs after 10 halo hub supersteps on ``layout``
    (`hub_layout`'s)."""
    from repro_torch.core import engine
    from repro_torch.core.registry import get_algorithm

    _, sdg8, _ = layout
    revolver = get_algorithm("revolver")
    cfg = revolver.config_cls(k=cs.K, chunk_schedule="halo")
    st = engine.place_state(revolver, revolver.init(
        sdg8, cfg, torch.Generator(device=sdg8.device).manual_seed(cs.SEED)), sdg8)
    for _ in range(10):
        st = engine.superstep(revolver, sdg8, cfg, st)
    return cs.h1_state_inputs(torch, sdg8, st)


def hub_runs(torch, np, cs, layout, parent, steps: int) -> dict:
    """Phase 17h's 8-shard halo and async (staleness 1) hub runs through
    ``run_partitioner``, ``steps`` supersteps each, once with the parent's
    H1 and once with the committed one: supersteps, local_edges,
    max_norm_load and H1's launches each, labels and loads bit-equal."""
    from repro_torch.core import run_partitioner
    from repro_torch.kernels import _build, ops

    g, sdg8, mesh = layout
    out = {}
    for sched, extra in (("halo", {}), ("async", {"staleness_bound": 1})):
        runs = {}
        for name, lib in (("parent", parent), ("change", None)):
            saved = _build._libs.get("hub_reconcile")
            if lib is not None:
                _build._libs["hub_reconcile"] = lib
            try:
                res, wall, counts = cs.timed_run(
                    torch, ops, run_partitioner, g, dg=sdg8, mesh=mesh, chunk_schedule=sched,
                    max_steps=steps, patience=10_000, halo_threshold=2.0, hub_replication=True,
                    hub_quantile=cs.HUB_QUANTILE, n_blocks=cs.SHARD_BLOCKS, sync_every=5,
                    device=sdg8.device.type, **extra)
            finally:
                _build._libs["hub_reconcile"] = saved
            runs[name] = res
            out[f"{sched} {name}"] = {"steps": res.steps, "local_edges": res.local_edges,
                                      "max_norm_load": res.max_norm_load, "wall_s": wall,
                                      "hub_reconcile_launches": counts["hub_reconcile"]}
        a, b = runs["parent"], runs["change"]
        cs.require(a.steps == b.steps and np.array_equal(a.labels, b.labels)
                   and a.local_edges == b.local_edges and a.max_norm_load == b.max_norm_load,
                   f"{sched} hub runs: the parent's H1 and the committed one differ")
        out[f"{sched} bit_equal"] = True
    return out


def stamped_passes(torch, lib, inputs, flush, reps: int = 30) -> dict:
    """Median cycles and ns of the stamped copy's two passes."""
    votes, cur, deg, owner, loads, cap = inputs
    hub_pad, k = votes.shape
    dev = votes.device
    stamps = torch.zeros(7, dtype=torch.int64, device=dev)
    ld = loads.clone()
    winners = torch.empty(hub_pad, dtype=torch.int32, device=dev)
    scratch = torch.empty((max(hub_pad, 1), 4), dtype=torch.int32, device=dev)
    rows = []
    for i in range(reps + 3):
        flush.zero_()
        ld.copy_(loads)
        code = lib.hub_reconcile_stamped_launch(
            votes.data_ptr(), cur.data_ptr(), deg.data_ptr(), owner.data_ptr(), ld.data_ptr(),
            cap.data_ptr(), winners.data_ptr(), scratch.data_ptr(), hub_pad, k,
            stamps.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if code:
            raise RuntimeError(f"stamped launch failed: {lib.repro_error_string(code).decode()}")
        s = stamps.tolist()
        if i >= 3:
            rows.append(s)

    def med(vals):
        vals = sorted(vals)
        return vals[len(vals) // 2]

    return {"pass1_cycles": med([r[1] - r[0] for r in rows]),
            "pass2_cycles": med([r[2] - r[1] for r in rows]),
            "pass1_ns": med([r[4] - r[3] for r in rows]),
            "pass2_ns": med([r[5] - r[4] for r in rows]),
            "kernel_ns": med([r[5] - r[3] for r in rows]), "flagged": rows[0][6]}


def ab(torch, cs, inputs, flush, libs: dict) -> dict:
    """Each library of ``libs`` ({name: (lib, schedule keywords or None)},
    a None lib the committed one) bit-equal to the plain version, two calls
    bit-equal and, where its schedule is given, its counts its schedule's
    (`hub_reconcile_schedule` with those keywords); then timed eager and
    replayed in the order a, b, ..., ..., b, a."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import hub_reconcile as h1

    votes, cur, deg, owner, loads, cap = inputs
    ld = loads.clone()

    def bound(lib, fn):
        def run():
            saved = _build._libs.get("hub_reconcile")
            if lib is not None:
                _build._libs["hub_reconcile"] = lib
            try:
                return fn()
            finally:
                _build._libs["hub_reconcile"] = saved
        return run

    def call():
        ld.copy_(loads)
        return h1.hub_reconcile_cuda(votes, cur, deg, owner, ld, cap)

    want_ld = loads.clone()
    want = h1.hub_reconcile_plain(votes, cur, deg, owner, want_ld, cap)
    calls, walks = {}, {}
    for name, (lib, schedule) in libs.items():
        calls[name] = bound(lib, call)
        got, got_ld = calls[name](), ld.clone()
        again, again_ld = calls[name](), ld.clone()
        torch.cuda.synchronize()
        cs.require(torch.equal(got, want) and torch.equal(got_ld, want_ld),
                   f"H1 {name} differs from its plain version")
        cs.require(torch.equal(got, again) and torch.equal(got_ld, again_ld),
                   f"H1 {name}: two calls differ")
        if schedule is not None:
            walk = bound(lib, lambda: h1.hub_reconcile_cuda_counts(
                votes, cur, deg, owner, loads.clone(), cap))()[1]
            plan = h1.hub_reconcile_schedule(votes, cur, deg, owner, loads.clone(), cap,
                                             **schedule)[1]
            cs.require(walk == plan, f"H1 {name}: walk {walk}, schedule {plan}")
            walks[name] = walk
    names = list(calls)
    out = {name: {"eager_ms": [], "graph_ms": [], **walks.get(name, {})} for name in names}
    for name in names + names[::-1]:
        out[name]["eager_ms"].append(cs.time_ms(torch, calls[name], flush))
        out[name]["graph_ms"].append(cs.graph_ms(torch, calls[name], flush))
    return out


def timed_only(torch, cs, inputs, flush, libs: dict) -> dict:
    """Each library of ``libs`` timed eager and replayed as `ab` times them,
    its results not checked."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import hub_reconcile as h1

    votes, cur, deg, owner, loads, cap = inputs
    ld = loads.clone()
    out = {}
    for name, lib in libs.items():
        def call(lib=lib):
            saved = _build._libs.get("hub_reconcile")
            _build._libs["hub_reconcile"] = lib
            try:
                ld.copy_(loads)
                return h1.hub_reconcile_cuda(votes, cur, deg, owner, ld, cap)
            finally:
                _build._libs["hub_reconcile"] = saved
        out[name] = {"eager_ms": cs.time_ms(torch, call, flush),
                     "graph_ms": cs.graph_ms(torch, call, flush)}
    return out


def copy_of_committed(name: str, subs: dict) -> ctypes.CDLL:
    """The committed kernel with ``subs`` applied, built into
    ``build/variants/``."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "hub_reconcile.cu").read_text()
    for old, new in subs.items():
        if old not in src:
            raise RuntimeError(f"{old!r} is not in hub_reconcile.cu")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"hub_reconcile_{name}.cu"
    path.write_text(src)
    return nvcc_library(path, name, "hub_reconcile_launch", _build._ARGTYPES["hub_reconcile"])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=pathlib.Path,
                        help="a checkout of the parent commit, to time its H1 beside")
    parser.add_argument("--state", type=pathlib.Path,
                        help="an .npz of the mid-run inputs (from --save-state)")
    parser.add_argument("--save-state", type=pathlib.Path,
                        help="write the mid-run inputs to this .npz")
    parser.add_argument("--no-mid-run", action="store_true",
                        help="the synthetic table only")
    parser.add_argument("--windows", default="",
                        help="comma-separated windows (multiples of 32 below 512) of copies "
                             "to time")
    parser.add_argument("--groups", default="",
                        help="comma-separated serial-step group sizes of copies to time")
    parser.add_argument("--no-serial", action="store_true",
                        help="also time a copy that never takes serial steps")
    parser.add_argument("--ablations", action="store_true",
                        help="also time copies that stop after pass 1, and after the walk's "
                             "prologue and first staging (timed only)")
    parser.add_argument("--hub-runs", type=int, default=0, metavar="STEPS",
                        help="also run phase 17h's 8-shard halo and async hub runs for STEPS "
                             "supersteps with the parent's H1 and the committed one (needs "
                             "--parent; builds full WIKI)")
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_h1_passes: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    import chip_smoke as cs
    from repro_torch.kernels import _build

    print(cs.nvidia_smi_line(), flush=True)
    emit(sm_clocks())
    for lib, log in _build.build(("hub_reconcile",)).items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{lib} committed] {line.strip()}", flush=True)
    stamped = nvcc_library(STAMPED, "stamped", "hub_reconcile_stamped_launch",
                           [_VOID] * 8 + [ctypes.c_int] * 2 + [_VOID] * 2)
    from repro_torch.kernels import hub_reconcile as h1

    libs = {}
    if opts.parent is not None:
        libs["parent"] = (nvcc_library(opts.parent / "src" / "repro_torch" / "kernels" / "csrc"
                                       / "hub_reconcile.cu", "parent", "hub_reconcile_launch",
                                       _build._ARGTYPES["hub_reconcile"]), None)
    libs[f"committed (window {h1.WINDOW})"] = (None, dict(window=h1.WINDOW))
    warps = f"constexpr int kSpecWarps = {h1.WINDOW // 32};"
    for w in (int(x) for x in opts.windows.split(",") if x):
        libs[f"window {w}"] = (copy_of_committed(
            f"window{w}", {warps: f"constexpr int kSpecWarps = {w // 32};"}), dict(window=w))
    ablations = {}
    if opts.ablations:
        # timed only, their results wrong: pass 1 and the walk kernel's
        # launch; then also its prologue and the first chunk's staging
        walk = ("  const int tid = threadIdx.x;\n  const int lane = tid & 31;\n"
                "  const int warp = tid >> 5;\n\n  // the records")
        staged = ("    stage(s_buf, list, s_off, n_ctas, span, 0, min(kChunk, n), tid, kWalkThreads, "
                  "parallel);\n  __syncthreads();\n")
        ablations["pass 1 alone"] = copy_of_committed("pass1", {walk: walk.replace(
            "  // the records", "  if (k > 0) return;\n  // the records")})
        ablations["pass 1, prologue, first staging"] = copy_of_committed(
            "staged", {staged: staged + "  if (k > 0) return;\n"})
    src = (_build.CSRC / "hub_reconcile.cu").read_text()
    group = re.search(r"constexpr int kGroup = \d+;", src).group(0)
    for g in (int(x) for x in opts.groups.split(",") if x):
        libs[f"serial group {g}"] = (copy_of_committed(
            f"group{g}", {group: f"constexpr int kGroup = {g};"}), {})
    if opts.no_serial:
        below = f"constexpr int kSerialBelow = {h1.SERIAL_BELOW};"
        libs["no serial steps"] = (copy_of_committed(
            "no_serial", {below: "constexpr int kSerialBelow = 0;"}), dict(serial_below=0))
    cuda = torch.device("cuda", 0)
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=cuda)
    tables = {"synthetic": lambda: cs.h1_synthetic(torch, np, cuda, 90_000, cs.SEED + 21)}
    if opts.state is not None:
        def load():
            with np.load(opts.state) as z:
                return tuple(torch.from_numpy(z[n]).to(cuda) for n in INPUT_NAMES)
        tables["mid_run"] = load
    layout = None
    if opts.hub_runs or (opts.state is None and not opts.no_mid_run):
        layout = hub_layout(torch, cs)
    if opts.hub_runs:
        cs.require(opts.parent is not None, "--hub-runs needs --parent")
        emit({"measure": "17h hub runs, parent's H1 against the committed one",
              **hub_runs(torch, np, cs, layout, libs["parent"][0], opts.hub_runs)})
    if opts.state is None and not opts.no_mid_run:
        tables["mid_run"] = lambda: mid_run_state(torch, cs, layout)
    for name, make in tables.items():
        inputs = make()
        if name == "mid_run" and opts.save_state is not None:
            opts.save_state.parent.mkdir(parents=True, exist_ok=True)
            np.savez(opts.save_state, **{n: t.cpu().numpy() for n, t in zip(INPUT_NAMES, inputs)})
        emit({"input": name, "slots": int(inputs[0].shape[0]), "k": int(inputs[0].shape[1]),
              **cs.check_h1(torch, inputs, name)})
        emit({"input": name, "measure": "one-CTA kernel's passes (stamped copy)",
              **stamped_passes(torch, stamped, inputs, flush), **sm_clocks()})
        emit({"input": name, "measure": "whole kernel", **ab(torch, cs, inputs, flush, libs)})
        if ablations:
            emit({"input": name, "measure": "ablations (results wrong)",
                  **timed_only(torch, cs, inputs, flush, ablations)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
