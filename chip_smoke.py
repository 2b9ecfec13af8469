#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, with a CUDA device. Phases, in order; any
failure raises and the script exits non-zero without printing a result:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc builds every kernel from ``src/repro_torch/kernels/csrc``
  3. parity   each kernel on small odd-k inputs against the plain version on
              the CPU; then 3 supersteps on the card (kernels) against 3 on
              the CPU (plain versions) from one state with the same random
              draws, both weight modes: labels, lambda and loads equal,
              probabilities within tolerance
  4. graph    the paper's WIKI graph at full size (1.79M vertices), built on
              the host (in a thread started before phase 2, overlapping the
              kernel build and phase 3) and laid out on the card in 8 blocks
  5. kernels  each kernel against its plain PyTorch version on the card, at
              the main path's shapes (K1 bit-exact, K2 at atol 5e-6 / rtol
              5e-5), then timed: median of 30 launches after warm-up, CUDA
              events, L2 flushed before each launch
  6. main     ``run_partitioner("revolver", WIKI, k=8, seed=0)`` on the card,
              with every launch counter set to 0 just before and read just
              after; each kernel must have launched 8 times per superstep
  7. profile  a few supersteps under torch.profiler: device busy share and
              device time by kernel

The lines before the last are one JSON object per phase result, the
``{"kernels": [...]}`` summary and the nvidia-smi line; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

K = 8
N_BLOCKS = 8
SEED = 0
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12             # H100 SXM f32 outside the tensor cores
K2_TOL = dict(atol=5e-6, rtol=5e-5)
# the golden-worker graph of the JAX package's tests
PARITY_GRAPH = dict(n=1024, m=8192, n_comm=16, mixing=0.25,
                    degree_exponent=0.5, seed=3)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of one ``fn()`` call, CUDA events around each call,
    the 50 MB L2 flushed before every call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def check_k1_small(torch, np, seed: int) -> None:
    """K1 on small padded slabs with odd k against the CPU plain version,
    before anything large is built."""
    from repro_torch.graphs.blocking import slab_row_ptr
    from repro_torch.kernels import edge_phase

    rng = np.random.default_rng(seed)
    for nb, e_max, sbv, k in ((3, 512, 128, 5), (1, 256, 64, 3), (2, 1024, 256, 33)):
        dst = np.zeros((nb, e_max), np.int32)
        rows = np.zeros((nb, e_max), np.int32)
        vals = np.zeros((nb, e_max), np.float32)
        for b in range(nb):
            cnt = int(rng.integers(e_max // 2, e_max))
            rows[b, :cnt] = np.sort(rng.integers(0, sbv, cnt))
            dst[b, :cnt] = rng.integers(0, nb * sbv, cnt)
            vals[b, :cnt] = rng.integers(1, 3, cnt)
        host = [dst, rows, vals,
                rng.integers(0, k, nb * sbv).astype(np.int32),
                rng.integers(0, k, nb * sbv).astype(np.int32),
                rng.integers(0, k, (nb, sbv)).astype(np.int32),
                (rng.random((nb, k)) > 0.3).astype(np.float32)]
        cpu = [torch.from_numpy(a) for a in host]
        cuda = [t.cuda() for t in cpu]
        row_ptr = torch.from_numpy(slab_row_ptr(rows, vals, sbv)).cuda()
        for mode in ("self_lambda", "neighbor_lambda"):
            got = edge_phase.fused_edge_phase_cuda(
                cuda[0], cuda[2], row_ptr, *cuda[3:], block_v=sbv, k=k,
                weight_mode=mode)
            want = edge_phase.fused_edge_phase_plain(*cpu, block_v=sbv, k=k,
                                                     weight_mode=mode)
            for a, b in zip(got, want):
                require(torch.equal(a.cpu(), b),
                        f"K1 {mode} k={k} slab differs from the CPU plain version")


def check_k1_block(torch, dg, seed: int):
    """K1 against its plain version at the main path's per-block shape (block
    0 of the layout, nb=1), both weight modes; returns the inputs."""
    from repro_torch.kernels import edge_phase

    dev = dg.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    bv = dg.block_v
    labels = torch.randint(0, K, (dg.n_pad,), generator=gen, device=dev, dtype=torch.int32)
    lam = torch.randint(0, K, (dg.n_pad,), generator=gen, device=dev, dtype=torch.int32)
    actions = torch.randint(0, K, (1, bv), generator=gen, device=dev, dtype=torch.int32)
    feasible = (torch.rand((1, K), generator=gen, device=dev) > 0.3).float()
    args = (dg.blk_dst[:1], dg.blk_row[:1], dg.blk_w[:1], labels, lam, actions, feasible)
    for mode in ("self_lambda", "neighbor_lambda"):
        got = edge_phase.fused_edge_phase_cuda(
            dg.blk_dst[:1], dg.blk_w[:1], dg.blk_row_ptr[:1], labels, lam,
            actions, feasible, block_v=bv, k=K, weight_mode=mode)
        want = edge_phase.fused_edge_phase_plain(*args, block_v=bv, k=K, weight_mode=mode)
        torch.cuda.synchronize()
        for a, b, name in zip(got, want, ("hist", "w_acc")):
            require(torch.equal(a, b), f"K1 {mode} {name} differs from plain at full block")
    live = int((dg.blk_w[0] > 0).sum())
    return args, labels, lam, actions, feasible, live


def check_k2(torch, dev, v: int, k: int, seed: int):
    """K2 against its plain version on [v, k]; returns the inputs."""
    from repro_torch.core.la import split_weights_and_signals
    from repro_torch.kernels import la_update

    gen = torch.Generator(device=dev).manual_seed(seed)
    p = torch.rand((v, k), generator=gen, device=dev) + 0.01
    p = p / p.sum(-1, keepdim=True)
    w_raw = torch.randint(0, 6, (v, k), generator=gen, device=dev).float()
    w, r = split_weights_and_signals(w_raw)
    got = la_update.la_update_cuda(p, w, r, 1.0, 0.1)
    want = la_update.la_update_plain(p, w, r, 1.0, 0.1)
    want_cpu = la_update.la_update_plain(p.cpu(), w.cpu(), r.cpu(), 1.0, 0.1)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    require(torch.allclose(got, want, **K2_TOL),
            f"K2 [{v},{k}] differs from plain on the card: max abs err {err}")
    require(torch.allclose(got.cpu(), want_cpu, **K2_TOL),
            f"K2 [{v},{k}] differs from plain on the CPU")
    return (p, w, r), err


def parity_phase(torch, np):
    """3 supersteps with the kernels on the card against 3 with the plain
    versions on the CPU, from one state and one set of draws."""
    from repro_torch.core.convert import revolver_state_from_numpy
    from repro_torch.core.device_graph import prepare_device_graph
    from repro_torch.core.revolver import (
        RevolverConfig,
        make_generator,
        revolver_init,
        revolver_superstep,
    )
    from repro_torch.graphs.generators import dc_sbm

    g = dc_sbm(**PARITY_GRAPH)
    k, steps = 4, 3
    dg_cpu = prepare_device_graph(g, n_blocks=N_BLOCKS, device="cpu")
    dg_gpu = prepare_device_graph(g, n_blocks=N_BLOCKS, device="cuda")
    rng = np.random.default_rng(7)
    shape = (steps, dg_cpu.n_blocks, dg_cpu.block_v)
    u = np.maximum(rng.random(shape + (k,)), np.finfo(np.float32).tiny)
    gumbel = (-np.log(-np.log(u))).astype(np.float32)
    uniform = rng.random(shape).astype(np.float32)
    draws = lambda step, blk: (gumbel[step, blk], uniform[step, blk])  # noqa: E731
    for mode in ("self_lambda", "neighbor_lambda"):
        cfg = RevolverConfig(k=k, weight_mode=mode)
        st_cpu = revolver_init(dg_cpu, cfg, make_generator(7, "cpu"))
        # copies: the CPU state's tensors are updated in place
        arrays = {f: getattr(st_cpu, f).numpy().copy()
                  for f in ("labels", "lam", "probs", "loads", "score")}
        st_gpu = revolver_state_from_numpy(dict(arrays, step=0), "cuda", seed=7)
        for step in range(steps):
            st_cpu = revolver_superstep(dg_cpu, cfg, st_cpu, draws=draws)
            st_gpu = revolver_superstep(dg_gpu, cfg, st_gpu, draws=draws)
            for name in ("labels", "lam", "loads"):
                require(torch.equal(getattr(st_gpu, name).cpu(), getattr(st_cpu, name)),
                        f"parity {mode}: {name} differs after superstep {step}")
            require(torch.allclose(st_gpu.probs.cpu(), st_cpu.probs, **K2_TOL),
                    f"parity {mode}: probs differ after superstep {step}")
        moved = int((st_gpu.labels.cpu() != torch.from_numpy(arrays["labels"])).sum())
        require(moved > 0, f"parity {mode}: no vertex migrated")
    return steps


def profile_phase(torch, dg, steps: int = 3):
    """Device busy share and device time by kernel over a few supersteps."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.revolver import RevolverConfig, make_generator, revolver_init, revolver_superstep

    cfg = RevolverConfig(k=K)
    state = revolver_init(dg, cfg, make_generator(SEED + 1, dg.device))
    state = revolver_superstep(dg, cfg, state)          # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state = revolver_superstep(dg, cfg, state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    busy = 0.0
    cur_s = cur_e = None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "supersteps": steps,
        "wall_ms_per_superstep": wall_us / steps / 1e3,
        "device_busy_ms_per_superstep": busy / steps / 1e3 if spans else None,
        "device_busy_share": busy / wall_us if spans else None,
        "device_kernels_per_superstep": len(spans) / steps,
        "top_device_ms_per_superstep": {n: t / steps / 1e3 for n, t in top},
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.core import run_partitioner
    from repro_torch.core.device_graph import prepare_device_graph
    from repro_torch.graphs import load_dataset
    from repro_torch.kernels import _build, edge_phase, la_update, ops

    # 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # the host graph build is the longest phase (numpy, mostly one core): it
    # runs in a thread while the kernels build and the small checks run. A
    # daemon thread, so a failing phase ends the script at once.
    built = {}

    def build_graph():
        t0 = time.perf_counter()
        built["g"] = load_dataset("WIKI", scale=1.0, seed=SEED)
        built["s"] = time.perf_counter() - t0

    graph_thread = threading.Thread(target=build_graph, daemon=True)
    graph_thread.start()

    # 2. build
    t = time.perf_counter()
    reports = _build.build()
    build_s = time.perf_counter() - t
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"ptxas[{name}] {line.strip()}")
    emit({"phase": "build", "seconds": build_s, "built": sorted(reports)})

    # 3. small kernel checks and superstep parity, before anything large:
    # the kernels on the card against the plain versions on the CPU
    check_k1_small(torch, np, SEED)
    check_k2(torch, torch.device("cuda"), 4099, 5, SEED + 1)
    ops.reset_launch_counts()
    parity_steps = parity_phase(torch, np)
    parity_counts = ops.launch_counts()
    require(all(c == 2 * N_BLOCKS * parity_steps for c in parity_counts.values()),
            f"parity launches {parity_counts}")
    emit({"phase": "parity", "supersteps": parity_steps, "weight_modes": 2,
          "launches": parity_counts})

    # 4. graph: full-size WIKI, host build (started above) then device layout
    t = time.perf_counter()
    graph_thread.join()
    require("g" in built, "host graph build failed (traceback above)")
    g, gen_s = built["g"], built["s"]
    wait_s = time.perf_counter() - t
    t = time.perf_counter()
    dg = prepare_device_graph(g, n_blocks=N_BLOCKS, device="cuda")
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t
    emit({"phase": "graph", "dataset": "WIKI", "scale": 1.0, "n": g.n, "m": g.m,
          "sym_edges": g.num_sym_edges, "n_blocks": dg.n_blocks,
          "block_v": dg.block_v, "e_max": dg.e_max,
          "host_generate_s": gen_s, "host_generate_wait_s": wait_s,
          "layout_s": layout_s})

    # 5. kernels against their plain versions at the main path's shapes,
    # then timed
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device="cuda")
    args, labels, lam, actions, feasible, live = check_k1_block(torch, dg, SEED)
    bv = dg.block_v
    k1_cuda = lambda: edge_phase.fused_edge_phase_cuda(  # noqa: E731
        dg.blk_dst[:1], dg.blk_w[:1], dg.blk_row_ptr[:1], labels, lam, actions,
        feasible, block_v=bv, k=K)
    k1_plain = lambda: edge_phase.fused_edge_phase_plain(*args, block_v=bv, k=K)  # noqa: E731
    k1_bytes = (live * 8 + (bv + 1) * 4 + 2 * dg.n_pad * 4 + bv * 4 + K * 4
                + 2 * bv * K * 4)
    k1_ops = live * (K + 2)
    (p, w, r), k2_err = check_k2(torch, dg.device, bv, K, SEED)
    k2_cuda = lambda: la_update.la_update_cuda(p, w, r, 1.0, 0.1)  # noqa: E731
    k2_plain = lambda: la_update.la_update_plain(p, w, r, 1.0, 0.1)  # noqa: E731
    active = int((w > 0).sum())
    k2_bytes = 4 * bv * K * 4
    k2_ops = active * K * 4 + bv * K * 2
    records = {
        "fused_edge_phase": {
            "name": "fused_edge_phase", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/edge_phase.cu",
            "replaces": "src/repro/kernels/edge_phase.py:108",
            "max_abs_err": 0.0,
            "ms": time_ms(torch, k1_cuda, flush),
            "plain_ms": time_ms(torch, k1_plain, flush),
            "bound_ms": max(k1_bytes / HBM_BYTES_PER_S, k1_ops / F32_FLOPS) * 1e3,
            "bound_by": "bytes" if k1_bytes / HBM_BYTES_PER_S >= k1_ops / F32_FLOPS else "operations",
            "library_ms": None,
        },
        "la_update": {
            "name": "la_update", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/la_update.cu",
            "replaces": "src/repro/kernels/la_update.py:56",
            "max_abs_err": k2_err,
            "ms": time_ms(torch, k2_cuda, flush),
            "plain_ms": time_ms(torch, k2_plain, flush),
            "bound_ms": max(k2_bytes / HBM_BYTES_PER_S, k2_ops / F32_FLOPS) * 1e3,
            "bound_by": "bytes" if k2_bytes / HBM_BYTES_PER_S >= k2_ops / F32_FLOPS else "operations",
            "library_ms": None,
        },
    }
    del flush
    emit({"phase": "kernels", "k1_live_edges": live, "k1_bytes": k1_bytes,
          "k2_rows": bv, "k2_bytes": k2_bytes, "shape_note":
          "K1 at block 0 of full WIKI (nb=1), K2 at [block_v, 8]"})

    # 6. the main path, through the entry point a user calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    res = run_partitioner("revolver", g, K, seed=SEED, n_blocks=N_BLOCKS, dg=dg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name, c in counts.items():
        require(c == N_BLOCKS * res.steps, f"{name} launched {c} times in "
                f"{res.steps} supersteps, expected {N_BLOCKS * res.steps}")
    # the result, checked by the repo's own means: labels in range, metrics
    # recomputed on the host from the returned labels
    labels_h = res.labels
    require(labels_h.shape == (g.n,) and labels_h.min() >= 0 and labels_h.max() < K,
            "labels out of range")
    src = np.repeat(np.arange(g.n), np.diff(g.row_ptr))
    le_host = float(np.mean(labels_h[src] == labels_h[g.col_idx]))
    loads = np.bincount(labels_h, weights=g.deg_out, minlength=K)
    ml_host = float(loads.max() / (loads.sum() / K))
    require(abs(le_host - res.local_edges) < 1e-5, f"local_edges {res.local_edges} vs host {le_host}")
    require(abs(ml_host - res.max_norm_load) < 1e-5, f"max_norm_load {res.max_norm_load} vs host {ml_host}")
    require(np.isfinite(res.history["score"]).all(), "non-finite score")
    require(res.local_edges > 0.5, f"local_edges {res.local_edges} <= 0.5")
    require(res.max_norm_load <= 1.30, f"max_norm_load {res.max_norm_load} > 1.30")
    emit({"phase": "main", "dataset": "WIKI", "scale": 1.0, "k": K, "seed": SEED,
          "steps": res.steps, "converged": res.converged,
          "local_edges": res.local_edges, "max_norm_load": res.max_norm_load,
          "wall_s": wall, "supersteps_per_s": res.steps / wall,
          "slab_edges_per_s": res.steps * g.num_sym_edges / wall,
          "peak_memory_bytes": peak, "launches": counts})
    for name, rec in records.items():
        rec["launches"] = counts[name]
        emit(rec)

    # 7. where a superstep's time goes
    emit({"phase": "profile", **profile_phase(torch, dg)})

    emit({"kernels": [records["fused_edge_phase"], records["la_update"]]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
