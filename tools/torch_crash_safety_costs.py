"""Where a traced, guarded or checkpointed partitioner run spends its extra
time, on one CUDA device.

Runs flat Revolver (k 8, sync_every 5, seed 0) on WIKI at ``--scale`` in
turns, ``--rounds`` times (the order reversed every other round):

  plain         no tracing, no guard, no checkpoints
  trace         ``trace=Tracer()``
  guard         ``guard="raise"``
  ckpt          ``checkpoint_every=10`` into a scratch directory
  ckpt-nowrite  the same with the npz payload written empty, so the
                writer thread does everything but write the arrays

and prints one JSON object: per variant the wall seconds of each run (the
result fetched), the seconds the garbage collector ran during it and its
full collections; and the host microseconds of one tracer span and of
its pieces (``record_function``, an NVTX push/pop, the tracer's own
span, and ``annotate``, which opens all three), each the mean of 20,000.

  python3 tools/torch_crash_safety_costs.py --scale 0.1 --rounds 5
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import shutil
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
VARIANTS = ("plain", "trace", "guard", "ckpt", "ckpt-nowrite")


def span_costs(torch, tracer, calls: int = 20_000) -> dict:
    """Host microseconds per call of each piece of a traced kernel call."""
    def record_function():
        with torch.profiler.record_function("x"):
            pass

    def nvtx():
        torch.cuda.nvtx.range_push("x")
        torch.cuda.nvtx.range_pop()

    def span():
        with tracer.span("x", a=1):
            pass

    def annotate():
        with tracer.annotate("x", a=1):
            pass

    out = {}
    for fn in (record_function, nvtx, span, annotate):
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        out[fn.__name__] = (time.perf_counter() - t) / calls * 1e6
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.checkpoint import store
    from repro_torch.core.device_graph import prepare_device_graph
    from repro_torch.core.runner import run_partitioner
    from repro_torch.graphs import load_dataset
    from repro_torch.obs import Tracer

    if not torch.cuda.is_available():
        print("torch_crash_safety_costs: needs a CUDA device", file=sys.stderr)
        return 2
    g = load_dataset("WIKI", scale=args.scale, seed=0)
    dg = prepare_device_graph(g, n_blocks=8, device="cuda")
    work = ROOT / "build" / "crash_safety_costs"
    common = dict(seed=0, n_blocks=8, dg=dg, sync_every=5)
    write_npz = store._write_npz
    collected = {"s": 0.0, "full": 0, "t0": 0.0}

    def on_gc(phase, info):
        if phase == "start":
            collected["t0"] = time.perf_counter()
        else:
            collected["s"] += time.perf_counter() - collected["t0"]
            collected["full"] += info["generation"] == 2

    def run(variant: str) -> dict:
        shutil.rmtree(work, ignore_errors=True)
        kw = {"plain": {}, "trace": dict(trace=Tracer()), "guard": dict(guard="raise"),
              "ckpt": dict(checkpoint_dir=str(work), checkpoint_every=10),
              "ckpt-nowrite": dict(checkpoint_dir=str(work), checkpoint_every=10)}[variant]
        if variant == "ckpt-nowrite":
            store._write_npz = lambda f, arrays: None
        torch.cuda.synchronize()
        collected.update(s=0.0, full=0)
        t = time.perf_counter()
        try:
            run_partitioner("revolver", g, 8, **kw, **common)
            torch.cuda.synchronize()
        finally:
            store._write_npz = write_npz
        return {"wall_s": time.perf_counter() - t, "gc_s": collected["s"],
                "gc_full": collected["full"]}

    run_partitioner("revolver", g, 8, max_steps=1, **common)    # warm-up
    gc.callbacks.append(on_gc)
    out = {v: [] for v in VARIANTS}
    try:
        for rnd in range(args.rounds):
            for v in (VARIANTS if rnd % 2 == 0 else VARIANTS[::-1]):
                out[v].append(run(v))
    finally:
        gc.callbacks.remove(on_gc)
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"scale": args.scale, "n": g.n, "m": g.m,
                      "device": torch.cuda.get_device_name(0),
                      "host_us_per_call": span_costs(torch, Tracer()), "runs": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
