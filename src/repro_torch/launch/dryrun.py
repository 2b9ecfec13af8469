"""Dry run over the cell grid: does an arch at a shape fit on a mesh, and
what bounds its step.

The port of `repro.launch.dryrun`. For every (architecture x input shape x
mesh) cell it builds the model's parameters on the meta device (nothing is
allocated), runs one step — ``train_step`` for ``train_*``, a prefill for
``prefill_*``, one decode token against a seq_len-deep cache for
``decode_*`` / ``long_*`` — on meta tensors under a
`repro_torch.parallel.cost_count.CostCounter`, and prints the per-rank
memory, the counted costs and the three-term roofline
(`repro_torch.parallel.roofline`, H100 constants) as one JSONL row.

Meshes: ``single`` (data 16 x model 16 = 256 ranks), ``multipod`` (pod 2 x
data 16 x model 16 = 512), `repro`'s production meshes
(`launch.mesh.make_production_mesh`), and ``host``, the one-rank mesh of
`launch.mesh.make_host_mesh` (one card). No rank is built: each tensor's
per-rank size comes from its spec in `repro_torch.parallel.sharding`, and
a cell whose specs do not divide its shapes raises, as in `repro`.

Row memory, per rank:
  argument_gb  parameters + optimizer state (ZeRO-DP specs for train) +
               decode cache + batch
  output_gb    the step's outputs: logits, and the prefill's cache
  temp_gb      the peak of live bytes of the tensors the step makes, its
               outputs left out (``cfg.remat`` honoured)
``fits_hbm`` compares their sum with the card's HBM.

`repro`'s three switches: ``seq_parallel`` (``--seq-parallel``) splits the
residual stream along S over "model" between blocks and counts
Megatron-SP's reduce-scatters and all-gathers
(`repro_torch.parallel.cost_count`); ``bf16_silu`` (``--bf16-silu``)
computes SwiGLU's SiLU in the activation dtype (F1,
`repro_torch.kernels.swiglu`, in a serving step: 6 bytes an element where
the f32 path moves 26); ``zero_dp=False`` gives the optimizer state the
parameters' specs. The step runs under ``use_activation_sharding(mesh,
sp=seq_parallel, bf16_silu=bf16_silu, moe_shardmap=False)``: an MoE layer
keeps its single-device path, counted under the parameters' splits, as
without the context (``moe_ep2d`` decides the experts' specs only).

Differences from `repro`'s dry run: costs are counted from the op sequence
(`cost_count`) where `repro` parses the partitioned XLA module; every cell
runs in this process, since a meta run holds no tensor storage, under a
wall limit of its own (``--timeout``: a cell past it is a ``FAILED`` row,
as `repro`'s subprocess timeout makes one).

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k --mesh single \
      [--seq-parallel] [--bf16-silu]
  python -m repro_torch.launch.dryrun --all [--seq-parallel] --out dryrun.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import resource
import signal
import sys
import threading
import time

import torch

HOST_MESH = "host"


def _mesh(name: str):
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    if name == HOST_MESH:
        return make_host_mesh(device="cpu")
    if name not in ("single", "multipod"):
        raise ValueError(f"mesh {name!r} is not single, multipod or {HOST_MESH}")
    return make_production_mesh(multi_pod=(name == "multipod"))


def _layer_specs(model, tree_specs, sizes: dict) -> dict:
    """``{parameter name: spec}`` of one layer's tensor from the stacked
    tree's specs. A split of a stack axis (ZeRO over the layers) moves to
    the first free per-layer axis it divides (``sizes``: the mesh's axis
    sizes): the same bytes per rank."""
    from repro_torch.models.convert import param_path
    from repro_torch.parallel.sharding import P

    out = {}
    for name, p in model.named_parameters():
        path, idx = param_path(name)
        node = tree_specs
        for key in path:
            node = node[key]
        spec = list(node[len(idx):]) + [None] * (p.dim() - len(node) + len(idx))
        for part in node[:len(idx)]:
            if part is None:
                continue
            size = math.prod(sizes[a] for a in (part if isinstance(part, tuple) else (part,)))
            free = [i for i, s in enumerate(spec) if s is None and p.shape[i] % size == 0]
            if free:
                spec[free[0]] = part
        out[name] = P(*spec)
    return out


def _check(specs, shapes, mesh, what: str) -> None:
    from repro_torch.parallel.sharding import validate_specs

    bad = validate_specs(specs, shapes, mesh)
    if bad:
        raise ValueError(f"indivisible {what} shardings: {bad[:5]}")


def build_cell(cfg, shape, mesh, *, moe_ep2d: bool = False, zero_dp: bool = True):
    """The cell's arguments on the meta device and the step that runs them;
    with ``zero_dp`` the optimizer state takes the ZeRO-DP specs
    (`sharding.zero_dp_specs`), else the parameters'.

    Returns (counter, step, args, outputs_of_args): a `CostCounter` whose
    tags hold the arguments' per-rank splits, ``step()`` (run it inside
    ``with counter:``; returns the step's output tensors), the argument
    tensors, and the argument tensors the step writes as outputs (the
    prefill's cache)."""
    from repro_torch.configs.registry import input_specs
    from repro_torch.models import init_cache, init_lm, lm_decode_step, lm_prefill
    from repro_torch.models.common import MetaDraws
    from repro_torch.models.convert import lm_params_to_tree
    from repro_torch.optim.adamw import OptConfig, init_opt_state
    from repro_torch.parallel.cost_count import CostCounter
    from repro_torch.parallel.sharding import (batch_specs, cache_specs, param_specs,
                                               zero_dp_specs)
    from repro_torch.train.step import make_train_step
    from repro_torch.utils.tree import tree_leaves

    counter = CostCounter(mesh)
    with torch.device("meta"):
        model = init_lm(cfg, MetaDraws(), "meta")
    tree = lm_params_to_tree(model)
    p_specs = param_specs(tree, cfg=cfg, mesh=mesh, moe_ep2d=moe_ep2d)
    _check(p_specs, tree, mesh, "param")
    params = dict(model.named_parameters())
    counter.shard(params, _layer_specs(model, p_specs, mesh.shape))
    batch = input_specs(cfg, shape)
    counter.shard(batch, batch_specs(batch, mesh))
    args = list(params.values()) + tree_leaves(batch)
    written: list = []

    if shape.kind == "train":
        model.requires_grad_(True)
        opt = init_opt_state(params)
        opt_specs = zero_dp_specs(p_specs, tree, mesh) if zero_dp else p_specs
        per_layer = _layer_specs(model, opt_specs, mesh.shape)
        for k in ("master", "m", "v"):
            counter.shard(opt[k], per_layer)
        state = {"params": model, "opt": opt,
                 "step": torch.zeros((), dtype=torch.int32, device="meta")}
        args += tree_leaves(opt) + [state["step"]]
        fn = make_train_step(cfg, OptConfig())

        def step():
            _, metrics = fn(state, batch)
            return [metrics["loss"]]
    else:
        b = shape.global_batch
        # a VLM's prefill writes its patches' rows before the tokens'
        s_max = shape.seq_len + (cfg.n_patches if cfg.family == "vlm" and
                                 shape.kind == "prefill" else 0)
        cache = init_cache(cfg, b, s_max, "meta")
        c_specs = cache_specs(cfg, cache, mesh)
        _check(c_specs, cache, mesh, "cache")
        counter.shard(cache, c_specs)
        cache_leaves = tree_leaves(cache)
        if shape.kind == "prefill":
            written = cache_leaves

            def step():
                for t in cache_leaves:                # the step makes its cache
                    t.zero_()
                logits, _ = lm_prefill(model, cfg, cache, batch)
                return [logits]
        else:
            args += cache_leaves

            def step():
                logits, _ = lm_decode_step(model, cfg, cache, batch["token"])
                return [logits]
    return counter, step, args, written


def dryrun_cell(arch: str, shape_name: str, mesh_name: str, *, zero_dp: bool = True,
                seq_parallel: bool = False, bf16_silu: bool = False, moe_ep2d: bool = False,
                verbose: bool = True, breakdown: bool = False, cfg=None, shape=None,
                mesh=None) -> dict:
    """One cell's row, `repro`'s switches as in its ``dryrun_cell`` (module
    docstring). ``cfg`` / ``shape`` / ``mesh`` (an `LMMesh`) replace the
    registry's config, the named shape and the named mesh (reduced cells in
    tests)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.parallel import roofline
    from repro_torch.parallel.act_sharding import use_activation_sharding
    from repro_torch.utils.provenance import bench_provenance

    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh = mesh or _mesh(mesh_name)
    chips = mesh.n_ranks
    t0 = time.monotonic()
    counter, step, args, written = build_cell(cfg, shape, mesh, moe_ep2d=moe_ep2d,
                                              zero_dp=zero_dp)
    with torch.no_grad() if shape.kind != "train" else contextlib.nullcontext():
        with use_activation_sharding(mesh, enabled=True, sp=seq_parallel, bf16_silu=bf16_silu,
                                     moe_shardmap=False), counter:
            outs = step()
    t_count = time.monotonic() - t0

    argument = sum(counter.local_bytes(t) for t in args)
    made = sum(counter.local_bytes(t) for t in outs)
    output = made + sum(counter.local_bytes(t) for t in written)
    temp = max(counter.peak - made, 0.0)
    device_mem = int(argument + output + temp)
    total, active = roofline.param_counts(cfg)
    roof = roofline.roofline_from_costs(
        counter.costs(), cfg=cfg, kind=shape.kind, global_batch=shape.global_batch,
        seq_len=shape.seq_len, mesh_name=mesh_name, chips=chips,
        device_mem_bytes=device_mem, n_active=active)
    row = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": chips,
        "status": "ok", "count_s": t_count, "seq_parallel": seq_parallel,
        "bf16_silu": bf16_silu, "moe_ep2d": moe_ep2d, "zero_dp": zero_dp,
        "mem": {"argument_gb": argument / 1e9, "output_gb": output / 1e9, "temp_gb": temp / 1e9},
        **{k: v for k, v in roof.row().items() if k not in ("arch", "shape", "mesh", "chips")},
        "n_params": total, "n_active": active,
        "kernel_calls": dict(counter.kernel_calls),
    }
    row["provenance"] = bench_provenance()
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] counted in {t_count:.1f}s")
        print(f"  memory: args={row['mem']['argument_gb']:.2f}GB "
              f"out={row['mem']['output_gb']:.2f}GB temp={row['mem']['temp_gb']:.2f}GB "
              f"fits_hbm={row['fits_hbm']}")
        print(f"  flops/dev={row['flops']:.3e} bytes/dev={row['bytes']:.3e} "
              f"coll/dev={row['collective_bytes']:.3e}")
        print(f"  roofline: compute={row['compute_s']:.4f}s memory={row['memory_s']:.4f}s "
              f"coll={row['collective_s']:.4f}s -> {row['bottleneck']}-bound "
              f"useful={row['useful_ratio']:.2f}")
        print(f"  collectives: { {k: int(v['count']) for k, v in (row['collectives'] or {}).items()} }")
    if breakdown:
        print("  -- top HBM byte contributors --")
        for k, v in counter.top_bytes(12):
            print(f"    {v:12.3e}  {k}")
        print("  -- top collective contributors --")
        for k, v in counter.top_collectives(8):
            print(f"    {v:12.3e}  {k}")
        row["top_shapes"] = counter.top_bytes(12)
        row["top_coll"] = counter.top_collectives(8)
    return row


def _load_done(path):
    done = set()
    if path and os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("status") == "ok":
                        done.add((r["arch"], r["shape"], r["mesh"],
                                  bool(r.get("seq_parallel", False))))
                except json.JSONDecodeError:
                    pass
    return done


@contextlib.contextmanager
def time_limit(seconds: float | None):
    """Raise TimeoutError in this (the main) thread once ``seconds`` of wall
    time have passed inside the block (a SIGALRM timer); no limit when
    ``seconds`` is None or off the main thread."""
    if not seconds or threading.current_thread() is not threading.main_thread():
        yield
        return

    def expire(*_):
        raise TimeoutError(f"past the {seconds:g} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def run_cell(arch: str, shape_name: str, mesh_name: str, *, timeout: float | None = None,
             **kw) -> dict:
    """`dryrun_cell` under a wall limit: a cell that raises or runs past
    ``timeout`` seconds gives a ``FAILED`` row (with the switches) instead
    of a result."""
    try:
        with time_limit(timeout):
            return dryrun_cell(arch, shape_name, mesh_name, **kw)
    except Exception as e:                    # a failed cell is a row, not a stop
        print(f"FAILED {arch} x {shape_name} x {mesh_name}: {type(e).__name__}: {e}")
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "seq_parallel": kw.get("seq_parallel", False),
                "bf16_silu": kw.get("bf16_silu", False),
                "status": f"FAILED {type(e).__name__}: {e}"}


def _write(path, row) -> None:
    if path:
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multipod", HOST_MESH])
    ap.add_argument("--all", action="store_true",
                    help="run every runnable cell x both production meshes, resumable")
    ap.add_argument("--out", default=None, help="append JSONL results here")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="split the residual stream along the sequence over 'model'")
    ap.add_argument("--bf16-silu", action="store_true",
                    help="SwiGLU's SiLU in the activation dtype")
    ap.add_argument("--ep2d", action="store_true",
                    help="cross-pod expert parallelism (multipod MoE)")
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="with --all, rerun cells --out already holds")
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="wall seconds a cell may take before it is a FAILED row")
    args = ap.parse_args(argv)
    switches = {"seq_parallel": args.seq_parallel, "bf16_silu": args.bf16_silu}

    if args.all:
        from repro_torch.configs.registry import all_cells
        done = set() if args.force else _load_done(args.out)
        cells = [(a, s) for a, s, skip in all_cells() if skip is None]
        for a, s, why in all_cells():
            if why:
                print(f"SKIP {a} x {s}: {why}")
        failures = 0
        for mesh_name in ("single", "multipod"):
            for a, s in cells:
                if (a, s, mesh_name, args.seq_parallel) in done:
                    print(f"done already: {a} x {s} x {mesh_name}")
                    continue
                print(f"--- {a} x {s} x {mesh_name} ---", flush=True)
                row = run_cell(a, s, mesh_name, timeout=args.timeout,
                               breakdown=args.breakdown, **switches)
                failures += row["status"] != "ok"
                _write(args.out, row)
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        print(f"dry-run sweep complete; failures={failures}; peak host RSS {rss:.2f} GB")
        sys.exit(1 if failures else 0)

    if not args.arch or not args.shape:
        ap.error("--arch and --shape are required without --all")
    row = run_cell(args.arch, args.shape, args.mesh, timeout=args.timeout,
                   moe_ep2d=args.ep2d, breakdown=args.breakdown, **switches)
    _write(args.out, row)
    if row["status"] != "ok":
        sys.exit(1)


if __name__ == "__main__":
    main()
