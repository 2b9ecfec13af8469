"""Graph-partitioning launcher of the port — the paper's workload as a CLI.

  PYTHONPATH=src python -m repro_torch.launch.partition --dataset WIKI \
      --scale 0.002 --k 8 --algo revolver --algo spinner --algo restream \
      --algo hash --algo range [--device cpu]

Runs each `--algo` (repeatable; default: every registered algorithm) and
prints the rows `repro.launch.partition` prints, one per algorithm.
``--chunk-schedule sharded|halo|async`` runs the superstep over a mesh:
``--shards N`` shards on ``--device`` (the device repeated N times; default
one shard per visible CUDA device, or one CPU shard), with
``--assignment``, ``--halo-granularity``, ``--staleness-bound``,
``--hub-replication`` and ``--hub-quantile`` as in `repro` (hubs on the
sequential schedule run the 1-shard hub oracle). The superstep-only knobs
(--epsilon, --sync-every,
--mode vcycle with --coarse-n and --level-decay, --checkpoint-dir,
--checkpoint-every, --resume, --guard) go to the engine-driven algorithms
only; the static baselines (hash, range) take none and run flat.
`--trace PATH` writes one trace covering every run. `--device` defaults to
cuda and fails without a CUDA device.

Crash safety as in `repro`: with ``--checkpoint-dir D --checkpoint-every N``
each algorithm saves under ``D/<algo>``; a run killed mid-way (e.g. by
``REPRO_FAULTS=kill@superstep=12``) and relaunched with the same command
line plus ``--resume`` continues bit-identically
(`tools/torch_kill_resume_check.py` checks it).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from repro_torch.core import run_partitioner
from repro_torch.core.registry import StaticAlgorithm, available_algorithms, get_algorithm
from repro_torch.graphs import DATASETS, load_dataset
from repro_torch.launch.mesh import BlocksMesh
from repro_torch.obs import Tracer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="LJ", choices=list(DATASETS),
                    help="Table-I dataset key")
    ap.add_argument("--scale", type=float, default=0.002)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--algo", action="append", default=None,
                    choices=list(available_algorithms()),
                    help="algorithm to run (repeatable; default: all)")
    ap.add_argument("--max-steps", type=int, default=290)
    ap.add_argument("--epsilon", type=float, default=0.05)
    ap.add_argument("--n-blocks", type=int, default=8)
    ap.add_argument("--chunk-schedule", default="sequential",
                    choices=["sequential", "sharded", "halo", "async"])
    ap.add_argument("--shards", type=int, default=None,
                    help="sharded schedules: this many shards, all on --device "
                         "(default: one per visible CUDA device, or one CPU shard)")
    ap.add_argument("--assignment", default="contiguous",
                    choices=["contiguous", "locality", "vcycle"],
                    help="block->shard mapping for the sharded schedules")
    ap.add_argument("--halo-granularity", default="auto",
                    choices=["auto", "block", "vertex"],
                    help="halo exchange unit (halo/async schedules): whole boundary "
                         "blocks or per-vertex need lists on an int8 wire; auto takes "
                         "whichever moves fewer elements")
    ap.add_argument("--staleness-bound", type=int, default=0,
                    help="async schedule: supersteps a shard may run against a stale "
                         "halo before a forced refresh (0 = refresh every superstep, "
                         "bit-identical to the halo schedule on the same layout)")
    ap.add_argument("--hub-replication", action="store_true",
                    help="mirror the top-degree vertices into every shard's buffer and "
                         "reconcile their labels each superstep by a global weighted "
                         "vote (halo/async schedules; on the sequential schedule the "
                         "1-shard hub oracle)")
    ap.add_argument("--hub-quantile", type=float, default=0.0,
                    help="with --hub-replication: replicate every vertex at or above "
                         "this outdegree quantile (0 = size the hub set automatically)")
    ap.add_argument("--mode", default="flat", choices=["flat", "vcycle"],
                    help="flat = refine at full resolution from superstep 0; "
                         "vcycle = coarsen, partition the coarsest graph, "
                         "uncoarsen with warm-started refinement")
    ap.add_argument("--coarse-n", type=int, default=None,
                    help="coarsest-level vertex target for --mode vcycle "
                         "(default 512)")
    ap.add_argument("--level-decay", type=float, default=None,
                    help="finest level's share of --max-steps for --mode "
                         "vcycle (default 0.12)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sync-every", type=int, default=1,
                    help="device->host score fetch window (supersteps); "
                         "checkpoints and state guards ride these windows")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="root directory for crash-safe checkpoints; each "
                         "algorithm saves under <dir>/<algo>")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="snapshot the partitioner state every N supersteps "
                         "(0 = off; needs --checkpoint-dir)")
    ap.add_argument("--resume", action="store_true",
                    help="resume each algorithm from its newest usable "
                         "checkpoint under --checkpoint-dir (fresh run if "
                         "none exists) — a killed run relaunched with the "
                         "same command line continues bit-identically")
    ap.add_argument("--guard", default="off",
                    choices=["off", "raise", "rollback", "reinit"],
                    help="drain-window state guard policy for non-finite "
                         "probs / out-of-range labels")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda or cpu)")
    ap.add_argument("--labels-out", metavar="PATH", default=None,
                    help="write final labels per algorithm to PATH (npz, one "
                         "array per algorithm)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write a perfetto-loadable trace (Chrome trace-event"
                         " JSON) covering every run to PATH; inspect with "
                         "tools/trace_report.py or at https://ui.perfetto.dev")
    args = ap.parse_args(argv)

    tracer = None
    if args.trace:
        tracer = Tracer()
        tracer.meta["cli"] = {"dataset": args.dataset, "scale": args.scale,
                              "k": args.k, "chunk_schedule": args.chunk_schedule,
                              "device": args.device}

    g = load_dataset(args.dataset, scale=args.scale, seed=args.seed)
    rows = []
    labels_out = {}
    for algo in args.algo or available_algorithms():
        kwargs = {}
        if not isinstance(get_algorithm(algo), StaticAlgorithm):
            kwargs = dict(epsilon=args.epsilon, sync_every=args.sync_every,
                          guard=args.guard, chunk_schedule=args.chunk_schedule)
            if args.chunk_schedule != "sequential":
                kwargs["assignment"] = args.assignment
                if args.shards is not None:
                    kwargs["mesh"] = BlocksMesh([args.device] * args.shards)
            if args.chunk_schedule in ("halo", "async"):
                kwargs["halo_granularity"] = args.halo_granularity
            if args.chunk_schedule == "async":
                kwargs["staleness_bound"] = args.staleness_bound
            if args.hub_replication:
                kwargs.update(hub_replication=True, hub_quantile=args.hub_quantile)
            if args.mode != "flat":
                kwargs.update(mode=args.mode, coarse_n=args.coarse_n,
                              level_decay=args.level_decay)
            if args.checkpoint_dir:
                # per-algo subdir: one invocation runs several algorithms;
                # their checkpoints must not collide
                kwargs.update(checkpoint_dir=os.path.join(args.checkpoint_dir, algo),
                              checkpoint_every=args.checkpoint_every,
                              resume=args.resume)
        res = run_partitioner(algo, g, args.k, seed=args.seed,
                              max_steps=args.max_steps,
                              n_blocks=args.n_blocks, device=args.device,
                              trace=tracer, **kwargs)
        row = {"dataset": args.dataset, "algo": algo, "k": args.k,
               "local_edges": round(res.local_edges, 4),
               "max_norm_load": round(res.max_norm_load, 4),
               "steps": res.steps}
        if res.resumed_from:
            row["resumed_from"] = res.resumed_from
        rows.append(row)
        labels_out[algo] = res.labels
        if not args.json:
            resumed = (f" resumed_from={res.resumed_from}"
                       if res.resumed_from else "")
            print(f"{algo:10s} local_edges={row['local_edges']:.4f} "
                  f"max_norm_load={row['max_norm_load']:.4f} "
                  f"steps={row['steps']}{resumed}")
    if args.labels_out:
        np.savez(args.labels_out, **labels_out)
        if not args.json:
            print(f"labels written to {args.labels_out}")
    if args.json:
        print(json.dumps(rows))
    if tracer is not None:
        tracer.save(args.trace)
        if not args.json:
            print(f"trace written to {args.trace} "
                  f"({len(tracer.events)} events)")


if __name__ == "__main__":
    main()
