"""Quickstart on the PyTorch port: partition a synthetic social graph with
every algorithm in the registry (Revolver, the Spinner and restream rules,
and the static baselines), print the paper's two quality metrics.

The counterpart of ``examples/quickstart.py``.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu] [--scale 0.002]

Without ``--device`` it runs on CUDA (K1-K3 on the card) and fails when no
CUDA device is available.
"""
import argparse

from repro_torch.core import run_partitioner
from repro_torch.graphs import graph_stats, load_dataset

K = 8


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    ap.add_argument("--scale", type=float, default=0.002)
    ap.add_argument("--max-steps", type=int, default=120)
    args = ap.parse_args(argv)
    g = load_dataset("LJ", scale=args.scale, seed=0)   # DC-SBM stand-in for LiveJournal
    stats = graph_stats(g)
    print(f"graph: |V|={g.n:,} |E|={g.m:,} density={stats['density']:.2e} "
          f"skew={stats['skewness']:+.2f} device={args.device}")
    print(f"{'algo':10s} {'local_edges':>12s} {'max_norm_load':>14s} {'steps':>6s}")
    for algo in ("revolver", "spinner", "restream", "hash", "range"):
        r = run_partitioner(algo, g, K, seed=0, max_steps=args.max_steps, device=args.device)
        print(f"{algo:10s} {r.local_edges:12.4f} {r.max_norm_load:14.4f} {r.steps:6d}")


if __name__ == "__main__":
    main()
