"""Streaming quickstart on the PyTorch port: grow a dc-SBM graph in 10
deltas, keep the partition fresh with warm-started Revolver refinement, and
watch the quality metrics after every round.

  PYTHONPATH=src python examples/streaming_quickstart_torch.py [--device cpu]

Without ``--device`` it runs on CUDA (K1 and K2 refine every delta) and
fails when no CUDA device is available.
"""
import argparse

from repro_torch.graphs.generators import dc_sbm
from repro_torch.streaming import StreamConfig, StreamRunner, stream_from_graph

K = 8
N_DELTAS = 10


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)
    g = dc_sbm(4096, 32768, n_comm=32, mixing=0.25, degree_exponent=0.5, seed=0)
    print(f"graph: |V|={g.n:,} |E|={g.m:,} streamed in {N_DELTAS} deltas, k={K}, "
          f"device={args.device}")
    print(f"{'delta':>5s} {'|E|':>8s} {'steps':>6s} {'local_edges':>12s} "
          f"{'max_load':>9s} {'note':>6s}")

    cfg = StreamConfig(k=K, refine_max_steps=12, refine_patience=2,
                       sync_every=2, warm_sharpen=0.5)
    runner = StreamRunner(g.n, cfg, seed=0, device=args.device)
    for rep in runner.run(stream_from_graph(g, N_DELTAS, seed=0)):
        note = "repad" if rep.repadded else ""
        print(f"{rep.delta_idx:5d} {rep.m:8,d} {rep.steps:6d} "
              f"{rep.local_edges:12.4f} {rep.max_norm_load:9.4f} {note:>6s}")
    print(f"total supersteps across the stream: {runner.total_steps}")


if __name__ == "__main__":
    main()
