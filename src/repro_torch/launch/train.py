"""Training launcher of the port.

Picks ``--arch`` (``--reduced``: a tiny config of the same family), builds
the deterministic data pipeline and AdamW, and runs the fault-tolerant
`Trainer` on one device, resuming from the newest checkpoint in
``--ckpt-dir`` if there is one:

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduced --steps 100 --ckpt-dir /tmp/ckpt [--device cpu]

`repro`'s flags, plus ``--device`` (default cuda; it fails without a CUDA
device). Exits 42 after ``--inject-failure-at`` fires (re-run to resume);
prints ``done: loss a -> b`` at the end. Checkpoints are `repro`'s layout:
``launch/serve.py --ckpt-dir`` serves their parameters.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs.registry import get_config
from repro_torch.data import DataConfig
from repro_torch.optim import OptConfig
from repro_torch.train import SimulatedFailure, Trainer
from repro_torch.utils.logging import MetricLogger


def main(argv=None) -> Trainer:
    """Run the CLI; returns the `Trainer` (its state and history) when the
    run ends, and raises SystemExit(42) on a simulated failure."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config of the same family")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda or cpu)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      batch_per_host=args.batch,
                      seed=args.seed,
                      v_eff=min(cfg.vocab, 512),
                      frontend=((cfg.n_patches or cfg.enc_seq, cfg.d_model)
                                if cfg.family in ("vlm", "encdec") else None))
    opt = OptConfig(lr=args.lr, warmup_steps=max(2, args.steps // 20),
                    total_steps=args.steps)
    trainer = Trainer(cfg, opt, data, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every,
                      microbatch=args.microbatch,
                      inject_failure_at=args.inject_failure_at,
                      logger=MetricLogger(), device=args.device)
    trainer.init_or_resume(args.seed)
    try:
        hist = trainer.run(args.steps)
        if hist:
            print(f"done: loss {hist[0]:.3f} -> {hist[-1]:.3f}; "
                  f"stragglers={trainer.straggler_events}")
        else:
            print(f"done: nothing to run, resumed at step {trainer.step}")
    except SimulatedFailure as e:
        print(f"simulated failure: {e}; re-run to auto-resume")
        raise SystemExit(42)
    return trainer


if __name__ == "__main__":
    main()
