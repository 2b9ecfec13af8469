"""End-to-end driver on the PyTorch port: train a ~100M-param llama-family
model for a few hundred steps on the synthetic bigram corpus, with
checkpointing and a simulated mid-run failure + auto-resume.

The counterpart of ``examples/train_lm.py`` (LM-stack scaffolding, not a
graph-partitioning example).

  PYTHONPATH=src python examples/train_lm_torch.py --steps 300
  PYTHONPATH=src python examples/train_lm_torch.py --steps 20 --smoke --device cpu

Without ``--device`` it trains on CUDA and fails when no CUDA device is
available.
"""
import argparse
import shutil
import tempfile

from repro_torch.data import DataConfig
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptConfig
from repro_torch.train import SimulatedFailure, Trainer


def model_100m(smoke: bool) -> ModelConfig:
    if smoke:
        return ModelConfig(
            name="llama-smoke", family="dense", n_layers=2, d_model=128, n_heads=4, n_kv=2,
            d_ff=256, vocab=2048, param_dtype="float32", compute_dtype="float32",
            remat=False, logits_chunk=64)
    # ~100M params: 12L x d768 (GPT-2-small-ish with llama blocks)
    return ModelConfig(
        name="llama-100m", family="dense", n_layers=12, d_model=768, n_heads=12, n_kv=4,
        d_ff=2048, vocab=32000, param_dtype="float32", compute_dtype="float32",
        remat=False, logits_chunk=128)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step, then auto-resume")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)

    cfg = model_100m(args.smoke)
    if args.smoke:
        args.batch, args.seq = 4, 64
    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq, batch_per_host=args.batch, v_eff=512)
    opt = OptConfig(lr=3e-4, warmup_steps=max(5, args.steps // 20), total_steps=args.steps)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_lm_")

    def make(fail_at):
        return Trainer(cfg, opt, data, ckpt_dir=ckpt,
                       ckpt_every=min(25, max(5, args.steps // 4)),
                       inject_failure_at=fail_at, device=args.device)

    trainer = make(args.fail_at).init_or_resume(0)
    try:
        hist = trainer.run(args.steps)
    except SimulatedFailure as e:
        print(f"!! {e} — restarting and auto-resuming")
        trainer = make(None).init_or_resume(0)
        hist = trainer.run(args.steps)
    print(f"loss: first={hist[0]:.3f} last={hist[-1]:.3f} (bigram floor ~ {2.08:.2f})")
    if not args.ckpt_dir:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()
