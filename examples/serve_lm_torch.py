"""Serve small models with batched requests through the port's Engine
(prefill + sampled decode), across three architecture families.

The counterpart of ``examples/serve_lm.py`` (LM-stack scaffolding, not a
graph-partitioning example; the partitioner-driven LM integration is
``examples/expert_placement_torch.py``).

  PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu] [--max-new 24]

Without ``--device`` it runs on CUDA (K4, K5 and K6 serve the attention and
the RWKV6 recurrence) and fails when no CUDA device is available.
"""
import argparse
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.models import init_lm
from repro_torch.serve import Engine

ARCHS = ["tinyllama-1.1b", "rwkv6-3b", "deepseek-v2-lite-16b"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    ap.add_argument("--max-new", type=int, default=24)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        gen = torch.Generator(device=dev).manual_seed(0)
        model = init_lm(cfg, gen, dev)
        eng = Engine(cfg, model, s_max=16 + args.max_new + 8)
        prompts = torch.randint(0, cfg.vocab, (4, 16), generator=gen, device=dev,
                                dtype=torch.int32)
        t0 = time.monotonic()
        res = eng.generate(prompts, max_new=args.max_new, temperature=0.8, generator=gen)
        dt = time.monotonic() - t0
        print(f"{arch:24s} ({cfg.family:6s}) 4x{args.max_new} tokens in {dt:5.1f}s; "
              f"sample: {res.tokens[0, :8].tolist()}")


if __name__ == "__main__":
    main()
