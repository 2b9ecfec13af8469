"""Serving launcher of the port: random-init parameters, batched generation.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      [--reduced] --batch 4 --prompt-len 16 --max-new 32 [--device cpu]

`--arch` takes all ten archs of `repro`: the dense decoders
(tinyllama-1.1b, stablelm-1.6b, h2o-danube-3-4b with sliding-window
attention, and command-r-plus-104b with Cohere's parallel block, which
fits one card only with `--reduced`), the MoE + MLA decoders
(deepseek-v2-lite-16b, which fits one card at full width, and
deepseek-v2-236b, which fits one only with `--reduced`), the VLM
internvl2-1b, rwkv6-3b, the Mamba2 hybrid zamba2-7b and the
encoder-decoder whisper-base. `--device` defaults to cuda and fails
without a CUDA device. Parameters, prompts and, for the VLM and the
encoder-decoder, the stub frontend ([B, n_patches or enc_seq, d]
embeddings) are drawn from `--seed`; `--ckpt-dir D` then replaces the
parameters with the ``params`` tree of D's newest checkpoint (the store's
format, as `repro`'s trainer and the port's write it; bf16 leaves
included). Only the ``params/`` leaves are read: a trainer checkpoint's
masters and moments stay on disk. The cache
holds a VLM's patches too: n_patches + prompt + max_new rows, where
`repro`'s launcher sizes it as prompt + max_new (ROADMAP §3).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import latest_step, load_checkpoint_tensors, unflatten
from repro_torch.configs.registry import get_config
from repro_torch.core.device_graph import resolve_device
from repro_torch.models import init_lm
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.serve import Engine, cache_rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (cuda or cpu)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = init_lm(cfg, gen, dev)
    if args.ckpt_dir:
        step = latest_step(args.ckpt_dir)
        if step is not None:
            tree = unflatten(load_checkpoint_tensors(args.ckpt_dir, step, dev,
                                                     prefix="params"))
            if "params" not in tree:
                raise ValueError(f"checkpoint step {step} in {args.ckpt_dir} holds no "
                                 f"params tree (keys: {sorted(tree)})")
            model = lm_params_from_numpy(cfg, tree["params"], dev)
            print(f"restored params from step {step}")
    # n_patches (a VLM's) + prompt + max_new rows: one more than a generate
    # writes, as `repro`'s prompt + max_new is for the other families
    eng = Engine(cfg, model, s_max=cache_rows(cfg, args.prompt_len, args.max_new) + 1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    frontend = None
    if cfg.family in ("vlm", "encdec"):
        n = cfg.n_patches or cfg.enc_seq
        frontend = torch.randn((args.batch, n, cfg.d_model), generator=gen,
                               device=dev).to(cfg.cdt)
    t0 = time.monotonic()
    res = eng.generate(prompts, max_new=args.max_new, temperature=args.temperature,
                       generator=gen, frontend=frontend)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.monotonic() - t0
    toks = args.batch * args.max_new
    print(f"generated {toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s)")
    print("first sequence:", res.tokens[0].tolist())
    return res


if __name__ == "__main__":
    main()
