"""deepseek-v2-lite-16b's serving cost on one CUDA device, for one or more
checkouts in turn: the serve leg of `chip_smoke.py`'s phase 7d.

Each checkout's own `chip_smoke.py` and `src/` serve the model at full width
and depth (bf16, random weights from the smoke's seed; batch 8, a
1,024-token prompt, 128 new tokens through `Engine.generate`, K4 27 times a
prefill), then profile 4 decode steps and the prefill. Each checkout runs
in a process of its own, in the order given; name the parent and the
change as parent, change, change, parent to see the spread. Prints one
JSON line a run: decode ms a step, first-token seconds, device kernels and
busy ms a decode step, peak bytes, a digest of the generated tokens, and
the card's `nvidia-smi` name and power limit.

  python3 tools/torch_moe_decode_ab.py PARENT_DIR . . PARENT_DIR
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import subprocess
import sys


def measure(tree: pathlib.Path) -> dict:
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, ops

    if not torch.cuda.is_available():
        raise SystemExit("torch_moe_decode_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(("flash_attention",))
    cfg, model, toks, n_params = cs.full_width_model(torch, cs.DEEPSEEK)
    serve, _ = cs.serve_phase(torch, ops, cfg, model, toks, {"flash_attention": cfg.n_layers})
    prof = cs.serve_profile(torch, cfg, model, toks)
    from repro_torch.serve import Engine
    res = Engine(cfg, model, s_max=cs.SERVE["s_max"]).generate(
        toks[:, :cs.SERVE["prompt"]].contiguous(), max_new=cs.SERVE["new"])
    digest = hashlib.sha256(res.tokens.cpu().numpy().tobytes()).hexdigest()[:16]
    return {"tree": str(tree), "nvidia_smi": cs.nvidia_smi_line(), "params": n_params,
            "decode_ms_per_step": serve["decode_ms_per_step"], "ttft_s": serve["ttft_s"],
            "peak_memory_bytes": serve["peak_memory_bytes"],
            "device_kernels_per_step": prof["device_kernels_per_step"],
            "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
            "profiled_wall_ms_per_step": prof["wall_ms_per_step"],
            "device_kernels_per_prefill": prof["prefill"]["device_kernels_per_prefill"],
            "tokens_sha256_16": digest}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", type=pathlib.Path,
                    help="checkout roots (each with chip_smoke.py and src/)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(measure(args.trees[0].resolve())), flush=True)
        return 0
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    rc = 0
    for tree in args.trees:
        tree = tree.resolve()
        proc = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()), "--child",
                               str(tree)], cwd=tree, env=env, capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not lines:
            print(json.dumps({"tree": str(tree), "exit": proc.returncode,
                              "stderr_tail": proc.stderr[-2000:]}), flush=True)
            rc = 1
            continue
        print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
