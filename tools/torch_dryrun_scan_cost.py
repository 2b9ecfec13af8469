"""What counting RWKV6's training scan costs the dry run, on the CPU.

Counts one dry-run cell (`repro_torch.launch.dryrun.dryrun_cell`, default
rwkv6-3b x train_4k on the single-pod mesh) twice, each in a process of its
own: with the scan counted as one token's step times S (`rwkv6._CountedScan`,
what the dry run runs) and with the port's own token loop
(`rwkv6.looped_scan`, what training runs on the card). ``--layers`` cuts the
depth. Prints one JSON line a form: the seconds the count took, the
process's peak RSS, the counted FLOPs, bytes, collective bytes and memory.

  PYTHONPATH=src python3 tools/torch_dryrun_scan_cost.py
  PYTHONPATH=src python3 tools/torch_dryrun_scan_cost.py --layers 2 --forms looped
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import resource
import subprocess
import sys
import time


def count(arch: str, shape: str, mesh: str, form: str, layers: int) -> dict:
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import rwkv6

    if form == "looped":
        rwkv6._CountedScan.apply = rwkv6.looped_scan
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    t = time.monotonic()
    row = dryrun.dryrun_cell(arch, shape, mesh, cfg=cfg, verbose=False)
    return {"arch": arch, "shape": shape, "mesh": mesh, "form": form,
            "layers": cfg.n_layers, "count_s": time.monotonic() - t,
            "peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
            "flops": row["flops"], "bytes": row["bytes"],
            "collective_bytes": row["collective_bytes"], "mem": row["mem"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (0: the arch's)")
    ap.add_argument("--forms", nargs="+", default=["counted", "looped"],
                    choices=["counted", "looped"])
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(count(args.arch, args.shape, args.mesh, args.forms[0], args.layers)))
        return 0
    for form in args.forms:
        proc = subprocess.run([sys.executable, __file__, "--one", "--arch", args.arch,
                               "--shape", args.shape, "--mesh", args.mesh,
                               "--layers", str(args.layers), "--forms", form],
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
