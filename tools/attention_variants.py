#!/usr/bin/env python3
"""A/B timing of K4's tensor-core body under other tile shapes, on one CUDA
device: the committed ``flash_attention.cu`` and copies of it with another
kv tile (Bk), register cap (CTAs an SM must hold) and ring depth, each built
with nvcc into ``build/variants/`` and checked against the plain version
at the tinyllama-1.1b prefill shape (bf16, causal; d 64 and 128).

    python3 tools/attention_variants.py

Times are medians of 30 CUDA-graph replays with the L2 flushed before
each (``chip_smoke.graph_ms``), taken in the order a, b, ..., ..., b, a.
Prints the card's name and power limit, each variant's ptxas registers,
spills and notes on serialized wgmma, then one JSON line per variant and
head dim.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "variants"
BK = "  static constexpr int BK = 64;"
MIN_CTAS = "  static constexpr int MIN_CTAS = 2;"
STAGES = "  static constexpr int STAGES = D == 64 ? 4 : 2;"
VARIANTS = {
    "committed": {},
    "bk128_d64": {BK: "  static constexpr int BK = D == 64 ? 128 : 64;",
                  MIN_CTAS: "  static constexpr int MIN_CTAS = 1;"},
    "one_cta": {MIN_CTAS: "  static constexpr int MIN_CTAS = 1;"},
    "two_stages": {STAGES: "  static constexpr int STAGES = 2;"},
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attention_variants: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as k4

    print(cs.nvidia_smi_line(), flush=True)
    src = (_build.CSRC / "flash_attention.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs.items():
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in flash_attention.cu")
            text = text.replace(old, new)
        path = OUT / f"{name}.cu"
        path.write_text(text)
        cmd = [_build.nvcc_path(), *_build._flags("flash_attention"), "-o",
               str(path.with_suffix(".so")), str(path)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "tc_kernel" in line:
                print(f"{name}: {line.split('kernelILi')[1][:3].rstrip('E')} "
                      f"{lines[i + 1].strip()} {lines[i + 2].strip()}", flush=True)
            elif "(C75" in line:
                print(f"{name}: {line.strip()[:140]}", flush=True)
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).flash_attention_launch
        fn.argtypes = _build._ARGTYPES["flash_attention"]
        fn.restype = ctypes.c_int
        fns[name] = fn

    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for d in (64, 128):
        b, hq, hkv, s = 8, 32, 4, 1024
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for h in (hq, hkv, hkv))
        want = k4.flash_attention_plain(q, k, v)
        times = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            out = torch.empty_like(q)

            def call(fn=fns[name], out=out):
                code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
                          s, s, d, 1, 0, d ** -0.5, 1, torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"launch failed: CUDA error {code}")

            times[name].append(cs.graph_ms(torch, call, flush))
            cs.check_close(torch, out, want, cs.ATTN_TOL["bfloat16"], f"variant {name} d {d}")
        for name, ms in times.items():
            print(json.dumps({"variant": name, "d": d, "ms": ms,
                              "tflops": [4 * d * b * hq * s * (s + 1) / 2 / t / 1e9 for t in ms]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
