#!/usr/bin/env python3
"""Device time by kernel of K4 (flash attention) and K5 (flash decode) at
the tinyllama-1.1b serving shapes, and of the PyTorch call each is held
against, under torch.profiler on one CUDA device.

    python3 tools/attention_profile.py [--src DIR]

``--src`` is the directory ``repro_torch`` is imported from (default: this
checkout's ``src``), so the same probe reads the kernels of an older
checkout unpacked elsewhere. Each call is preceded by a write of 256 MB,
which flushes the 50 MB L2 as ``chip_smoke.py`` does; the flush kernel is
left out of the table. Prints the card's name and power limit, then one
JSON line per profiled function: its calls and, for every device kernel it
ran, the kernel's launches per call and device microseconds per call.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def profile_calls(torch, fn, flush, calls: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    flush_kernels = set()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):   # the profiler can drop a window's first kernel event
            flush.zero_()
        torch.cuda.synchronize()
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            flush_kernels.add(e.name)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA") and e.name not in flush_kernels:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.end - e.time_range.start)
    return {"calls": calls, "kernels": [
        {"name": name[:100], "launches_per_call": n / calls, "device_us_per_call": us / calls}
        for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("attention_profile: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import flash_attention as k4

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16 = torch.bfloat16
    b, hq, hkv, d, s, s_max, kv = 8, 32, 4, 64, 1024, 1152, 1088
    q = torch.randn((b, hq, s, d), generator=gen, device="cuda").to(bf16)
    k = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(bf16)
    v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(bf16)
    qd = torch.randn((b, hq, d), generator=gen, device="cuda").to(bf16)
    kc = torch.randn((b, hkv, s_max, d), generator=gen, device="cuda").to(bf16)
    vc = torch.randn((b, hkv, s_max, d), generator=gen, device="cuda").to(bf16)
    kv_len = torch.full((b,), kv, dtype=torch.int32, device="cuda")
    mask = (torch.arange(s_max, device="cuda")[None, :] < kv_len[:, None])[:, None, None, :]
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device="cuda")
    cases = {
        "flash_attention": (lambda: k4.flash_attention_cuda(q, k, v), 10),
        "sdpa_prefill": (lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 10),
        "decode_attention": (lambda: k5.decode_attention_cuda(qd, kc, vc, kv_len), 30),
        "sdpa_decode": (lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True), 30),
    }
    for name, (fn, calls) in cases.items():
        print(json.dumps({"function": name, "src": args.src,
                          **profile_calls(torch, fn, flush, calls)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
