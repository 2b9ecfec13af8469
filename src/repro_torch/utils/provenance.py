"""Provenance stamp for the port's artifacts (the dry run's JSONL rows).

The port's copy of `repro.utils.provenance`: two artifacts are comparable
only if they are known to come from comparable environments, so every
artifact writer embeds ``bench_provenance()`` (the dry run under each row's
``"provenance"``). ``schema_version`` bumps whenever an artifact's layout
changes incompatibly. The port records torch and CUDA where `repro` records
jax and its backend.
"""
from __future__ import annotations

import os
import platform
import subprocess
import time

# 1 = no provenance; 2 = this stamp
BENCH_SCHEMA_VERSION = 2


def git_commit(cwd: str | None = None) -> str:
    """Current commit hash, or "unknown" outside a git checkout."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10,
        )
        return out.stdout.strip() if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def bench_provenance() -> dict:
    """Environment fingerprint for an artifact (JSON-serializable). Reads
    the CUDA device count without creating a CUDA context."""
    import torch

    return {
        "schema_version": BENCH_SCHEMA_VERSION,
        "git_commit": git_commit(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if torch.cuda.is_available() else "cpu",
        "device_count": torch.cuda.device_count(),
        "platform": platform.platform(),
        "python": platform.python_version(),
        "cpu_count": os.cpu_count(),
        "unix_time": time.time(),
    }
