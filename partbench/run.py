"""The benchmark of the PyTorch/CUDA port of the Revolver partitioner.

    python3 partbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of `BENCHMARK.json` on one NVIDIA GPU and prints one JSON
result line last (see `partbench/harness.py`). It exits with an error and
prints no result without a CUDA device.
"""
import pathlib
import sys
import time

T0 = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from partbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t0=T0))
