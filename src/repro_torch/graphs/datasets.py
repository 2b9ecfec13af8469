"""The paper's Table I dataset suite, reproduced synthetically at scale `s`.

Table I (paper):                        family          generator here
  WIKI  1.79M V   28.51M E  skew +0.35  right-skewed    rmat(a=.57)
  UK    1.00M V   41.24M E  skew +0.81  highly right    rmat(a=.68)
  USA  23.9M  V   58.33M E  skew -0.59  left-skewed     grid_road
  SO    2.60M V   63.49M E  skew +0.08  skew-free       erdos_renyi
  LJ    4.84M V   68.99M E  skew +0.36  right-skewed    rmat(a=.57)
  EN    4.20M V  101.3M  E  skew +0.35  right-skewed    rmat(a=.57)
  OK    3.07M V  117.1M  E  skew +0.29  right-skewed    rmat(a=.55)
  HLWD  2.18M V  228.9M  E  skew +0.32  right-skewed    rmat(a=.55)
  EU   11.2M  V  386.9M  E  skew +0.07  skew-free       erdos_renyi

`scale` multiplies |V| and |E| (default 1/100 so the full suite runs on one
CPU host in the benchmark harness; the partitioner itself is scale-free).
"""
from __future__ import annotations

import math
from typing import Dict

from repro_torch.graphs.csr import Graph
from repro_torch.graphs import generators as gen

def _ncomm(n: int) -> int:
    return max(16, n // 512)


# name -> (|V|, |E|, builder). Social/web families use the degree-corrected
# SBM (right skew + community structure, like the real graphs); road uses the
# lattice; skew-free families use uniform-propensity SBM (DESIGN.md §10).
_SPECS: Dict[str, tuple] = {
    "WIKI": (1_790_000, 28_510_000,
             lambda n, m, s: gen.dc_sbm(n, m, n_comm=_ncomm(n), mixing=0.30, degree_exponent=0.6, seed=s)),
    "UK": (1_000_000, 41_240_000,
           lambda n, m, s: gen.dc_sbm(n, m, n_comm=_ncomm(n), mixing=0.15, degree_exponent=1.0, seed=s)),
    "USA": (23_900_000, 58_330_000, lambda n, m, s: gen.grid_road(n, seed=s)),
    "SO": (2_600_000, 63_490_000,
           lambda n, m, s: gen.dc_sbm(n, m, n_comm=_ncomm(n), mixing=0.30, degree_exponent=0.0, seed=s)),
    "LJ": (4_840_000, 68_990_000,
           lambda n, m, s: gen.dc_sbm(n, m, n_comm=_ncomm(n), mixing=0.30, degree_exponent=0.6, seed=s)),
    "EN": (4_200_000, 101_300_000,
           lambda n, m, s: gen.dc_sbm(n, m, n_comm=_ncomm(n), mixing=0.30, degree_exponent=0.6, seed=s)),
    "OK": (3_070_000, 117_100_000,
           lambda n, m, s: gen.dc_sbm(n, m, n_comm=_ncomm(n), mixing=0.35, degree_exponent=0.5, seed=s)),
    "HLWD": (2_180_000, 228_900_000,
             lambda n, m, s: gen.dc_sbm(n, m, n_comm=_ncomm(n), mixing=0.25, degree_exponent=0.5, seed=s)),
    "EU": (11_200_000, 386_900_000,
           lambda n, m, s: gen.dc_sbm(n, m, n_comm=_ncomm(n), mixing=0.30, degree_exponent=0.0, seed=s)),
}

DATASETS = tuple(_SPECS.keys())


def load_dataset(name: str, *, scale: float = 0.01, seed: int = 0) -> Graph:
    """Build the named Table-I-family graph at the given scale. `scale`
    must be a finite positive number (a NaN or zero scale would silently
    build a degenerate graph and fail far from here)."""
    if name not in _SPECS:
        raise KeyError(f"unknown dataset {name!r}; available: {DATASETS}")
    if not isinstance(scale, (int, float)) or isinstance(scale, bool) \
            or not math.isfinite(scale) or scale <= 0:
        raise ValueError(
            f"scale must be a finite positive number, got {scale!r}")
    n_full, m_full, builder = _SPECS[name]
    n = max(int(n_full * scale), 64)
    m = max(int(m_full * scale), 256)
    return builder(n, m, seed)
