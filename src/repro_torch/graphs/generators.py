"""Synthetic graph generators calibrated to the paper's Table I families.

The SNAP / WebGraph datasets used by the paper are not available offline, so
we reproduce the three structural families that drive the paper's analysis
(Section V-G):

  * right-skewed power-law graphs (WIKI, LJ, EN, OK, HLWD, UK)  -> RMAT
  * left-skewed near-uniform sparse graphs (USA road)           -> grid/road
  * skew-free graphs (SO, EU)                                   -> Erdos-Renyi

Each generator returns a directed edge list; `build_graph` handles dedup and
the symmetrized weighted adjacency. Generator statistics (density, Pearson
skewness sign) are validated against Table I in benchmarks/table1_datasets.py.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.graphs.csr import Graph, build_graph


def rmat(
    n: int,
    m: int,
    *,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> Graph:
    """R-MAT generator (Chakrabarti et al.) — right-skewed power-law graphs.

    Vertices are implicitly a 2^levels space; we draw quadrant bits per level
    fully vectorized, then fold into [0, n). Higher `a` => heavier skew.
    """
    rng = np.random.default_rng(seed)
    d = 1.0 - a - b - c
    if d < 0:
        raise ValueError("rmat probabilities must sum to <= 1")
    levels = max(int(np.ceil(np.log2(max(n, 2)))), 1)
    # oversample to survive dedup / self-loop removal
    m_draw = int(m * 1.15) + 16
    src = np.zeros(m_draw, dtype=np.int64)
    dst = np.zeros(m_draw, dtype=np.int64)
    p_quad = np.array([a, b, c, d])
    for _ in range(levels):
        q = rng.choice(4, size=m_draw, p=p_quad)
        src = (src << 1) | (q >> 1)
        dst = (dst << 1) | (q & 1)
    src %= n
    dst %= n
    return build_graph(src[:], dst[:], n)


def grid_road(n: int, *, seed: int = 0, drop_frac: float = 0.12) -> Graph:
    """Road-network-like graph: 2D lattice, bidirected, with random road
    removals creating dead-ends and 3-way intersections.

    Produces a sparse *left-skewed* outdegree distribution (mode=4 > mean,
    like USA-road's Pearson coefficient of -0.59 in Table I): most vertices
    keep degree 4 while the removals pull the mean below the mode.
    """
    side = int(np.floor(np.sqrt(n)))
    n_eff = side * side
    idx = np.arange(n_eff, dtype=np.int64)
    x, y = idx % side, idx // side
    edges = []
    right = idx[x < side - 1]
    edges.append((right, right + 1))
    down = idx[y < side - 1]
    edges.append((down, down + side))
    src = np.concatenate([e[0] for e in edges])
    dst = np.concatenate([e[1] for e in edges])
    # random road removals (both directions of a segment vanish together)
    rng = np.random.default_rng(seed)
    keep = rng.uniform(size=src.shape[0]) >= drop_frac
    src, dst = src[keep], dst[keep]
    # bidirect the lattice (roads are two-way)
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    return build_graph(src, dst, n_eff)


def erdos_renyi(n: int, m: int, *, seed: int = 0) -> Graph:
    """Uniform random directed graph — the skew-free family (SO, EU)."""
    rng = np.random.default_rng(seed)
    m_draw = int(m * 1.05) + 16
    src = rng.integers(0, n, size=m_draw)
    dst = rng.integers(0, n, size=m_draw)
    return build_graph(src, dst, n)


def dc_sbm(
    n: int,
    m: int,
    *,
    n_comm: int = 32,
    mixing: float = 0.3,
    degree_exponent: float = 0.0,
    seed: int = 0,
) -> Graph:
    """Degree-corrected stochastic block model.

    The paper's social/web graphs (WIKI, LJ, OK, ...) are right-skewed *and*
    strongly clustered; pure R-MAT reproduces the skew but not the community
    structure that LP-based partitioners exploit, so we use a DC-SBM for
    those families (DESIGN.md §10).

      * vertices are split into `n_comm` equal communities;
      * per-vertex propensities theta ~ (uniform(0,1))^(-degree_exponent)
        (degree_exponent=0 -> uniform degrees / skew-free; larger values ->
        heavier right skew);
      * each edge picks its source ~ theta; the destination is sampled from
        the source's community with prob (1-mixing), globally otherwise.
    """
    rng = np.random.default_rng(seed)
    comm_size = -(-n // n_comm)
    n_eff = comm_size * n_comm
    comm = np.arange(n_eff) // comm_size          # vertices sorted by community

    if degree_exponent > 0:
        theta = rng.uniform(0.02, 1.0, size=n_eff) ** (-degree_exponent)
    else:
        theta = np.ones(n_eff)
    # global inverse-cdf sampling structures (vertices already community-sorted)
    cum = np.cumsum(theta)
    total = cum[-1]
    # per-community cumulative boundaries for intra-community sampling
    comm_lo = np.concatenate([[0.0], cum[comm_size - 1 :: comm_size]])[:-1]
    comm_hi = cum[comm_size - 1 :: comm_size]

    m_draw = int(m * 1.12) + 16
    src = np.searchsorted(cum, rng.uniform(0, total, size=m_draw))
    src = np.minimum(src, n_eff - 1)
    intra = rng.uniform(size=m_draw) >= mixing
    c_src = comm[src]
    lo, hi = comm_lo[c_src], comm_hi[c_src]
    u = rng.uniform(size=m_draw)
    dst_intra = np.searchsorted(cum, lo + u * (hi - lo))
    dst_global = np.searchsorted(cum, rng.uniform(0, total, size=m_draw))
    dst = np.where(intra, dst_intra, dst_global)
    dst = np.minimum(dst, n_eff - 1)
    return build_graph(src, dst, n_eff)


def ring_of_cliques(n_cliques: int, clique_size: int, *, seed: int = 0) -> Graph:
    """Planted-partition test graph: k dense cliques + a sparse ring.

    Ground truth: the optimal k-way partition assigns one clique per part;
    used by unit tests to check that Revolver recovers high local-edges.
    """
    n = n_cliques * clique_size
    src, dst = [], []
    for c in range(n_cliques):
        base = c * clique_size
        for i in range(clique_size):
            for j in range(clique_size):
                if i != j:
                    src.append(base + i)
                    dst.append(base + j)
        # one ring edge to the next clique
        nxt = ((c + 1) % n_cliques) * clique_size
        src.append(base)
        dst.append(nxt)
    return build_graph(np.array(src), np.array(dst), n)


def edge_split(g: Graph, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Return (src, dst) arrays of the directed edge list (for re-generation)."""
    src = np.repeat(np.arange(g.n, dtype=np.int32), np.diff(g.row_ptr).astype(np.int64))
    return src, g.col_idx.copy()
