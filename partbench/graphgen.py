"""The benchmark's graph generator: a degree-corrected SBM made on the device.

This is the benchmark's own copy of the repository's Table I stand-ins
(`dc_sbm` + `build_graph` of the port's ``graphs`` package), rewritten in
PyTorch so a full-scale graph is made on the card in seconds from the
run's seed instead of minutes of host NumPy. It keeps the stand-in's shapes:

  * ``n_comm`` equal communities of ``ceil(n / n_comm)`` vertices (so the
    graph has ``n_eff = n_comm * ceil(n / n_comm)`` vertices, as there);
  * per-vertex propensities ``theta = U(theta_low, 1) ** -degree_exponent``;
  * ``int(m * oversample) + 16`` directed draws: a source by inverse-CDF
    sampling of theta, a destination inside the source's community with
    probability ``1 - mixing`` (by theta within it), else over all vertices;
  * ``oversample`` set so that the edges left after de-duplication number
    ``m``: with ``m_tolerance`` in the specification, a graph whose edge
    count lies further than that share from ``m`` is refused;
  * self loops and duplicates dropped (``torch.unique`` on int64 keys
    ``src * n + dst``), then the out-edge CSR and the symmetrised
    neighbourhood with eq. (4)'s weights: 2 where both directions are
    edges, else 1.

The random stream is torch's, not NumPy's, so the edges differ from the
host generator's for one seed; a CPU test holds the two to one
distribution and the CSR build to `build_graph` bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

# draws per device call: bounds the generator's temporaries (float64
# uniforms and int64 ids) to a few GB at the paper's sizes
_CHUNK = 1 << 25


def community_layout(n: int, n_comm: int) -> tuple[int, int]:
    """(community size, n_eff) of the stand-in: equal communities covering
    at least ``n`` vertices."""
    comm_size = -(-n // n_comm)
    return comm_size, comm_size * n_comm


def dc_sbm_edges(spec: dict, gen: torch.Generator, device) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Directed draws (src, dst) as int64 device tensors, and ``n_eff``.

    ``spec`` holds ``n``, ``m``, ``n_comm``, ``mixing``,
    ``degree_exponent``, ``theta_low`` and ``oversample``."""
    n, m, n_comm = int(spec["n"]), int(spec["m"]), int(spec["n_comm"])
    mixing, expo = float(spec["mixing"]), float(spec["degree_exponent"])
    low = float(spec["theta_low"])
    comm_size, n_eff = community_layout(n, n_comm)
    f64 = torch.float64
    if expo > 0:
        u = torch.rand(n_eff, generator=gen, device=device, dtype=f64)
        theta = (low + (1.0 - low) * u) ** (-expo)
        del u
    else:
        theta = torch.ones(n_eff, device=device, dtype=f64)
    cum = torch.cumsum(theta, 0)
    del theta
    total = float(cum[-1])
    bounds = cum[comm_size - 1::comm_size]
    comm_lo = torch.cat([torch.zeros(1, device=device, dtype=f64), bounds[:-1]])
    comm_hi = bounds

    m_draw = int(m * float(spec["oversample"])) + 16
    srcs, dsts = [], []
    for lo in range(0, m_draw, _CHUNK):
        c = min(_CHUNK, m_draw - lo)
        src = torch.searchsorted(cum, torch.rand(c, generator=gen, device=device, dtype=f64) * total)
        src.clamp_(max=n_eff - 1)
        intra = torch.rand(c, generator=gen, device=device, dtype=f64) >= mixing
        c_src = src // comm_size
        a, b = comm_lo[c_src], comm_hi[c_src]
        u = torch.rand(c, generator=gen, device=device, dtype=f64)
        dst = torch.searchsorted(cum, a + u * (b - a))
        del a, b, u, c_src
        dst_global = torch.searchsorted(
            cum, torch.rand(c, generator=gen, device=device, dtype=f64) * total)
        dst = torch.where(intra, dst, dst_global).clamp_(max=n_eff - 1)
        srcs.append(src)
        dsts.append(dst)
        del intra, dst_global
    return torch.cat(srcs), torch.cat(dsts), n_eff


def csr_arrays(src: torch.Tensor, dst: torch.Tensor, n: int) -> dict:
    """`build_graph`'s arrays from a directed edge list, on ``src``'s
    device: ``m``, ``row_ptr`` (int64), ``col_idx`` (int32), ``adj_ptr``
    (int64), ``adj_idx`` (int32), ``adj_w`` (f32 in {1, 2}) and ``deg_out``
    (int32)."""
    src = src.to(torch.int64)
    dst = dst.to(torch.int64)
    keep = src != dst
    key = torch.unique(src[keep] * n + dst[keep])          # sorted, unique
    del keep
    m = int(key.numel())
    d_src = key // n
    deg_out = torch.bincount(d_src, minlength=n)
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=key.device)
    torch.cumsum(deg_out, 0, out=row_ptr[1:])
    col_idx = (key % n).to(torch.int32)
    rkey = (key % n) * n + d_src
    del d_src
    # every union key comes once from `key` if it is an edge and once from
    # `rkey` if its reverse is: a count of 2 is eq. (4)'s weight 2
    union, count = torch.unique(torch.cat([key, rkey]), return_counts=True)
    del key, rkey
    u_src = union // n
    adj_ptr = torch.zeros(n + 1, dtype=torch.int64, device=union.device)
    torch.cumsum(torch.bincount(u_src, minlength=n), 0, out=adj_ptr[1:])
    adj_idx = (union % n).to(torch.int32)
    del union, u_src
    return dict(m=m, row_ptr=row_ptr, col_idx=col_idx, adj_ptr=adj_ptr, adj_idx=adj_idx,
                adj_w=count.to(torch.float32), deg_out=deg_out.to(torch.int32))


def degree_stats(deg_out: np.ndarray) -> dict:
    """Table I's statistics of the out-degrees: mean, standard deviation,
    mode, largest, and Pearson's first skewness coefficient
    ``(mean - mode) / std``, the skew Table I gives for each graph."""
    deg = np.asarray(deg_out, dtype=np.int64)
    mean, std = float(deg.mean()), float(deg.std())
    mode = int(np.argmax(np.bincount(deg)))
    return {"mean": mean, "std": std, "mode": mode, "max": int(deg.max()),
            "skewness": (mean - mode) / std if std else 0.0}


def make_graph(spec: dict, seed: int, device) -> dict:
    """The configuration's graph from ``seed``: host NumPy arrays under the
    port's `Graph` field names (``n``, ``m``, ``row_ptr``, ``col_idx``,
    ``adj_ptr``, ``adj_idx``, ``adj_w``, ``deg_out``)."""
    if spec.get("family") != "dc_sbm":
        raise ValueError(f"unknown graph family {spec.get('family')!r}")
    gen = torch.Generator(device=device).manual_seed(seed)
    src, dst, n_eff = dc_sbm_edges(spec, gen, device)
    arrays = csr_arrays(src, dst, n_eff)
    del src, dst
    out = {"n": n_eff, "m": arrays.pop("m")}
    tol = spec.get("m_tolerance")
    if tol is not None and abs(out["m"] - int(spec["m"])) > float(tol) * int(spec["m"]):
        raise ValueError(f"the graph has {out['m']} edges, further than {tol} of the "
                         f"configuration's {spec['m']}: its oversample is off")
    for name, t in arrays.items():
        out[name] = t.cpu().numpy()
    return out

