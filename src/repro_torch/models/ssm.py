"""Mamba2 (state space duality) mixer: Zamba2's backbone layer.

The counterpart of `repro.models.ssm`. Prefill takes the chunked SSD form
when the sequence is a whole number of chunks (within a chunk an
attention-like masked product, across chunks a [B, H, P, N] state carried
by a loop over the chunks), else the exact token-by-token recurrence,
which is also the one-token decode step. `repro` has no Pallas kernel
here (both forms are XLA), so neither has a hand-written kernel in the
port: both are plain PyTorch on every device.

The parameters are `repro`'s, with its names: the split projections
``in_z``, ``in_x``, ``in_bc`` and ``in_dt``, the depthwise causal convs
over x and over B/C (``conv_w_*`` [d_conv, C], ``conv_b_*``), ``A_log``,
``D`` and ``dt_bias`` (f32, per head), the gated RMSNorm's ``norm`` and
``out_proj``. The random init draws every tensor from one generator in a
fixed order; it is not `repro`'s key for key (`repro` reuses one key for
``in_bc`` and ``out_proj``), and parity never rests on it: the tests
convert `repro`'s weights.

State per layer (its whole serving cache):
  ssm_state   [B, H, P, N] f32        (P = head dim, N = d_state)
  conv_state  ([B, d_conv-1, d_inner], [B, d_conv-1, 2 G N]) in the
              compute dtype (the causal convs' tails)
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import Dense, Norm, _normal, _param, dense, dense_init, norm_init


@dataclasses.dataclass(frozen=True)
class Mamba2Spec:
    d_model: int
    d_state: int = 64           # N
    d_head: int = 64            # P
    expand: int = 2
    d_conv: int = 4
    n_groups: int = 1
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.d_head


class Mamba2(nn.Module):
    """One Mamba2 mixer's parameters, under `repro`'s names."""

    def __init__(self, in_z: Dense, in_x: Dense, in_bc: Dense, in_dt: Dense,
                 conv_w_x: torch.Tensor, conv_b_x: torch.Tensor, conv_w_bc: torch.Tensor,
                 conv_b_bc: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,  # noqa: N803
                 dt_bias: torch.Tensor, norm: Norm, out_proj: Dense):
        super().__init__()
        self.in_z, self.in_x, self.in_bc, self.in_dt = in_z, in_x, in_bc, in_dt
        self.conv_w_x, self.conv_b_x = _param(conv_w_x), _param(conv_b_x)
        self.conv_w_bc, self.conv_b_bc = _param(conv_w_bc), _param(conv_b_bc)
        self.A_log, self.D, self.dt_bias = _param(A_log), _param(D), _param(dt_bias)
        self.norm, self.out_proj = norm, out_proj


def init_mamba2(gen: torch.Generator, spec: Mamba2Spec, dtype) -> Mamba2:
    """`repro`'s distributions (A = -1, D = 1, dt_bias 0, zero conv biases
    at init), drawn from ``gen`` in a fixed order."""
    dev = gen.device
    d_bc = 2 * spec.n_groups * spec.d_state
    h = spec.n_heads
    in_z = dense_init(gen, spec.d_model, spec.d_inner, dtype)
    in_x = dense_init(gen, spec.d_model, spec.d_inner, dtype)
    in_bc = dense_init(gen, spec.d_model, d_bc, dtype)
    in_dt = dense_init(gen, spec.d_model, h, dtype)
    conv_w_x = _normal(gen, (spec.d_conv, spec.d_inner), 0.2, dtype)
    conv_w_bc = _normal(gen, (spec.d_conv, d_bc), 0.2, dtype)
    out_proj = dense_init(gen, spec.d_inner, spec.d_model, dtype)
    f32 = dict(dtype=torch.float32, device=dev)
    return Mamba2(in_z, in_x, in_bc, in_dt,
                  conv_w_x, torch.zeros((spec.d_inner,), dtype=dtype, device=dev),
                  conv_w_bc, torch.zeros((d_bc,), dtype=dtype, device=dev),
                  torch.zeros((h,), **f32), torch.ones((h,), **f32), torch.zeros((h,), **f32),
                  norm_init(spec.d_inner, dtype, dev), out_proj)


def _causal_conv(xbc, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv over [B, S, C] with an optional [B, d_conv-1, C]
    tail; returns (silu of the conv in xbc's dtype, the new tail)."""
    kw = conv_w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], kw - 1, xbc.shape[2]), dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = conv_state
    xp = torch.cat([pad, xbc], dim=1)
    s = xbc.shape[1]
    y = sum(xp[:, i:i + s] * conv_w[i] for i in range(kw)) + conv_b
    new_state = xp[:, -(kw - 1):] if kw > 1 else pad
    return F.silu(y.float()).to(xbc.dtype), new_state


def _project_in(p: Mamba2, x):
    """x [B,S,d] -> (z, xc, bc, dt) through the four split projections."""
    return dense(p.in_z, x), dense(p.in_x, x), dense(p.in_bc, x), dense(p.in_dt, x)


def _gate_out(p: Mamba2, spec: Mamba2Spec, y, z):
    """Gated RMSNorm (y * silu(z)), then the output projection (in z's
    dtype)."""
    b, s = y.shape[:2]
    yf = y.reshape(b, s, spec.d_inner).float() * F.silu(z.float())
    yf = yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + 1e-5)
    return dense(p.out_proj, yf.to(z.dtype) * p.norm.g)


def _split_bc(bc, b: int, s: int, spec: Mamba2Spec):
    g, n = spec.n_groups, spec.d_state
    return bc[..., :g * n].reshape(b, s, g, n), bc[..., g * n:].reshape(b, s, g, n)


def apply_mamba2_with_state(p: Mamba2, spec: Mamba2Spec, x):
    """Prefill: x [B, S, d] -> (y [B, S, d], (ssm_state, (conv_x, conv_bc))).

    The chunked form when S % min(chunk, S) == 0, else the scan, as in
    `repro`."""
    b, s, _ = x.shape
    h, pp, g = spec.n_heads, spec.d_head, spec.n_groups
    z, xc, bc, dt = _project_in(p, x)
    xc, conv_x = _causal_conv(xc, p.conv_w_x, p.conv_b_x)
    bc, conv_bc = _causal_conv(bc, p.conv_w_bc, p.conv_b_bc)
    xs = xc.reshape(b, s, h, pp)
    bm, cm = _split_bc(bc, b, s, spec)
    dt = F.softplus(dt.float() + p.dt_bias)                       # [B,S,H]
    a = -torch.exp(p.A_log)                                       # [H]
    if s % min(spec.chunk, s) == 0:
        y, state = _ssd_chunked(xs, bm, cm, dt, a, p.D, spec.chunk, g, h)
    else:
        y, state = _ssd_scan(xs, bm, cm, dt, a, p.D, g, h)
    return _gate_out(p, spec, y, z), (state, (conv_x, conv_bc))


def apply_mamba2(p: Mamba2, spec: Mamba2Spec, x):
    """x [B, S, d] -> [B, S, d] (the teacher-forced pass)."""
    return apply_mamba2_with_state(p, spec, x)[0]


def _expand_groups(bm, g: int, h: int):
    """[B,S,G,N] -> [B,S,H,N], each group repeated across its heads."""
    return torch.repeat_interleave(bm, h // g, dim=2)


def _ssd_scan(xs, bm, cm, dt, a, d_skip, g: int, h: int, state0=None):
    """The exact recurrence (prefill of a ragged length, and decode):
    state_t = state_{t-1} exp(dt_t A) + dt_t x_t (x) B_t;
    y_t = C_t . state_t + D x_t. Returns (y [B,S,H,P] f32, state)."""
    b, s, _, pp = xs.shape
    n = bm.shape[-1]
    bmh = _expand_groups(bm, g, h).float()
    cmh = _expand_groups(cm, g, h).float()[..., None]              # [B,S,H,N,1]
    xf = xs.float()
    dx = xf * dt[..., None]                                        # dt_t x_t
    decay = torch.exp(dt * a)[..., None, None]                     # [B,S,H,1,1]
    state = (torch.zeros((b, h, pp, n), dtype=torch.float32, device=xs.device)
             if state0 is None else state0)
    ys = []
    for t in range(s):
        state = torch.addcmul(state * decay[:, t], dx[:, t, :, :, None], bmh[:, t, :, None, :])
        ys.append(torch.matmul(state, cmh[:, t])[..., 0])
    y = torch.stack(ys, dim=1) + d_skip[:, None] * xf
    return y, state


def _ssd_chunked(xs, bm, cm, dt, a, d_skip, chunk: int, g: int, h: int):
    """Chunked SSD: the intra-chunk quadratic term plus the inter-chunk
    state carried by a loop over the chunks. Returns (y [B,S,H,P] f32,
    the final state)."""
    b, s, _, pp = xs.shape
    n = bm.shape[-1]
    l = min(chunk, s)
    if s % l:
        raise ValueError(f"the chunked form needs S a multiple of {l}, got {s}")
    nc = s // l
    bmh = _expand_groups(bm, g, h).float().reshape(b, nc, l, h, n)
    cmh = _expand_groups(cm, g, h).float().reshape(b, nc, l, h, n)
    xf = xs.float().reshape(b, nc, l, h, pp)
    dtc = dt.reshape(b, nc, l, h)
    cum = torch.cumsum(dtc * a, dim=2)                             # inclusive [B,nc,L,H]

    # intra-chunk: y[t] += sum_{s<=t} C_t.B_s exp(cum_t - cum_s) dt_s x_s; the
    # decay above the diagonal can overflow to inf, so it is masked by a
    # select (a multiply by 0 would give NaN)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]            # [B,nc,T,S,H]
    tri = torch.tril(torch.ones((l, l), dtype=torch.bool, device=xs.device))
    lmat = torch.where(tri[None, None, :, :, None], torch.exp(seg), 0.0)
    cb = torch.einsum("bcthn,bcshn->bctsh", cmh, bmh)
    y_intra = torch.einsum("bctsh,bcsh,bcshp->bcthp", cb * lmat, dtc, xf)

    # chunk-boundary states
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)                 # [B,nc,L,H]
    chunk_states = torch.einsum("bcsh,bcsh,bcshn,bcshp->bchpn", decay_out, dtc, bmh, xf)
    chunk_decay = torch.exp(cum[:, :, -1])                         # [B,nc,H]
    state = torch.zeros((b, h, pp, n), dtype=torch.float32, device=xs.device)
    states_in = []                                                 # the state before each chunk
    for c in range(nc):
        states_in.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    states_in = torch.stack(states_in, dim=1)                      # [B,nc,H,P,N]

    # inter-chunk: y[t] += C_t . (exp(cum_t) state_in)
    y_inter = torch.einsum("bcthn,bcth,bchpn->bcthp", cmh, torch.exp(cum), states_in)
    y = y_intra + y_inter + d_skip[:, None] * xf
    return y.reshape(b, s, h, pp), state


def decode_mamba2(p: Mamba2, spec: Mamba2Spec, x1, ssm_state, conv_state):
    """One-token decode: x1 [B,1,d] -> (y [B,1,d], ssm_state, (conv_x,
    conv_bc)), new tensors."""
    z, xc, bc, dt = _project_in(p, x1)
    conv_x, conv_bc = conv_state
    xc, conv_x = _causal_conv(xc, p.conv_w_x, p.conv_b_x, conv_x)
    bc, conv_bc = _causal_conv(bc, p.conv_w_bc, p.conv_b_bc, conv_bc)
    b = x1.shape[0]
    xs = xc.reshape(b, 1, spec.n_heads, spec.d_head)
    bm, cm = _split_bc(bc, b, 1, spec)
    dtf = F.softplus(dt.float() + p.dt_bias)
    a = -torch.exp(p.A_log)
    y, ssm_state = _ssd_scan(xs, bm, cm, dtf, a, p.D, spec.n_groups, spec.n_heads,
                             state0=ssm_state)
    return _gate_out(p, spec, y, z), ssm_state, (conv_x, conv_bc)


def init_mamba2_state(spec: Mamba2Spec, batch: int, dtype, device):
    """Zero (ssm_state f32, (conv_x, conv_bc) in ``dtype``) for one layer."""
    return (torch.zeros((batch, spec.n_heads, spec.d_head, spec.d_state),
                        dtype=torch.float32, device=device),
            (torch.zeros((batch, spec.d_conv - 1, spec.d_inner), dtype=dtype, device=device),
             torch.zeros((batch, spec.d_conv - 1, 2 * spec.n_groups * spec.d_state),
                         dtype=dtype, device=device)))
