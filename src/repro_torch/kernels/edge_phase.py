"""K1: the fused dual-histogram edge phase of the Revolver superstep.

Replaces `repro.kernels.edge_phase.fused_edge_phase_pallas`. The superstep's
O(E) work per chunk is two edge-label histograms over the same slab
(Section IV-D steps 3 and 5):

  * the LP-score histogram (eqs. 10-12): hist[v, l] += w(e) over v's edges
    whose neighbor currently carries label l;
  * the eq.-13 weight accumulation, whose slot and value depend on whether
    the neighbor's latest lambda agrees with v's selected action and on slot
    feasibility (p_mig > 0).

For ``weight_mode="self_lambda"`` every edge of row v lands in the slot
lambda(v), which exists only after the scores, so the second output packs
the per-row factorization: column 0 carries A[v] = sum agree * w and column
1 carries N[v] = the count of live disagreeing edges; the rule finishes the
one-hot scatter. For ``"neighbor_lambda"`` it is the finished histogram.

Two implementations of one function:

  * `fused_edge_phase_plain` — two `index_put_(accumulate=True)`
    histograms; the CPU path and the oracle;
  * `fused_edge_phase_cuda` — the hand-written kernel in
    ``csrc/edge_phase.cu``: one CTA per span of the layout's `SpanPlan`
    (edge-balanced, a hub row cut into pieces), int32 sums per (row, label)
    in shared memory, a second small pass adding each hub row's pieces.

The weight contract: every live weight is an integer (eq.-(4)'s {1, 2},
or a contracted V-cycle level's sums of them), feasibility flags are in
{0, 1}, and each (row, label) sum stays below 2^31. The layout checks it
when it is built (`graphs.blocking.check_integer_weights`) and raises if
it does not hold. The kernel sums in int32 and writes f32 once; the plain
version adds in f32, exact while each sum stays below 2^24, so there the
two agree bit for bit. Past 2^24 the plain version (like `repro`) rounds
at every add, and the kernel's exact sum rounded once can differ from it.
"""
from __future__ import annotations

import torch

from repro_torch.core.lp import edge_histogram
from repro_torch.kernels import _build

WEIGHT_MODES = ("self_lambda", "neighbor_lambda")
MAX_K = 64
SHARED_LIMIT = 232_448   # bytes of shared memory an H100 CTA can use

LAUNCHES = _build.LaunchCounter()


def check_mode(weight_mode: str, k: int) -> None:
    if weight_mode not in WEIGHT_MODES:
        raise ValueError(
            f"unknown weight_mode {weight_mode!r}; expected {WEIGHT_MODES}")
    if weight_mode == "self_lambda" and k < 2:
        raise ValueError("self_lambda packing needs k >= 2 output columns")


def fused_edge_phase_plain(
    edge_dst: torch.Tensor,    # [nb, e_max] int32 global neighbor id
    edge_rows: torch.Tensor,   # [nb, e_max] int32 local row per edge
    edge_vals: torch.Tensor,   # [nb, e_max] f32 eq.-4 weight (0 = padding)
    labels: torch.Tensor,      # [n_pad] int32 current labels
    lam: torch.Tensor,         # [n_pad] int32 latest argmax labels
    actions: torch.Tensor,     # [nb, block_v] int32 LA-selected actions
    feasible: torch.Tensor,    # [nb, k] f32 1.0 where p_mig(l) > 0
    *,
    block_v: int,
    k: int,
    weight_mode: str = "self_lambda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(hist_score, w_acc), both [nb, block_v, k] f32, by scatter-add."""
    check_mode(weight_mode, k)
    nb = edge_dst.shape[0]
    dst = edge_dst.long()
    rows = edge_rows.long()
    w = edge_vals
    nbr_lbl = labels[dst]
    lam_nbr = lam[dst]
    live = (w > 0).to(w.dtype)                        # padding kill
    agree = torch.gather(actions, 1, rows) == lam_nbr  # psi(v) == lambda(u)
    # block-major global rows, so one histogram covers every block
    flat_rows = (rows + torch.arange(nb, device=rows.device)[:, None] * block_v).reshape(-1)
    n_rows = nb * block_v
    hist = edge_histogram(flat_rows, nbr_lbl.reshape(-1), w.reshape(-1), n_rows, k)
    if weight_mode == "neighbor_lambda":
        val = torch.where(agree, w, torch.gather(feasible, 1, lam_nbr.long())) * live
        w_acc = edge_histogram(flat_rows, lam_nbr.reshape(-1), val.reshape(-1), n_rows, k)
    else:
        a_col = torch.where(agree, w, 0.0).reshape(-1)
        n_col = torch.where(agree, 0.0, live).reshape(-1)
        zeros = torch.zeros_like(flat_rows)
        w_acc = edge_histogram(torch.cat([flat_rows, flat_rows]),
                               torch.cat([zeros, zeros + 1]),
                               torch.cat([a_col, n_col]), n_rows, k)
    return hist.view(nb, block_v, k), w_acc.view(nb, block_v, k)


def expect(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    """Raise unless ``t`` has the device, dtype and shape a kernel takes and
    is contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def shared_bytes(row_cap: int, k: int, weight_mode: str) -> int:
    """Shared memory of one CTA of the kernel, laid out as in
    ``edge_phase.cu``: int32 hist sums [row_cap, k], w_acc sums [row_cap,
    k] (neighbor_lambda) or [row_cap, 2] (self_lambda), the span's row
    starts [row_cap + 1] and actions [row_cap], and k feasibility flags."""
    acols = k if weight_mode == "neighbor_lambda" else 2
    return 4 * (row_cap * k + row_cap * acols + 2 * row_cap + 1 + k)


def fused_edge_phase_cuda(
    edge_dst: torch.Tensor,    # [nb, e_max] int32
    edge_vals: torch.Tensor,   # [nb, e_max] f32
    row_ptr: torch.Tensor,     # [nb, block_v+1] int32 row runs of the slab
    spans,                     # SpanPlan built from row_ptr (nb blocks)
    labels: torch.Tensor,      # [n_pad] int32
    lam: torch.Tensor,         # [n_pad] int32
    actions: torch.Tensor,     # [nb, block_v] int32
    feasible: torch.Tensor,    # [nb, k] f32
    *,
    block_v: int,
    k: int,
    weight_mode: str = "self_lambda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the K1 kernel on the current stream of the tensors' device:
    one CTA per span of ``spans`` (a `SpanPlan` of these
    slabs, e.g. `DeviceGraph.blk_spans`), then, where the plan has hub
    rows, the pass that adds their pieces.

    Returns (hist_score, w_acc), both [nb, block_v, k] f32, allocated here.
    Raises on any input the kernel does not take, or if the launch fails.
    """
    check_mode(weight_mode, k)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the edge-phase kernel takes 1 <= k <= {MAX_K}, got {k}")
    dev = edge_dst.device
    if dev.type != "cuda":
        raise ValueError(f"fused_edge_phase_cuda needs CUDA tensors, got {dev}")
    nb, e_max = edge_dst.shape
    n_pad = labels.shape[0]
    expect(edge_dst, "edge_dst", torch.int32, (nb, e_max), dev)
    expect(edge_vals, "edge_vals", torch.float32, (nb, e_max), dev)
    expect(row_ptr, "row_ptr", torch.int32, (nb, block_v + 1), dev)
    expect(labels, "labels", torch.int32, (n_pad,), dev)
    expect(lam, "lam", torch.int32, (n_pad,), dev)
    expect(actions, "actions", torch.int32, (nb, block_v), dev)
    expect(feasible, "feasible", torch.float32, (nb, k), dev)
    n_span, n_hub = spans.spans.shape[1], spans.hubs.shape[1]
    expect(spans.spans, "spans.spans", torch.int32, (nb, n_span, 5), dev)
    expect(spans.hubs, "spans.hubs", torch.int32, (nb, n_hub, 3), dev)
    smem = shared_bytes(spans.row_cap, k, weight_mode)
    if smem > SHARED_LIMIT:
        raise ValueError(f"a span of {spans.row_cap} rows at k={k} needs {smem} bytes "
                         f"of shared memory, over {SHARED_LIMIT}")
    # 16-byte slab loads where every block's slab starts 16-byte aligned
    vec = int(e_max % 4 == 0 and edge_dst.data_ptr() % 16 == 0
              and edge_vals.data_ptr() % 16 == 0)
    hist = torch.empty((nb, block_v, k), dtype=torch.float32, device=dev)
    w_acc = torch.empty((nb, block_v, k), dtype=torch.float32, device=dev)
    # the hub pieces' int32 partial sums, indexed by span
    partial = torch.empty((nb, n_span if n_hub else 0, 2, k), dtype=torch.int32, device=dev)
    lib = _build.load("edge_phase")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.edge_phase_launch(
            edge_dst.data_ptr(), edge_vals.data_ptr(), row_ptr.data_ptr(),
            spans.spans.data_ptr(), spans.hubs.data_ptr(),
            labels.data_ptr(), lam.data_ptr(), actions.data_ptr(),
            feasible.data_ptr(), hist.data_ptr(), w_acc.data_ptr(),
            partial.data_ptr(), nb, e_max, block_v, k,
            int(weight_mode == "neighbor_lambda"), n_span, n_hub, spans.row_cap,
            vec, smem, stream)
    _build.check(lib, "edge_phase", code)
    LAUNCHES.add()
    return hist, w_acc
