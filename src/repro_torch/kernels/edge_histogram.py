"""K3: the edge label histogram of the Spinner and restream rules.

Replaces `repro.kernels.edge_histogram.edge_histogram_pallas`: over
per-block slot / row / value slabs,

  hist[b, r, l] = sum of vals[b, e] over entries with rows[b, e] == r and
                  slots[b, e] == l,

an ``[nb, block_v, k]`` f32 histogram. With the neighbors' labels as slots
and the eq.-(4) weights as values it is the tau numerator both rules score
with (Spinner over all blocks at once, restream one block at a time). In
the port's gather form the caller passes the neighbor ids ``dst`` and the
``labels`` vector instead of a slot slab: the slot of entry e is
``labels[dst[b, e]]``.

Implementations of one function:

  * `edge_histogram_plain` — one `index_put_(accumulate=True)` scatter by
    ``rows``, any row order; the CPU path and the oracle;
  * `edge_histogram_spans_cuda` — the rules' route, for integer values
    under K1's weight contract (`kernels.edge_phase`: each (row, slot) sum
    below 2^31; the eq.-(4) weights, or a contracted V-cycle level's sums
    of them), which the layout checks when it is built: the hand-written
    kernel in ``csrc/edge_histogram.cu`` over the layout's `SpanPlan` (K1's
    design: one CTA a span, coalesced 16-byte slab reads, int32 sums per
    (row, slot) in shared memory, hub rows in pieces added in order), in
    the slots form or the gather form; bit-equal to the plain version;
  * `edge_histogram_cuda` — the float route, for any f32 values (the TPU
    kernel's contract): the same file's row walk, one thread a row walking
    its run ``row_ptr[b, r] .. row_ptr[b, r+1]`` of the row-sorted slab,
    sums in registers, no atomics.

Unlike the TPU kernel there is no ``edge_chunk`` argument: nothing here
tiles the slab, so its length need not divide evenly.
"""
from __future__ import annotations

import torch

from repro_torch.core.lp import edge_histogram as _scatter_histogram
from repro_torch.kernels import _build
from repro_torch.kernels.edge_phase import MAX_K, SHARED_LIMIT, expect

# the C entry point's routes (`Route` in edge_histogram.cu)
ROUTE_ROW_WALK, ROUTE_SPAN_SLOTS, ROUTE_SPAN_GATHER = 0, 1, 2

LAUNCHES = _build.LaunchCounter()         # the span kernel (the rules' route)
FLOAT_LAUNCHES = _build.LaunchCounter()   # the row walk (the float route)


def _check_k(k: int, k_max: int | None = None) -> None:
    if k < 1 or (k_max is not None and k > k_max):
        bound = f"1 <= k <= {k_max}" if k_max is not None else "k >= 1"
        raise ValueError(f"the edge histogram takes {bound}, got k={k}")


def edge_histogram_plain(
    slots: torch.Tensor,   # [nb, e_max] int32 slot per entry
    rows: torch.Tensor,    # [nb, e_max] int32 local row per entry
    vals: torch.Tensor,    # [nb, e_max] f32 value (0 = padding)
    *,
    block_v: int,
    k: int,
) -> torch.Tensor:
    """hist [nb, block_v, k] f32 by scatter-add."""
    _check_k(k)
    nb = slots.shape[0]
    # block-major global rows, so one histogram covers every block
    flat_rows = rows.long() + torch.arange(nb, device=rows.device)[:, None] * block_v
    hist = _scatter_histogram(flat_rows.reshape(-1), slots.reshape(-1),
                              vals.reshape(-1), nb * block_v, k)
    return hist.view(nb, block_v, k)


def shared_bytes(row_cap: int, k: int) -> int:
    """Shared memory of one CTA of the span kernel, laid out as in
    ``edge_histogram.cu``: int32 sums [row_cap, k] and the span's row
    starts [row_cap + 1]."""
    return 4 * (row_cap * k + row_cap + 1)


def _launch(route: int, idx, vals, row_ptr, *, block_v: int, k: int, spans=None,
            labels=None) -> torch.Tensor:
    """Check the inputs, allocate the output and scratch, launch ``route``."""
    dev = idx.device
    nb, e_max = idx.shape
    expect(idx, "slots" if labels is None else "dst", torch.int32, (nb, e_max), dev)
    expect(vals, "vals", torch.float32, (nb, e_max), dev)
    expect(row_ptr, "row_ptr", torch.int32, (nb, block_v + 1), dev)
    n_span = n_hub = row_cap = vec = smem = 0
    span_t = hub_t = label_t = idx   # a valid pointer where the route reads none
    if spans is not None:
        n_span, n_hub, row_cap = spans.spans.shape[1], spans.hubs.shape[1], spans.row_cap
        expect(spans.spans, "spans.spans", torch.int32, (nb, n_span, 5), dev)
        expect(spans.hubs, "spans.hubs", torch.int32, (nb, n_hub, 3), dev)
        span_t, hub_t = spans.spans, spans.hubs
        smem = shared_bytes(row_cap, k)
        if smem > SHARED_LIMIT:
            raise ValueError(f"a span of {row_cap} rows at k={k} needs {smem} bytes "
                             f"of shared memory, over {SHARED_LIMIT}")
        # 16-byte slab loads where every block's slab starts 16-byte aligned
        vec = int(e_max % 4 == 0 and idx.data_ptr() % 16 == 0 and vals.data_ptr() % 16 == 0)
    if labels is not None:
        expect(labels, "labels", torch.int32, (labels.shape[0],), dev)
        label_t = labels
    hist = torch.empty((nb, block_v, k), dtype=torch.float32, device=dev)
    # the hub pieces' int32 partial sums, indexed by span
    partial = torch.empty((nb, n_span if n_hub else 0, k), dtype=torch.int32, device=dev)
    lib = _build.load("edge_histogram")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.edge_histogram_launch(
            idx.data_ptr(), vals.data_ptr(), row_ptr.data_ptr(), span_t.data_ptr(),
            hub_t.data_ptr(), label_t.data_ptr(), hist.data_ptr(), partial.data_ptr(),
            nb, e_max, block_v, k, route, n_span, n_hub, row_cap, vec, smem, stream)
    _build.check(lib, "edge_histogram", code)
    return hist


def _check_call(t: torch.Tensor, what: str, k: int) -> None:
    _check_k(k, MAX_K)
    if t.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {t.device}")


def edge_histogram_spans_cuda(
    idx: torch.Tensor,      # [nb, e_max] int32 slots, or neighbor ids with labels
    vals: torch.Tensor,     # [nb, e_max] f32 small non-negative integers
    row_ptr: torch.Tensor,  # [nb, block_v+1] int32 row runs of the slab
    spans,                  # SpanPlan built from row_ptr (nb blocks)
    *,
    block_v: int,
    k: int,
    labels: torch.Tensor | None = None,   # [n] int32: the gather form
) -> torch.Tensor:
    """Launch the K3 span kernel on the current stream of the tensors'
    device: one CTA per span of ``spans`` (e.g. `DeviceGraph.blk_spans`),
    then, where the plan has hub rows, the pass that adds their pieces.
    With ``labels`` the slot of entry e is ``labels[idx[b, e]]``, else
    ``idx[b, e]``.

    The values must be integers whose (row, slot) sums stay below 2^31
    (they are summed in int32 and written to f32 once): not checked here,
    which would cost a host sync; the layout checks its weights when it is
    built (`graphs.blocking.check_integer_weights`). Returns hist
    [nb, block_v, k] f32, allocated here.
    Raises on any input the kernel does not take, or if the launch fails.
    """
    _check_call(idx, "edge_histogram_spans_cuda", k)
    route = ROUTE_SPAN_SLOTS if labels is None else ROUTE_SPAN_GATHER
    hist = _launch(route, idx, vals, row_ptr, block_v=block_v, k=k, spans=spans,
                   labels=labels)
    LAUNCHES.add()
    return hist


def edge_histogram_cuda(
    slots: torch.Tensor,    # [nb, e_max] int32
    vals: torch.Tensor,     # [nb, e_max] f32, any values
    row_ptr: torch.Tensor,  # [nb, block_v+1] int32 row runs of the slab
    *,
    block_v: int,
    k: int,
) -> torch.Tensor:
    """Launch the K3 row walk (the float route) on the current stream of
    the tensors' device.

    Returns hist [nb, block_v, k] f32, allocated here. Raises on any input
    the kernel does not take, or if the launch fails.
    """
    _check_call(slots, "edge_histogram_cuda", k)
    hist = _launch(ROUTE_ROW_WALK, slots, vals, row_ptr, block_v=block_v, k=k)
    FLOAT_LAUNCHES.add()
    return hist
