"""K3: the edge label histogram of the Spinner and restream rules.

Replaces `repro.kernels.edge_histogram.edge_histogram_pallas`: over
per-block slot / row / value slabs,

  hist[b, r, l] = sum of vals[b, e] over entries with rows[b, e] == r and
                  slots[b, e] == l,

an ``[nb, block_v, k]`` f32 histogram. With the neighbors' labels as slots
and the eq.-(4) weights as values it is the tau numerator both rules score
with (Spinner over all blocks at once, restream one block at a time).

Two implementations of one function:

  * `edge_histogram_plain` — one `index_put_(accumulate=True)` scatter by
    ``rows``, any row order; the CPU path and the oracle;
  * `edge_histogram_cuda` — the hand-written kernel in
    ``csrc/edge_histogram.cu`` (one thread per row walking the row's run
    ``row_ptr[b, r] .. row_ptr[b, r+1]`` of the row-sorted slab, sums in
    registers, no atomics).

On the eq.-(4) weights (integers in {1, 2}) both are exact and agree bit
for bit. Unlike the TPU kernel there is no ``edge_chunk`` argument: nothing
here tiles the slab, so its length need not divide evenly.
"""
from __future__ import annotations

import torch

from repro_torch.core.lp import edge_histogram as _scatter_histogram
from repro_torch.kernels import _build
from repro_torch.kernels.edge_phase import MAX_K, expect

LAUNCHES = _build.LaunchCounter()


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


def edge_histogram_cuda(
    slots: torch.Tensor,    # [nb, e_max] int32
    vals: torch.Tensor,     # [nb, e_max] f32
    row_ptr: torch.Tensor,  # [nb, block_v+1] int32 row runs of the slab
    *,
    block_v: int,
    k: int,
) -> torch.Tensor:
    """Launch the K3 kernel on the current stream of the tensors' device.

    Returns hist [nb, block_v, k] f32, allocated here. Raises on any input
    the kernel does not take, or if the launch fails.
    """
    _check_k(k, MAX_K)
    dev = slots.device
    if dev.type != "cuda":
        raise ValueError(f"edge_histogram_cuda needs CUDA tensors, got {dev}")
    nb, e_max = slots.shape
    expect(slots, "slots", torch.int32, (nb, e_max), dev)
    expect(vals, "vals", torch.float32, (nb, e_max), dev)
    expect(row_ptr, "row_ptr", torch.int32, (nb, block_v + 1), dev)
    hist = torch.empty((nb, block_v, k), dtype=torch.float32, device=dev)
    lib = _build.load("edge_histogram")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.edge_histogram_launch(
            slots.data_ptr(), vals.data_ptr(), row_ptr.data_ptr(),
            hist.data_ptr(), nb, e_max, block_v, k, stream)
    _build.check(lib, "edge_histogram", code)
    LAUNCHES.add()
    return hist
