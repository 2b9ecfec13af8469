"""Bytes the partitioner's kernels and supersteps must move, from shapes.

The yardstick of the benchmark's roofline shares: each count is the least
traffic the work needs (every input read once, every output written once),
divided by the H100's published HBM bandwidth. A share is that least time
over the measured device time, so it cannot pass 100 % unless the bytes are
counted too high or the time misses part of the work.

The kernel formulas are the bounds the port's kernel table states for K1
(the fused edge phase), K2 (the weighted LA update) and K3 (the edge
histogram, in the gather form the rules launch). The superstep counts are
the rule's work, not an implementation's launches, so a change that fuses
or removes a kernel is held to the same number.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # NVIDIA H100 SXM HBM3, data sheet
I32 = F32 = 4


def k1_bytes(live: int, block_v: int, n_pad: int, k: int) -> int:
    """One K1 launch over a block of ``live`` slab entries: the slab's
    neighbour ids and weights, the row pointer, labels and lambda of every
    vertex, the block's actions, the k feasibility flags, and the two
    [block_v, k] f32 outputs."""
    return (live * (I32 + F32) + (block_v + 1) * I32 + 2 * n_pad * I32 + block_v * I32
            + k * F32 + 2 * block_v * k * F32)


def k2_bytes(rows: int, k: int) -> int:
    """One K2 launch over [rows, k]: the probabilities, the LA weights and
    the reward/penalty signals read, and the probabilities written, each
    [rows, k] f32. The weights and signals are made for the same block just
    before K2 reads them, so at a block that fits in L2 part of the reads
    may come from there: the share then stands above the HBM traffic."""
    return 4 * rows * k * F32


def k3_bytes(live: int, blocks: int, block_v: int, k: int, n_pad: int) -> int:
    """One K3 launch (gather form) over ``blocks`` slabs holding ``live``
    entries: ids and weights, the row pointers, every label once, and the
    [blocks * block_v, k] f32 histogram."""
    return (live * (I32 + F32) + blocks * (block_v + 1) * I32 + blocks * block_v * k * F32
            + n_pad * I32)


def superstep_bytes(algo: str, entries: int, n_pad: int, k: int) -> int:
    """The least traffic of one superstep of a rule over a layout of
    ``entries`` slab entries: the slabs (ids and weights) and row pointers
    read once, the degrees and edge-weight sums read once, labels read and
    written once, the loads read and written once; Revolver also reads and
    writes lambda and its [n_pad, k] f32 probabilities, restream its
    per-vertex budgets."""
    base = (entries * (I32 + F32) + n_pad * I32 + 2 * n_pad * F32 + 2 * n_pad * I32
            + 2 * k * F32)
    if algo == "revolver":
        return base + 2 * n_pad * I32 + 2 * n_pad * k * F32
    if algo == "restream":
        return base + 2 * n_pad * I32
    if algo == "spinner":
        return base
    raise ValueError(f"no superstep byte count for {algo!r}")


def kernel_bytes_per_superstep(algo: str, block_live: list, block_v: int, n_pad: int,
                               k: int) -> dict:
    """{kernel: bytes one superstep of ``algo`` asks of it}: Revolver one K1
    and one K2 launch a block, restream one K3 launch a block, Spinner one
    K3 launch over every slab."""
    if algo == "revolver":
        return {"k1": sum(k1_bytes(live, block_v, n_pad, k) for live in block_live),
                "k2": len(block_live) * k2_bytes(block_v, k)}
    if algo == "restream":
        return {"k3": sum(k3_bytes(live, 1, block_v, k, n_pad) for live in block_live)}
    if algo == "spinner":
        return {"k3": k3_bytes(sum(block_live), len(block_live), block_v, k, n_pad)}
    raise ValueError(f"no kernel byte count for {algo!r}")


def share_pct(nbytes: float, seconds: float):
    """The bound's time over the measured time, in percent (None without a
    measured time)."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
