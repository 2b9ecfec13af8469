"""H1: the hub vote reconcile of hub replication.

Replaces no TPU kernel: `repro`'s reconcile (`repro.core.engine._hub_reconcile`)
is a ``lax.scan`` over the hub slots. Once a superstep, after the shards'
load deltas are merged, every hub slot takes the label its merged votes
prefer, gated on capacity by loads carried from slot to slot in slot order:

    cand[j] = argmax_l votes[j, l]            (ties to the lowest label)
    ok[j]   = owner[j] >= 0 and sum(votes[j]) > 0 and cand[j] != cur[j]
              and loads[cand[j]] + deg[j] <= cap
    where ok:  loads[cur[j]] -= deg[j];  loads[cand[j]] += deg[j]   (f32)

Two implementations of one function, bit-equal (winners and loads):

  * `hub_reconcile_plain` — pass 1 (totals, argmax, the "may move" flag)
    as tensor ops, then a loop over the flagged slots in f32; the CPU path
    and the oracle;
  * `hub_reconcile_cuda` — the hand-written kernel in
    ``csrc/hub_reconcile.cu`` (one CTA: pass 1 in parallel with an ordered
    compaction of the flagged slots, pass 2 one thread walking them with
    the loads in shared memory).

The vote table is int32: its entries are sums of integer edge weights, so
it is exact and does not depend on the order of the adds (`repro` sums the
same integers in f32, which is equal below 2^24).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

MAX_K = 1024

LAUNCHES = _build.LaunchCounter()


def hub_candidates(votes: torch.Tensor, cur: torch.Tensor, hub_owner: torch.Tensor):
    """Pass 1 of the reconcile: ``(cand, flagged)``, each slot's argmax label
    (int32, ties to the lowest) and whether it may move (every term of ``ok``
    but the capacity)."""
    total = votes.sum(dim=1, dtype=torch.int64)
    cand = torch.argmax(votes, dim=1).to(torch.int32)
    return cand, (hub_owner >= 0) & (total > 0) & (cand != cur)


def hub_reconcile_plain(votes: torch.Tensor, cur: torch.Tensor, hub_deg: torch.Tensor,
                        hub_owner: torch.Tensor, loads: torch.Tensor,
                        cap: torch.Tensor) -> torch.Tensor:
    """winners [hub_pad] int32; ``loads`` ([k] f32) updated in place. The
    capacity-gated walk runs on the host in f32 (numpy float32 scalars round
    every add like the device's f32 ops)."""
    cand, flagged = hub_candidates(votes, cur, hub_owner)
    winners = cur.clone()
    idx = torch.nonzero(flagged).view(-1)
    if idx.numel() == 0:
        return winners
    ld = loads.cpu().numpy().astype(np.float32, copy=True)
    capf = np.float32(float(cap))
    slots = idx.cpu().numpy()
    moved = []
    for j, c, p, d in zip(slots, cand[idx].tolist(), cur[idx].tolist(),
                          hub_deg[idx].cpu().numpy()):
        if ld[c] + d <= capf:
            ld[p] = ld[p] - d
            ld[c] = ld[c] + d
            moved.append(j)
    if moved:
        m = torch.as_tensor(np.asarray(moved, dtype=np.int64), device=winners.device)
        winners[m] = cand[m]
        loads.copy_(torch.from_numpy(ld))
    return winners


def hub_reconcile_cuda(votes: torch.Tensor, cur: torch.Tensor, hub_deg: torch.Tensor,
                       hub_owner: torch.Tensor, loads: torch.Tensor,
                       cap: torch.Tensor) -> torch.Tensor:
    """Launch H1 on the current stream of the tensors' device.

    ``votes`` is a contiguous int32 [hub_pad, k] CUDA tensor, ``cur`` and
    ``hub_owner`` int32 [hub_pad], ``hub_deg`` f32 [hub_pad], ``loads`` f32
    [k] (updated in place), ``cap`` a one-element f32 tensor. Returns the
    winners in a new int32 tensor; raises on any input the kernel does not
    take, or if the launch fails."""
    dev = votes.device
    if dev.type != "cuda":
        raise ValueError(f"hub_reconcile_cuda needs CUDA tensors, got {dev}")
    if votes.dim() != 2:
        raise ValueError(f"votes must be [hub_pad, k], got shape {tuple(votes.shape)}")
    hub_pad, k = votes.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the hub reconcile kernel takes 1 <= k <= {MAX_K}, got {k}")
    want = (("votes", votes, torch.int32, (hub_pad, k)), ("cur", cur, torch.int32, (hub_pad,)),
            ("hub_deg", hub_deg, torch.float32, (hub_pad,)),
            ("hub_owner", hub_owner, torch.int32, (hub_pad,)),
            ("loads", loads, torch.float32, (k,)), ("cap", cap, torch.float32, None))
    for name, t, dtype, shape in want:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cap.numel() != 1:
        raise ValueError(f"cap must hold one value, got shape {tuple(cap.shape)}")
    winners = torch.empty((hub_pad,), dtype=torch.int32, device=dev)
    scratch = torch.empty((max(hub_pad, 1), 4), dtype=torch.int32, device=dev)
    lib = _build.load("hub_reconcile")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.hub_reconcile_launch(
            votes.data_ptr(), cur.data_ptr(), hub_deg.data_ptr(), hub_owner.data_ptr(),
            loads.data_ptr(), cap.data_ptr(), winners.data_ptr(), scratch.data_ptr(),
            hub_pad, k, stream)
    _build.check(lib, "hub_reconcile", code)
    LAUNCHES.add()
    return winners
