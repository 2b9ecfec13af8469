"""H1: the hub vote reconcile of hub replication.

Replaces no TPU kernel: `repro`'s reconcile (`repro.core.engine._hub_reconcile`)
is a ``lax.scan`` over the hub slots. Once a superstep, after the shards'
load deltas are merged, every hub slot takes the label its merged votes
prefer, gated on capacity by loads carried from slot to slot in slot order:

    cand[j] = argmax_l votes[j, l]            (ties to the lowest label)
    ok[j]   = owner[j] >= 0 and sum(votes[j]) > 0 and cand[j] != cur[j]
              and loads[cand[j]] + deg[j] <= cap
    where ok:  loads[cur[j]] -= deg[j];  loads[cand[j]] += deg[j]   (f32)

Three implementations of one function, bit-equal (winners and loads):

  * `hub_reconcile_plain` — pass 1 (totals, argmax, the "may move" flag)
    as tensor ops, then a loop over the flagged slots in f32; the CPU path
    and the oracle;
  * `hub_reconcile_schedule` — the kernel's schedule written out on the
    host: where `parallel_walk_exact` holds, the flagged slots are walked
    in integers, in windows whose outcomes are speculated, verified and
    committed up to the first wrong guess, with serial steps where guesses
    fail densely; otherwise the f32 loop. Only the tests and the card
    checks call it: it says how many rounds the kernel takes;
  * `hub_reconcile_cuda` — the hand-written kernel in
    ``csrc/hub_reconcile.cu``: pass 1 over the grid, then one CTA that
    walks the flagged slots in that schedule.

The vote table is int32: its entries are sums of integer edge weights, so
it is exact and does not depend on the order of the adds (`repro` sums the
same integers in f32, which is equal below 2^24).

Why the integer walk is the f32 walk: f32 holds every integer of
magnitude at most 2^24 exactly, so where every load and every flagged
degree is such an integer (no -0.0 load) and no load the walk can reach
leaves [-2^24, 2^24], each f32 add and subtract of the serial walk is
exact, and the gate ``load + d <= cap`` of an integer is
``load + d <= floor(cap)``. A load only rises through a move that the
gate takes, so it stays at most max(max loads, floor(cap)), and the sum
it is gated on at most that plus the largest degree; it only falls
through moves out, so by at most the flagged degrees' sum, and not below
the loads' sum less what the other labels can hold. Integer adds are
exact in any order, which lets the walk add a window's deltas as a
prefix scan.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

MAX_K = 1024
EXACT = 1 << 24              # f32 holds every integer of magnitude <= 2^24
CAP_CLAMP = 1 << 30          # floor(cap) clamped to +-2^30 (NaN: -2^30, takes nothing)
PARALLEL_MAX_K = 32          # the integer walk keeps one label a lane of a warp
# the kernel's schedule (csrc/hub_reconcile.cu): a window of 8 warps of 32
# slots, the flagged slots staged 4,096 at a time, and after a round that
# commits fewer than SERIAL_BELOW slots, SERIAL_STEPS slots walked one at a
# time
WINDOW = 256
CHUNK = 4096
SERIAL_BELOW = 32
SERIAL_STEPS = 256
# the kernel's pass 1 has at most 512 CTAs; its scratch holds the
# compacted segments, two int4 a CTA and one int4 of the walk's counts
# (body, rounds, serial steps, flagged)
MAX_FLAG_CTAS = 512

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


def cap_int(cap) -> int:
    """The integer ``x <= cap`` compares with: floor(cap), clamped to
    +-2^30, and -2^30 for NaN (a NaN capacity takes no move)."""
    c = np.float32(float(cap))
    if np.isnan(c):
        return -CAP_CLAMP
    return int(min(max(np.floor(c), -CAP_CLAMP), CAP_CLAMP))


def parallel_walk_exact(flagged_deg, loads, cap) -> bool:
    """Whether the integer walk is bit-equal to the serial f32 walk (the
    module's docstring says why): every flagged degree an integer in
    [0, 2^24], every load an integer of magnitude <= 2^24 and not -0.0,
    top + max degree <= 2^24 where top = max(max loads, floor(cap)), and a
    floor under every load the walk reaches >= -2^24: the larger of min
    loads - the flagged degrees' sum, and the loads' sum - (k - 1) top
    (the sum does not change, and no other label holds more than top).
    The kernel decides the same on the device from pass 1's reductions."""
    d = np.asarray(flagged_deg, dtype=np.float32)
    ld = np.asarray(loads, dtype=np.float32)
    with np.errstate(invalid="ignore"):
        if not ((d >= 0) & (d <= EXACT) & (d == np.trunc(d))).all():
            return False
        if not ((np.abs(ld) <= EXACT) & (ld == np.trunc(ld))
                & ~((ld == 0) & np.signbit(ld))).all():
            return False
    top = max(int(ld.max()), cap_int(cap))
    max_d = int(d.max()) if d.size else 0
    low = max(int(ld.min()) - int(d.astype(np.int64).sum()),
              int(ld.astype(np.int64).sum()) - (ld.size - 1) * top)
    return top + max_d <= EXACT and low >= -EXACT


def hub_reconcile_schedule(votes: torch.Tensor, cur: torch.Tensor, hub_deg: torch.Tensor,
                           hub_owner: torch.Tensor, loads: torch.Tensor, cap: torch.Tensor,
                           *, window: int = WINDOW, chunk: int = CHUNK,
                           serial_below: int = SERIAL_BELOW, serial_steps: int = SERIAL_STEPS):
    """The kernel's walk on the host: ``(winners, counts)``, ``loads``
    updated in place, bit-equal to `hub_reconcile_plain`. ``counts`` holds
    the body that ran (``parallel`` where k <= 32 and `parallel_walk_exact`
    holds, else ``serial``, the f32 loop), its rounds and serial steps, and
    the flagged count.

    The parallel body takes the flagged slots ``chunk`` at a time and
    each chunk in windows of ``window``, in integers. In a round every slot
    i of the window has a guessed outcome o_i and a gate g_i: its target's
    load as carried, plus the deltas of the window's earlier slots guessed
    taken (+d into their target, -d out of their label), plus d_i, at most
    floor(cap). Up to the first i with g_i != o_i every guess was right, so
    those gates and g_i are the serial walk's: slots 0..i commit, and the
    next round starts at i + 1, guessing for the slots this round saw the
    gates it gave them, and for the others their gate against the loads as
    carried (the window's deltas left out). A round commits one slot at
    least, and a window where the guesses hold. A round that commits fewer
    than ``serial_below`` slots is followed by ``serial_steps`` slots
    walked one at a time, and the guesses start afresh."""
    cand, flagged = hub_candidates(votes, cur, hub_owner)
    winners = cur.clone()
    idx = torch.nonzero(flagged).view(-1)
    n, k = idx.numel(), votes.shape[1]
    slots = idx.cpu().numpy()
    c_all = cand[idx].cpu().numpy().astype(np.int64)
    p_all = cur[idx].cpu().numpy().astype(np.int64)
    d_f32 = hub_deg[idx].cpu().numpy().astype(np.float32)
    ld = loads.cpu().numpy().astype(np.float32, copy=True)
    parallel = k <= PARALLEL_MAX_K and parallel_walk_exact(d_f32, ld, cap)
    counts = {"body": "parallel" if parallel else "serial", "rounds": 0, "serial_steps": 0,
              "flagged": n}
    if n == 0:
        return winners, counts
    if not parallel:
        return hub_reconcile_plain(votes, cur, hub_deg, hub_owner, loads, cap), counts
    capi = cap_int(cap)
    load = ld.astype(np.int64)
    d_all = d_f32.astype(np.int64)
    taken = np.zeros(n, dtype=bool)
    for q0 in range(0, n, chunk):
        m = min(chunk, n - q0)
        c, p, d = c_all[q0:q0 + m], p_all[q0:q0 + m], d_all[q0:q0 + m]
        carried = np.zeros(0, dtype=bool)    # guesses carried from the last round
        base = 0
        while base < m:
            w = min(window, m - base)
            cw, pw, dw = c[base:base + w], p[base:base + w], d[base:base + w]
            # a slot with no carried guess guesses its gate against the
            # loads as carried, without the window's earlier deltas
            o = load[cw] + dw <= capi
            o[:min(carried.size, w)] = carried[:w]
            rows = np.arange(w)
            delta = np.zeros((w, k), dtype=np.int64)
            dv = np.where(o, dw, 0)
            delta[rows, cw] += dv
            delta[rows, pw] -= dv
            before = np.cumsum(delta, axis=0) - delta
            gate = load[cw] + before[rows, cw] + dw <= capi
            wrong = np.flatnonzero(gate != o)
            done = int(wrong[0]) + 1 if wrong.size else w
            for i in np.flatnonzero(gate[:done]):
                load[cw[i]] += dw[i]
                load[pw[i]] -= dw[i]
            taken[q0 + base:q0 + base + done] = gate[:done]
            carried = gate[done:]
            base += done
            counts["rounds"] += 1
            if done < serial_below:          # guesses fail densely: walk a while
                for i in range(base, min(m, base + serial_steps)):
                    if load[c[i]] + d[i] <= capi:
                        load[c[i]] += d[i]
                        load[p[i]] -= d[i]
                        taken[q0 + i] = True
                    counts["serial_steps"] += 1
                base = min(m, base + serial_steps)
                carried = np.zeros(0, dtype=bool)
    moved = torch.as_tensor(slots[taken], device=winners.device)
    winners[moved] = cand[moved]
    loads.copy_(torch.from_numpy(load.astype(np.float32)))
    return winners, counts


def _launch(votes: torch.Tensor, cur: torch.Tensor, hub_deg: torch.Tensor,
            hub_owner: torch.Tensor, loads: torch.Tensor, cap: torch.Tensor):
    """Check the inputs, launch H1, count it; ``(winners, scratch)``."""
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
    # the compacted segments, two records a pass-1 CTA, the walk's counts
    scratch = torch.empty((max(hub_pad, 1) + 2 * MAX_FLAG_CTAS + 1, 4), dtype=torch.int32,
                          device=dev)
    lib = _build.load("hub_reconcile")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.hub_reconcile_launch(
            votes.data_ptr(), cur.data_ptr(), hub_deg.data_ptr(), hub_owner.data_ptr(),
            loads.data_ptr(), cap.data_ptr(), winners.data_ptr(), scratch.data_ptr(),
            hub_pad, k, stream)
    _build.check(lib, "hub_reconcile", code)
    LAUNCHES.add()
    return winners, scratch


def hub_reconcile_cuda(votes: torch.Tensor, cur: torch.Tensor, hub_deg: torch.Tensor,
                       hub_owner: torch.Tensor, loads: torch.Tensor,
                       cap: torch.Tensor) -> torch.Tensor:
    """Launch H1 on the current stream of the tensors' device.

    ``votes`` is a contiguous int32 [hub_pad, k] CUDA tensor, ``cur`` and
    ``hub_owner`` int32 [hub_pad], ``hub_deg`` f32 [hub_pad], ``loads`` f32
    [k] (updated in place), ``cap`` a one-element f32 tensor. Returns the
    winners in a new int32 tensor; raises on any input the kernel does not
    take, or if the launch fails."""
    return _launch(votes, cur, hub_deg, hub_owner, loads, cap)[0]


def hub_reconcile_cuda_counts(votes: torch.Tensor, cur: torch.Tensor, hub_deg: torch.Tensor,
                              hub_owner: torch.Tensor, loads: torch.Tensor, cap: torch.Tensor):
    """`hub_reconcile_cuda`, then the walk's counts as
    `hub_reconcile_schedule` gives them (body, rounds, serial steps,
    flagged): ``(winners, counts)``. Reading the counts waits for the
    card; the card checks call it, the main path does not."""
    winners, scratch = _launch(votes, cur, hub_deg, hub_owner, loads, cap)
    body, rounds, steps, flagged = scratch[-1].tolist()
    return winners, {"body": "parallel" if body else "serial", "rounds": rounds,
                     "serial_steps": steps, "flagged": flagged}
