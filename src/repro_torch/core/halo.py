"""Static halo-exchange plan for the sharded superstep.

The port's copy of `repro.core.halo`: the plan is numpy and stays numpy in
the spec (`repro` commits its arrays to the mesh here; the port's layout
uploads each shard's slice to that shard's device,
`repro_torch.core.device_graph.shard_device_graph`). The collectives named
below are `repro_torch.parallel.collectives`'.

The full-gather Jacobi schedule (``chunk_schedule="sharded"``) all-gathers
every per-vertex state field once per superstep — O(n_pad) cross-device
traffic regardless of how local the partition's block->shard assignment is.
But the set of *remote* vertices a shard's edge slabs actually reference is
static (it depends only on the graph layout, not on labels), so the sync can
be precomputed. Three exchange granularities exist, picked per layout:

**Block halo** (the first plan): each shard contributes only its **boundary
blocks** (blocks some other shard references) to one all-gather of shape
``[b_max, block_v]`` per field, and every slab's neighbor ids are rewritten
host-side to index the shard's assembled ``local + halo`` buffer directly.
Traffic per superstep per field drops from ``(S-1) * blocks_per_shard *
block_v`` to ``(S-1) * b_max * block_v`` elements per device — proportional
to the block-level edge cut, i.e. to partition quality.

**Per-vertex halo** (``granularity="vertex"``): the remote need set is
resolved to individual vertices. ``send_ids[s, t]`` lists the local rows
shard ``s`` sends to shard ``t`` (the transpose of ``t``'s need list),
padded to a common ragged bound ``h_max``; one ``all_to_all`` moves exactly
those rows (``parallel.collectives.vertex_halo_exchange``). Traffic is
``(S-1) * h_max`` elements per field — on power-law graphs where one hot
boundary block inflates ``b_max`` to the whole shard, the per-vertex plan
still moves only the rows actually read. ``granularity="auto"`` (the
default) picks whichever plan moves fewer elements (ties prefer the block
plan, preserving the block plan's layouts bit-for-bit).

**Hub replication** (``hubs=HubConfig(...)``): the top-H "hub" vertices —
the handful of high-degree vertices that make *every* block a boundary
block on WIKI/LJ-style graphs — are excluded from the halo need sets
entirely and instead mirrored into a replicated region appended to every
shard's buffer. Each superstep assembles the region with one O(hub_pad)
psum from the owners' slices (exact: one contributor per slot), and after
the scan a per-superstep psum over weighted one-hot label **votes**
(O(hub_pad * k), never O(E)) reconciles each hub to a single winner label
with a deterministic capacity-gated argmax (ties break to the lowest
partition index). Hubs are frozen during the scan (``vmask_nonhub``), so
every shard reads a consistent snapshot. The port's engine runs the
reconcile once, on the mesh's home device, with the vote table in int32
(`repro_torch.core.engine`, kernel H1 in `repro_torch.kernels.hub_reconcile`).

Exactness: without hubs, both halo granularities deliver the same
start-of-superstep snapshots of remote vertices that the full gather would,
and the shard's own (drifting) slice sits at the front of the buffer, so a
chunk rule sees bit-identical values through the rewritten indices —
``"halo"`` is an exact optimization of ``"sharded"``'s sync, gated
bit-for-bit by tests and the scaling bench. With hubs on, the vote
reconciliation is itself exact arithmetic, so the 1-shard hub plan matches
the sequential hub plan bit-for-bit, but multi-shard hub runs follow a
different (better-scaling) trajectory than hub-less runs and are gated on
converged quality/balance instead (see docs/observability.md).

When the chosen exchange would move nearly as much as the plain all-gather
(``coverage`` at or above ``threshold``) the spec records ``fallback=True``
and the engine runs the full-gather schedule instead (hub replication is
disabled too — there is no halo left to shrink).

**Interior/boundary split** (``chunk_schedule="async"``): the slab rewrite
also classifies every block. A block whose rewritten neighbor ids all fall
inside the shard's own slice (``< local_n``) is *interior* — it reads no
exchanged and no hub-replicated vertex, so the async schedule can scan it
while the halo exchange for this superstep is still in flight. Every other
block is *boundary* (it reads the tail or the hub region) and must wait for
the exchange. ``interior_split`` is the number of leading interior blocks
common to every shard — the static phase-1 scan length of the async
superstep (`repro_torch.core.engine`); `interior_first_order` returns the
intra-shard reorder that maximizes it. The classification is derived from
``mapped`` (the same array the rewrite ships), so the split invariants are
structural (`repro`'s ``tests/test_async.py`` pins them; the port's tests
hold this copy's arrays equal to `repro`'s).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

DEFAULT_HALO_THRESHOLD = 0.75
DEFAULT_HUB_MAX_FRAC = 0.05


@dataclasses.dataclass(frozen=True)
class HubConfig:
    """Hub-replication knobs (Spinner-style high-degree mirroring).

    ``quantile > 0`` selects every real vertex at or above that outdegree
    quantile (deterministic and shard-count independent, so a 1-shard run
    replicates the same hubs as the sequential reference). ``quantile == 0``
    (the default) sizes the set automatically: H doubles from 1 until the
    per-vertex halo coverage *excluding* hubs drops below
    ``target_coverage`` (default: the plan's fallback ``threshold`` capped
    at `DEFAULT_HALO_THRESHOLD`, so threshold > 1 "never fall back" plans
    still grow a useful hub set),
    ranking candidates by how many remote shards reference them (ties by
    degree, then id). Either way the set is capped at ``max_frac`` of the
    real vertices — replicas cost O(hub_pad * (fields + k)) psum traffic
    per superstep, so the cap keeps the cure cheaper than the disease.
    """

    quantile: float = 0.0
    target_coverage: Optional[float] = None
    max_frac: float = DEFAULT_HUB_MAX_FRAC

    def __post_init__(self):
        if not 0.0 <= self.quantile < 1.0:
            raise ValueError(f"quantile must be in [0, 1), got {self.quantile}")
        if not 0.0 < self.max_frac <= 1.0:
            raise ValueError(f"max_frac must be in (0, 1], got {self.max_frac}")


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    """Precomputed halo-exchange plan for one (layout, n_shards) pair.

    Built host-side by `build_halo_spec`; consumed by the engine's halo
    superstep. All ids are in the layout's storage space (i.e. *after* any
    locality permutation — see `device_graph.permute_blocks`).
    """

    n_shards: int
    blocks_per_shard: int
    block_v: int
    b_max: int              # padded boundary-block count per shard
    coverage: float         # chosen exchange elems / full-gather elems
    threshold: float        # fallback trigger the spec was built with
    fallback: bool          # True -> engine runs the full-gather schedule
    halo_blocks: Tuple[int, ...]      # per shard: #remote blocks it references
    boundary_blocks: Tuple[int, ...]  # per shard: #own blocks others reference
    boundary_rows: np.ndarray          # [S, b_max] int32 local block index
                                      # within the owner (0-padded)
    blk_dst_halo: Optional[np.ndarray]  # [n_blocks, e_max] int32 neighbor ids
                                       # rewritten into local+halo buffer space
                                       # (None when fallback)
    # --- per-vertex (sub-block) exchange plan ---------------------------- #
    granularity: str = "block"         # chosen: "block" | "vertex"
    h_max: int = 0                     # padded per-pair need-list length
    send_ids: Optional[np.ndarray] = None  # [S, S, h_max] int32 local rows
                                          # shard s sends to shard t
                                          # (vertex granularity only)
    # --- hub replication plan -------------------------------------------- #
    n_hubs: int = 0
    hub_pad: int = 0                   # replicated-region length (>= n_hubs)
    hub_ids: Tuple[int, ...] = ()      # storage vertex ids, ascending
    hub_owner: Optional[np.ndarray] = None  # [hub_pad] int32 owner shard (-1 pad)
    hub_local: Optional[np.ndarray] = None  # [hub_pad] int32 local row in owner
    hub_deg: Optional[np.ndarray] = None    # [hub_pad] f32 outdegree (0 pad)
    he_max: int = 0                    # padded per-shard hub-edge count
    hub_src: Optional[np.ndarray] = None    # [S, he_max] int32 local src row
    hub_slot: Optional[np.ndarray] = None   # [S, he_max] int32 hub slot
    hub_w: Optional[np.ndarray] = None      # [S, he_max] f32 vote weight (0 pad)
    vmask_nonhub: Optional[np.ndarray] = None  # [n_pad] bool vmask minus hubs
    # --- interior/boundary split (chunk_schedule="async") ----------------- #
    block_is_boundary: Tuple[bool, ...] = ()  # [n_blocks] True iff the block
                                              # reads the exchanged tail or
                                              # the replicated hub region
                                              # (empty when fallback)
    interior_counts: Tuple[int, ...] = ()     # per shard: #interior blocks
    interior_split: int = 0                   # leading interior blocks common
                                              # to every shard — the async
                                              # schedule's phase-1 scan length

    @property
    def local_n(self) -> int:
        return self.blocks_per_shard * self.block_v

    @property
    def exchange_len(self) -> int:
        """Length of the exchanged tail appended to the shard's own slice."""
        if self.granularity == "vertex":
            return self.n_shards * self.h_max
        return self.n_shards * self.b_max * self.block_v

    @property
    def buf_len(self) -> int:
        """Length of the per-shard drifting buffer: the shard's own slice,
        the exchanged halo tail, then the replicated hub region."""
        return self.local_n + self.exchange_len + self.hub_pad

    @property
    def decision(self) -> str:
        """What the engine actually runs: "full-gather" | "block-halo" |
        "per-vertex" (the satellite observability knob for BENCH_scaling)."""
        if self.fallback:
            return "full-gather"
        return "per-vertex" if self.granularity == "vertex" else "block-halo"

    def gathered_elems_per_device(self) -> int:
        """Per-vertex-field elements a device receives per superstep (the
        chosen halo exchange if active, the full gather under fallback)."""
        if self.fallback:
            return self.full_gather_elems_per_device()
        if self.granularity == "vertex":
            return (self.n_shards - 1) * self.h_max
        return (self.n_shards - 1) * self.b_max * self.block_v

    def full_gather_elems_per_device(self) -> int:
        return (self.n_shards - 1) * self.blocks_per_shard * self.block_v

    def wire_bytes_per_elem(self, k: int, int8_field: bool = True) -> int:
        """Wire width of one exchanged element. The per-vertex tail moves
        label-valued fields (``Algorithm.wire_int8_fields``) on an int8
        wire when every value fits (``k <= 127``) — exact, 4x narrower;
        the block exchange and the full gather move storage-width int32."""
        if (self.granularity == "vertex" and not self.fallback
                and int8_field and k <= 127):
            return 1
        return 4

    def hub_sync_elems_per_device(self, k: int, n_fields: int) -> int:
        """Elements per device per superstep spent on hub replication: one
        [hub_pad] assembly psum per synchronized field, one [hub_pad]
        current-label psum, and the [hub_pad, k] vote psum. Honest traffic
        accounting — the bench counts this against the halo's reduction."""
        if self.hub_pad == 0 or self.fallback:
            return 0
        return self.hub_pad * (n_fields + 1 + k)


def _select_hubs(
    cfg: HubConfig,
    *,
    deg: np.ndarray,
    vmask: np.ndarray,
    need_count: np.ndarray,
    pair_lists: Sequence[np.ndarray],
    local_n: int,
    floor_ids: np.ndarray,
    threshold: float,
) -> np.ndarray:
    """Pick the hub id set (ascending, floor ids always included)."""
    n_pad = deg.shape[0]
    is_floor = np.zeros(n_pad, dtype=bool)
    is_floor[floor_ids] = True
    n_real = int(np.count_nonzero(vmask))
    cap = max(int(cfg.max_frac * n_real), 1)

    if cfg.quantile > 0.0:
        cand = np.flatnonzero(vmask & (deg > 0) & ~is_floor)
        selected = np.empty(0, dtype=np.int64)
        if cand.size:
            thr = np.quantile(deg[cand], cfg.quantile)
            sel = cand[deg[cand] >= thr]
            # highest degree first, ties by id; cap applies to new picks only
            sel = sel[np.lexsort((sel, -deg[sel]))]
            selected = sel[:cap].astype(np.int64)
        return np.unique(np.concatenate([floor_ids, selected]))

    # auto: rank remote-referenced vertices by (#needing shards, degree, id)
    eligible = np.flatnonzero((need_count > 0) & vmask & ~is_floor)
    ranked = eligible[np.lexsort(
        (eligible, -deg[eligible], -need_count[eligible]))]
    rank_of = np.full(n_pad, np.iinfo(np.int64).max, dtype=np.int64)
    rank_of[ranked] = np.arange(ranked.size)
    rank_of[floor_ids] = -1         # floor hubs are always excluded
    pair_ranks = [np.sort(rank_of[ids]) for ids in pair_lists]

    def hmax_at(h: int) -> int:
        m = 0
        for pr in pair_ranks:
            m = max(m, int(pr.size - np.searchsorted(pr, h)))
        return m

    # The bench convention sets threshold > 1 to pin the halo schedule on
    # (never fall back); a coverage *goal* above 1 would make hub selection
    # a no-op exactly where hubs matter, so the auto target caps at the
    # default fallback threshold.
    target = cfg.target_coverage if cfg.target_coverage is not None \
        else min(threshold, DEFAULT_HALO_THRESHOLD)
    H = 0
    if local_n > 0 and hmax_at(0) / local_n >= target:
        H = 1
        while H < cap and hmax_at(H) / local_n >= target:
            H *= 2
    H = min(H, cap, ranked.size)
    return np.unique(np.concatenate([floor_ids, ranked[:H].astype(np.int64)]))


def build_halo_spec(
    blk_dst: np.ndarray,
    blk_w: np.ndarray,
    n_shards: int,
    block_v: int,
    *,
    threshold: float = DEFAULT_HALO_THRESHOLD,
    granularity: str = "auto",
    b_max_floor: int = 0,
    h_max_floor: int = 0,
    hubs: Optional[HubConfig] = None,
    deg: Optional[np.ndarray] = None,
    vmask: Optional[np.ndarray] = None,
    blk_row: Optional[np.ndarray] = None,
    hub_ids_floor: Sequence[int] = (),
    hub_pad_floor: int = 0,
    he_max_floor: int = 0,
) -> HaloSpec:
    """Compute the static halo sets and the buffer-space slab rewrite.

    `blk_dst` / `blk_w` are the (host) padded edge slabs in storage order;
    shard s owns the contiguous block range [s*bps, (s+1)*bps). Padding
    slots (w == 0) are ignored for set membership and their rewritten index
    is clamped to 0 — they are only ever read under a zero weight.

    `granularity` selects the exchange plan ("auto" | "block" | "vertex",
    see module docstring); `hubs` enables hub replication, which needs the
    per-vertex `deg` / `vmask` arrays and the `blk_row` slabs (to build the
    vote tables). The `*_floor` arguments let streaming callers keep the
    exchange shapes and hub set stable while halo sets evolve (growth past
    a floor re-pads; the hub set only ever grows — `hub_ids_floor` carries
    the previous deltas' hubs).
    """
    blk_dst = np.asarray(blk_dst)
    blk_w = np.asarray(blk_w)
    nb, e_max = blk_dst.shape
    if nb % n_shards != 0:
        raise ValueError(f"n_blocks={nb} not divisible by n_shards={n_shards}")
    if granularity not in ("auto", "block", "vertex"):
        raise ValueError(
            f"granularity must be 'auto' | 'block' | 'vertex', "
            f"got {granularity!r}")
    bps = nb // n_shards
    local_n = bps * block_v
    n_pad = nb * block_v
    owner = np.arange(nb, dtype=np.int64) // bps      # shard of each slab row
    row_owner = np.broadcast_to(owner[:, None], (nb, e_max))
    dst = blk_dst.astype(np.int64)
    dst_blk = dst // block_v
    dst_owner = dst_blk // bps
    real = blk_w > 0
    remote = dst_owner != row_owner

    # ---- hub selection (from the raw remote-reference structure) -------- #
    floor_ids = np.unique(np.asarray(sorted(int(h) for h in hub_ids_floor),
                                     dtype=np.int64))
    hub_ids = floor_ids
    # unique (needer shard, vertex) remote-reference pairs; sorted by
    # (needer, vertex), so per-(needer, owner) runs are contiguous
    if hubs is not None:
        # (the port computes these only for hub selection, which alone
        # reads them: an O(E log E) sort saved on every hub-less plan)
        rmask = real & remote
        pair_keys = np.unique(
            row_owner[rmask].astype(np.int64) * n_pad + dst[rmask])
        pair_needer = pair_keys // n_pad
        pair_vertex = pair_keys % n_pad
        if deg is None or vmask is None:
            raise ValueError("hub replication needs deg= and vmask= arrays")
        if blk_row is None:
            raise ValueError("hub replication needs the blk_row= slabs")
        deg = np.asarray(deg, dtype=np.float32)
        vmask = np.asarray(vmask, dtype=bool)
        need_count = np.bincount(pair_vertex, minlength=n_pad)
        pair_owner = pair_vertex // local_n
        pair_group = pair_needer * n_shards + pair_owner
        pair_lists = [pair_vertex[pair_group == gid]
                      for gid in np.unique(pair_group)]
        hub_ids = _select_hubs(
            hubs, deg=deg, vmask=vmask, need_count=need_count,
            pair_lists=pair_lists, local_n=local_n, floor_ids=floor_ids,
            threshold=threshold)
    n_hubs = int(hub_ids.size)
    hub_pad = max(n_hubs, hub_pad_floor)
    is_hub = np.zeros(n_pad, dtype=bool)
    is_hub[hub_ids] = True
    slot_of = np.full(n_pad, -1, dtype=np.int64)
    slot_of[hub_ids] = np.arange(n_hubs)
    # (the port skips the hub gathers without hubs: an O(E) pass each)
    hub_ref = is_hub[dst] if n_hubs else np.zeros(dst.shape, dtype=bool)
    ref_ok = real & ~hub_ref if n_hubs else real   # slots the exchange covers

    # ---- block-granularity sets (hub refs excluded) --------------------- #
    need = [set() for _ in range(n_shards)]
    for b in range(nb):
        refs = np.unique(dst_blk[b][ref_ok[b]])
        need[int(owner[b])].update(int(r) for r in refs)
    halo_blocks = []
    for s in range(n_shards):
        need[s] = sorted(d for d in need[s] if owner[d] != s)
        halo_blocks.append(len(need[s]))
    send = [set() for _ in range(n_shards)]
    for s in range(n_shards):
        for d in need[s]:
            send[int(owner[d])].add(d)
    send = [sorted(t) for t in send]
    boundary_blocks = tuple(len(t) for t in send)
    b_max = max(max(boundary_blocks, default=0), b_max_floor)

    # ---- vertex-granularity sets (hub refs excluded) -------------------- #
    vmask_ok = ref_ok & remote
    # `repro`'s np.unique of the (needer, vertex) keys, as a scatter into a
    # mask: the same ascending keys without an O(E log E) sort
    key_seen = np.zeros(n_shards * n_pad, dtype=bool)
    key_seen[row_owner[vmask_ok].astype(np.int64) * n_pad + dst[vmask_ok]] = True
    vkeys = np.flatnonzero(key_seen)
    del key_seen
    v_needer = vkeys // n_pad
    v_vertex = vkeys % n_pad
    v_owner = v_vertex // local_n
    v_group = v_needer * n_shards + v_owner
    pair_counts = np.bincount(v_group, minlength=n_shards * n_shards)
    h_max = max(int(pair_counts.max(initial=0)), h_max_floor)

    # ---- granularity decision ------------------------------------------- #
    block_elems = (n_shards - 1) * b_max * block_v
    vertex_elems = (n_shards - 1) * h_max
    full_elems = (n_shards - 1) * bps * block_v
    if granularity == "auto":
        chosen = "vertex" if vertex_elems < block_elems else "block"
    else:
        chosen = granularity
    chosen_elems = vertex_elems if chosen == "vertex" else block_elems
    coverage = chosen_elems / full_elems if full_elems else 0.0
    fallback = coverage >= threshold

    boundary_rows = np.zeros((n_shards, max(b_max, 0)), dtype=np.int32)
    for t, blocks in enumerate(send):
        boundary_rows[t, : len(blocks)] = [b - t * bps for b in blocks]

    blk_dst_halo = None
    send_ids = None
    hub_owner = hub_local = hub_deg = None
    hub_src = hub_slot = hub_w = vmask_nonhub = None
    he_max = 0
    boundary_flag = None
    if fallback:
        # no halo left to shrink: run the plain full gather, hubs off
        n_hubs, hub_pad, hub_ids = 0, 0, np.empty(0, dtype=np.int64)
    else:
        hub_base = local_n + (n_shards * h_max if chosen == "vertex"
                              else n_shards * b_max * block_v)
        if chosen == "vertex":
            # per-(needer, owner) need lists -> the all_to_all send plan and
            # the needer-side buffer positions of every remote vertex
            send_ids = np.zeros((n_shards, n_shards, h_max), dtype=np.int32)
            buf_pos = np.full((n_shards, n_pad), -1, dtype=np.int64)
            for gid in np.unique(v_group):
                s, t = int(gid) // n_shards, int(gid) % n_shards
                ids = v_vertex[v_group == gid]          # ascending
                send_ids[t, s, : ids.size] = (ids - t * local_n).astype(
                    np.int32)
                buf_pos[s, ids] = local_n + t * h_max + np.arange(ids.size)
            # buf_pos[row_owner, dst], one shard's rows at a time
            pos = np.empty_like(dst)
            for s in range(n_shards):
                pos[s * bps:(s + 1) * bps] = buf_pos[s][dst[s * bps:(s + 1) * bps]]
            local_row = dst - row_owner * local_n
            mapped = np.where(dst_owner == row_owner, local_row,
                              np.where(pos >= 0, pos, 0))
            if n_hubs:
                mapped = np.where(real & hub_ref, hub_base + slot_of[dst], mapped)
            mapped = np.where(real, mapped, np.maximum(mapped, 0))
            unresolved = ref_ok & remote & (pos < 0)
        else:
            # position of each boundary block inside the gathered [S,b_max,bv]
            rslot = np.full(nb, -1, dtype=np.int64)
            for t, blocks in enumerate(send):
                for p, b in enumerate(blocks):
                    rslot[b] = t * b_max + p
            off = dst - dst_blk * block_v
            is_local = dst_owner == row_owner
            halo_pos = rslot[dst_blk]
            mapped = np.where(
                is_local,
                (dst_blk - row_owner * bps) * block_v + off,
                np.where(halo_pos >= 0, local_n + halo_pos * block_v + off, 0))
            if n_hubs:
                mapped = np.where(real & hub_ref, hub_base + slot_of[dst], mapped)
            unresolved = ref_ok & ~is_local & (halo_pos < 0)
        if unresolved.any():
            raise AssertionError("halo sets do not cover a real slab reference")
        blk_dst_halo = mapped.astype(np.int32)
        # interior/boundary classification for the async schedule: a block
        # is boundary iff any *real* slab slot resolves past the shard's own
        # slice — into the exchanged tail or the hub region. Derived from
        # the very `mapped` array the rewrite ships, so "interior blocks
        # read only local vertices" holds by construction.
        boundary_flag = np.any(real & (mapped >= local_n), axis=1)

        if n_hubs or hub_pad:
            hub_owner = np.full(hub_pad, -1, dtype=np.int32)
            hub_owner[:n_hubs] = hub_ids // local_n
            hub_local = np.zeros(hub_pad, dtype=np.int32)
            hub_local[:n_hubs] = hub_ids - (hub_ids // local_n) * local_n
            hub_deg = np.zeros(hub_pad, dtype=np.float32)
            hub_deg[:n_hubs] = deg[hub_ids]
            vmask_nonhub = vmask & ~is_hub
            # per-shard vote slabs: every real slab slot whose dst is a hub
            blk_row = np.asarray(blk_row)
            hb, he = np.nonzero(real & hub_ref)
            src_local = ((hb - owner[hb] * bps) * block_v
                         + blk_row[hb, he].astype(np.int64))
            shard_of = owner[hb]
            counts = np.bincount(shard_of, minlength=n_shards)
            he_max = max(int(counts.max(initial=0)), he_max_floor)
            hub_src = np.zeros((n_shards, he_max), dtype=np.int32)
            hub_slot = np.zeros((n_shards, he_max), dtype=np.int32)
            hub_w = np.zeros((n_shards, he_max), dtype=np.float32)
            for s in range(n_shards):
                m = shard_of == s
                c = int(np.count_nonzero(m))
                hub_src[s, :c] = src_local[m]
                hub_slot[s, :c] = slot_of[dst[hb[m], he[m]]]
                hub_w[s, :c] = blk_w[hb[m], he[m]]

    interior_counts: Tuple[int, ...] = ()
    interior_split = 0
    if boundary_flag is not None:
        per_shard = boundary_flag.reshape(n_shards, bps)
        interior_counts = tuple(int(c) for c in (~per_shard).sum(axis=1))
        # first boundary block per shard (bps when a shard has none); the
        # scan length must be SPMD-uniform, so the split is the min
        firsts = np.where(per_shard.any(axis=1),
                          per_shard.argmax(axis=1), bps)
        interior_split = int(firsts.min())

    return HaloSpec(
        n_shards=n_shards,
        blocks_per_shard=bps,
        block_v=block_v,
        b_max=b_max,
        coverage=coverage,
        threshold=threshold,
        fallback=fallback,
        halo_blocks=tuple(halo_blocks),
        boundary_blocks=boundary_blocks,
        boundary_rows=boundary_rows,
        blk_dst_halo=blk_dst_halo,
        granularity=chosen,
        h_max=h_max,
        send_ids=send_ids,
        n_hubs=n_hubs,
        hub_pad=hub_pad if hub_owner is not None else 0,
        hub_ids=tuple(int(h) for h in hub_ids),
        hub_owner=hub_owner,
        hub_local=hub_local,
        hub_deg=hub_deg,
        he_max=he_max,
        hub_src=hub_src,
        hub_slot=hub_slot,
        hub_w=hub_w,
        vmask_nonhub=vmask_nonhub,
        block_is_boundary=(tuple(bool(b) for b in boundary_flag)
                           if boundary_flag is not None else ()),
        interior_counts=interior_counts,
        interior_split=interior_split,
    )


def interior_first_order(spec: HaloSpec) -> Optional[np.ndarray]:
    """Intra-shard stable reorder putting every shard's interior blocks
    first, in the spec's storage block space (or None when it changes
    nothing, including under fallback).

    Which blocks are boundary depends only on the block->shard ownership
    (which vertices are remote) and the hub set, not on the order of blocks
    *within* a shard — so re-sharding the same assignment with this
    permutation composed on top preserves the halo/boundary structure while
    raising ``interior_split`` to ``min(interior_counts)``, the largest
    phase-1 window the assignment admits. The async runner applies it
    before building the layout it actually runs (`core/runner.py`); parity
    legs compare the halo and async schedules on that same layout, so the
    reorder never weakens the staleness_bound=0 bit-identity contract.
    """
    if spec.fallback or not spec.block_is_boundary:
        return None
    flags = np.asarray(spec.block_is_boundary, dtype=bool)
    bps = spec.blocks_per_shard
    order = []
    for s in range(spec.n_shards):
        local = np.arange(s * bps, (s + 1) * bps, dtype=np.int64)
        f = flags[local]
        order.append(np.concatenate([local[~f], local[f]]))
    perm = np.concatenate(order)
    if np.array_equal(perm, np.arange(flags.size)):
        return None
    return perm


__all__ = ["HaloSpec", "HubConfig", "build_halo_spec", "interior_first_order",
           "DEFAULT_HALO_THRESHOLD", "DEFAULT_HUB_MAX_FRAC"]
