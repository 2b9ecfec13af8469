"""Partitioner engine: the superstep schedule, with pluggable local rules.

The port of `repro.core.engine` for ``chunk_schedule="sequential"``: an
algorithm module contributes its **rule** (a config dataclass, a state
NamedTuple, ``init`` / ``init_from_labels`` and either a per-block
``chunk_rule`` or a per-shard ``shard_rule``); this module owns the
**schedule**.

Rule kinds
----------
``kind="chunk"`` (Revolver, restream): a Python loop over the vertex blocks
in which block i's label, lambda and load updates are visible to block i+1
within the same superstep (the paper's asynchrony, DESIGN.md §3). The
drifting per-vertex view is the state's own tensors: each block's new
slices are written into them in place, in stream order, so the next block's
edge phase reads them. Never snapshot the vectors at the start of a
superstep.

``kind="shard"`` (Spinner): the rule processes the whole graph in one BSP
step against the previous superstep's configuration. The sequential
schedule runs it on one shard spanning every block, so the context's
collectives (``gather`` / ``psum``) are identities; the rule returns a load
delta, which the engine adds to the loads.

Replicated fields (restream's degree ranks) pass through every superstep
untouched; rules read them from the context's ``repl``.

The sharded schedules (``cfg.chunk_schedule``) run on a
`ShardedDeviceGraph` over a `BlocksMesh` (one process, a list of devices):

  * ``"sharded"``: the Jacobi superstep. Every shard scans its own blocks
    (asynchronous within the shard) against its own copy of the full
    per-vertex vectors, gathered from the start-of-superstep state; then
    the shards' slices go back into the state, their load deltas are
    merged (exactly, in int64) and the scores summed. Shard 0 draws from
    the state's generator, shard s > 0 from one derived from its state and
    s (`repro_torch.parallel.collectives.shard_chain_key`), so one shard
    repeats the sequential schedule bit for bit.
  * ``"halo"``: the same superstep with the full gather replaced by the
    layout's precomputed exchange (`repro_torch.core.halo`): each shard's
    view is its own slice followed by the exchanged boundary blocks or
    vertices, and its slabs' neighbor ids are rewritten into that buffer.
    It is an exact optimization of ``"sharded"`` (bit-equal results).
  * ``"async"``: the halo superstep with each shard's scan split: its
    interior blocks (which read no exchanged vertex) scan while the exchange
    runs, on a side CUDA stream, and its boundary blocks after it. With a
    fresh exchange every superstep it is bit-equal to ``"halo"``; the
    runner's ``staleness_bound`` lets a shard reuse an older exchanged tail.

A shard rule (Spinner) calls the context's collectives mid-rule: on a mesh
of several shards the engine runs each shard's rule in its own thread, one
at a time in shard order, meeting at every collective (`_Lockstep`), so the
launch order is the same every run.

**Hub replication** (a halo layout whose plan carries hubs, `HubSlabs`):
the hubs' labels are appended to every shard's view after its halo tail
(the async schedule's cached tail carries them too), the hubs are frozen
during the scan (the rules see ``vmask_nonhub``), and once a superstep,
after the load merge, `repro`'s vote reconcile decides their labels: the
shards' int32 vote tables are merged, the current hub labels assembled,
and the capacity-gated walk over the hub slots (H1,
`repro_torch.kernels.hub_reconcile`) runs once, on the mesh's home device
(`repro` runs it on every shard, with the same result), its winners
written into the owners' slices. ``superstep(..., halo=)`` with a 1-shard
plan runs the same machinery on the sequential schedule: `repro`'s hub
oracle, which a 1-shard hub run equals bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core.device_graph import (
    DeviceGraph,
    HubSlabs,
    ShardedDeviceGraph,
    ShardSlabs,
    SpanPlan,
    capacity_device,
    hub_oracle_slabs,
    scalar_device,
)
from repro_torch.core.halo import HaloSpec
from repro_torch.core.metrics import bin_sums
from repro_torch.parallel import collectives


@dataclasses.dataclass(frozen=True, eq=False)
class Algorithm:
    """A partitioning algorithm as the engine sees it.

    Attributes:
      name: registry key ("revolver", "spinner", ...).
      config_cls: frozen config dataclass. The engine reads ``k``,
        ``epsilon``, ``capacity_mode``, ``max_steps``, ``patience``,
        ``theta``; everything else is rule-private.
      state_cls: state NamedTuple. Must carry ``labels`` ([n_pad] int32),
        ``loads`` ([k] f32), ``gen`` (a `torch.Generator`), ``step`` (int)
        and ``score`` (0-dim f32 tensor); may add more.
      kind: "chunk" or "shard" (see module docstring).
      vertex_fields: state fields holding per-vertex [n_pad] tensors the
        rule updates. Must include "labels".
      block_fields: state fields holding per-block [n_blocks, ...] tensors
        (e.g. Revolver's LA probabilities), handed to the rule one block at
        a time; chunk-kind only.
      replicated_fields: state fields the schedule passes through untouched
        (per-run constants, e.g. restream's degree ranks), available to
        rules via the context's ``repl``.
      wire_int8_fields: vertex_fields whose values always lie in [0, k):
        when ``cfg.k <= 127`` the per-vertex halo exchange moves them on an
        int8 wire (an exact round trip, 4x fewer bytes).
      init: ``(dg, cfg, gen) -> state`` cold start.
      init_from_labels: ``(dg, cfg, gen, labels) -> state`` warm start
        (with ``probs=None, prob_sharpen=0.0`` keywords too when
        ``supports_probs``), or None if unsupported.
      supports_probs: whether the algorithm carries an LA probability tensor
        (enables ``keep_probs`` / ``init_probs`` / ``init_sharpen``).
      chunk_rule / shard_rule: the local rule (exactly one, per ``kind``).
    """

    name: str
    config_cls: type
    state_cls: type
    kind: str
    init: Callable
    vertex_fields: Tuple[str, ...] = ("labels",)
    block_fields: Tuple[str, ...] = ()
    replicated_fields: Tuple[str, ...] = ()
    wire_int8_fields: Tuple[str, ...] = ()
    init_from_labels: Optional[Callable] = None
    supports_probs: bool = False
    chunk_rule: Optional[Callable] = None
    shard_rule: Optional[Callable] = None

    def __post_init__(self):
        if self.kind not in ("chunk", "shard"):
            raise ValueError(f"Algorithm.kind={self.kind!r}")
        if "labels" not in self.vertex_fields:
            raise ValueError(f"{self.name}: vertex_fields must include 'labels'")
        if (self.chunk_rule is None) == (self.kind == "chunk"):
            raise ValueError(f"{self.name}: kind={self.kind!r} needs exactly "
                             "the matching rule callable")
        if (self.shard_rule is None) == (self.kind == "shard"):
            raise ValueError(f"{self.name}: kind={self.kind!r} needs exactly "
                             "the matching rule callable")
        required = {"labels", "loads", "gen", "step", "score"}
        missing = required - set(self.state_cls._fields)
        if missing:
            raise ValueError(f"{self.name}: state_cls lacks {sorted(missing)}")
        stray = set(self.wire_int8_fields) - set(self.vertex_fields)
        if stray:
            raise ValueError(f"{self.name}: wire_int8_fields {sorted(stray)} are not "
                             "vertex_fields")


class ChunkContext(NamedTuple):
    """What a chunk rule sees for one vertex block.

    ``v0`` is the block's offset into the drifting per-vertex view the rule
    slices (the full ``[n_pad]`` vectors under the sequential and
    full-gather schedules; the shard's ``local + halo`` buffer under
    ``"halo"`` / ``"async"``, where the slab ids in ``e_dst`` are rewritten
    into buffer space too) and ``gv0`` its global vertex offset, for slicing
    the replicated ``[n_pad]`` tensors in ``repl``. ``blk_idx`` is the
    global block index. ``n_shards`` is the number of shards drifting
    concurrently (1 sequential) and ``loads0`` the start-of-superstep loads;
    `shared_headroom` rations capacity with them.
    ``draws`` is the optional replay hook of `superstep`
    (``(step, blk_idx) -> draws``); None means the rule draws from the
    state's generator.
    """

    blk_idx: int            # block index
    v0: int                 # block offset into the per-vertex tensors
    gv0: int                # global vertex offset of the block
    e_dst: torch.Tensor     # [e_max] int32 neighbor ids (0 pad)
    e_row: torch.Tensor     # [e_max] int32 local row in the block (0 pad)
    e_w: torch.Tensor       # [e_max] f32 eq.(4) weights (0.0 pad)
    row_ptr: torch.Tensor   # [block_v+1] int32 row runs of the slab
    spans: SpanPlan         # the slab's span plan (K1's and K3's work split, nb = 1)
    deg: torch.Tensor       # [block_v] f32 outdegrees
    inv_wsum: torch.Tensor  # [block_v] f32 1/sum w_hat
    vmask: torch.Tensor     # [block_v] bool real-vertex mask
    step: int               # 0-based superstep index
    n_shards: int           # concurrent Jacobi shards (1 sequential)
    loads0: torch.Tensor    # [k] start-of-superstep loads
    repl: Dict[str, torch.Tensor]   # replicated_fields, full [n_pad] each
    draws: Optional[Callable] = None

    def shared_headroom(self, cap: torch.Tensor, loads: torch.Tensor) -> torch.Tensor:
        """Per-partition capacity this block may spend: the shard's
        1/n_shards share of the start-of-superstep headroom plus what the
        shard itself freed since. On the sequential schedule (one shard)
        it is the plain ``cap - loads``."""
        if self.n_shards == 1:
            return cap - loads
        return (cap - self.loads0) / self.n_shards + (self.loads0 - loads)


class ChunkUpdate(NamedTuple):
    """A chunk rule's output: the engine writes ``vert`` slices into the
    per-vertex tensors (visible to later blocks) and ``block`` tensors into
    the block's slot, and threads loads and score."""

    vert: Dict[str, torch.Tensor]    # vertex_field -> [block_v] new values
    block: Dict[str, torch.Tensor]   # block_field -> updated block tensor
    loads: torch.Tensor              # [k] updated drifting load view
    score: torch.Tensor              # 0-dim score sum over the block


@dataclasses.dataclass(frozen=True)
class ShardContext:
    """What a shard rule sees: its slice of the blocked layout plus
    collectives. The sequential schedule runs one shard spanning the whole
    graph (``v0 = 0``, ``local_n = n_pad``), where ``gather`` and ``psum``
    are identities. Under ``"halo"`` the slab ids in ``blk_dst`` are
    rewritten into the shard's ``local + halo`` buffer space and ``gather``
    returns that buffer, so rules that index the gather result through
    ``blk_dst`` run unchanged under every schedule. ``draws`` is the
    optional replay hook of `superstep` (``step -> draws``)."""

    n_pad: int              # global padded vertex count
    local_n: int            # vertices owned by this shard
    block_v: int
    blocks: int             # blocks owned by this shard
    v0: int                 # global offset of the local range
    blk_dst: torch.Tensor   # [blocks, e_max] int32 edge slabs
    blk_row: torch.Tensor   # [blocks, e_max] int32
    blk_w: torch.Tensor     # [blocks, e_max] f32
    blk_row_ptr: torch.Tensor  # [blocks, block_v+1] int32 row runs
    blk_spans: SpanPlan     # the slabs' span plan (the span kernels' work split)
    deg: torch.Tensor       # [local_n] f32
    inv_wsum: torch.Tensor  # [local_n] f32
    vmask: torch.Tensor     # [local_n] bool
    step: int
    repl: Dict[str, torch.Tensor]
    draws: Optional[Callable] = None
    idx: int = 0            # shard index (0 sequential)
    comm: Optional[Any] = None   # the superstep's `_ShardComm` (None sequential)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Make every vertex id in ``blk_dst`` resolvable: the full
        all-gather, or the shard's slice followed by the layout's halo tail
        (identity on the sequential schedule). Rules gather label-valued
        fields only, so the per-vertex exchange moves them on the int8 wire
        when k <= 127."""
        if self.comm is None:
            return x
        with obs.annotate("halo-exchange", kind=self.comm.kind):
            return self.comm.gather(self.idx, x)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum a shard-local reduction across shards (identity sequential)."""
        if self.comm is None:
            return x
        return self.comm.psum(self.idx, x)

    def local_rows(self) -> torch.Tensor:
        """[blocks * e_max] shard-local row ids for a flat slab histogram."""
        base = torch.arange(self.blocks, dtype=torch.int32,
                            device=self.blk_row.device)[:, None] * self.block_v
        return (base + self.blk_row).reshape(-1)


class ShardUpdate(NamedTuple):
    vert: Dict[str, torch.Tensor]    # vertex_field -> [local_n] new values
    loads_delta: torch.Tensor        # [k] this shard's load delta
    score: torch.Tensor              # 0-dim score sum over the shard


def score_sum(best: torch.Tensor, vmask: torch.Tensor) -> torch.Tensor:
    """0-dim f32 sum of ``best`` over real vertices, accumulated in f64.

    The f32 result then does not depend on the reduction order, so the
    card's score equals the CPU's bit for bit: Revolver's best scores lie in
    [1/(2k), 1], where the f64 sum of up to 2^24 of them is exact; for
    scores of any sign (Spinner, restream) two orders round to different
    f32 values only when the sum lies within ~2^-29 of a rounding boundary.
    """
    return torch.sum(torch.where(vmask, best, 0.0), dtype=torch.float64).to(torch.float32)


class _HubComm:
    """The sequential hub schedule's collectives: one shard, whose gather
    appends the hub region (`repro`'s ``hub_gather`` with ``axis=None``)."""

    kind = "hub-assemble"

    def __init__(self, hub: HubSlabs):
        self.hub = hub

    def gather(self, idx: int, x: torch.Tensor) -> torch.Tensor:
        region = collectives.hub_gather([x], self.hub.owner, self.hub.local, None)[0]
        return torch.cat([x, region])

    def psum(self, idx: int, x: torch.Tensor) -> torch.Tensor:
        return x


def _chunk_superstep(algo: Algorithm, dg: DeviceGraph, cfg, state, cap, draws,
                     oracle: Optional[ShardSlabs] = None):
    """The sequential block loop; returns (loads, score sum). With ``oracle``
    (the sequential hub schedule) the blocks read the ``[n_pad | hub]``
    buffer through its rewritten slabs, with the hubs frozen."""
    bv = dg.block_v
    if oracle is None:
        vert = {f: getattr(state, f) for f in algo.vertex_fields}
        dst, vmask = dg.blk_dst, dg.vmask
    else:
        comm = _HubComm(oracle.hub)
        vert = {f: comm.gather(0, getattr(state, f)) for f in algo.vertex_fields}
        dst, vmask = oracle.blk_dst_halo, oracle.hub.vmask_nonhub
    blocks = {f: getattr(state, f) for f in algo.block_fields}
    repl = {f: getattr(state, f) for f in algo.replicated_fields}
    loads = state.loads     # rules return new load tensors
    score = torch.zeros((), dtype=torch.float32, device=dg.device)
    for b in range(dg.n_blocks):
        v0 = b * bv
        ctx = ChunkContext(
            blk_idx=b, v0=v0, gv0=v0, e_dst=dst[b], e_row=dg.blk_row[b],
            e_w=dg.blk_w[b], row_ptr=dg.blk_row_ptr[b], spans=dg.blk_spans.block(b),
            deg=dg.deg_out[v0:v0 + bv], inv_wsum=dg.inv_wsum[v0:v0 + bv],
            vmask=vmask[v0:v0 + bv], step=state.step, n_shards=1,
            loads0=state.loads, repl=repl, draws=draws)
        upd = algo.chunk_rule(cfg, ctx, vert, {f: t[b] for f, t in blocks.items()},
                              loads, cap, state.gen)
        for f, new in upd.vert.items():
            vert[f][v0:v0 + bv] = new
        for f, new in upd.block.items():
            blocks[f][b] = new
        loads = upd.loads
        score = score + upd.score
    if oracle is not None:
        for f, v in vert.items():
            getattr(state, f).copy_(v[:dg.n_pad])
    return loads, score


def _shard_superstep(algo: Algorithm, dg: DeviceGraph, cfg, state, cap, draws,
                     oracle: Optional[ShardSlabs] = None):
    """The shard rule once over every slab; returns (loads, score sum).
    With ``oracle`` the rule gathers the ``[n_pad | hub]`` buffer through the
    rewritten slabs, with the hubs frozen."""
    ctx = ShardContext(
        n_pad=dg.n_pad, local_n=dg.n_pad, block_v=dg.block_v,
        blocks=dg.n_blocks, v0=0, blk_dst=dg.blk_dst if oracle is None else oracle.blk_dst_halo,
        blk_row=dg.blk_row, blk_w=dg.blk_w, blk_row_ptr=dg.blk_row_ptr,
        blk_spans=dg.blk_spans, deg=dg.deg_out, inv_wsum=dg.inv_wsum,
        vmask=dg.vmask if oracle is None else oracle.hub.vmask_nonhub, step=state.step,
        repl={f: getattr(state, f) for f in algo.replicated_fields},
        draws=draws, comm=None if oracle is None else _HubComm(oracle.hub))
    local = {f: getattr(state, f) for f in algo.vertex_fields}
    upd = algo.shard_rule(cfg, ctx, local, state.loads, cap, state.gen)
    for f, new in upd.vert.items():
        local[f].copy_(new)
    return state.loads + upd.loads_delta, upd.score


_BODIES = {"chunk": _chunk_superstep, "shard": _shard_superstep}


def _hub_reconcile(hubs: List[HubSlabs], parts: List[torch.Tensor], mesh, cfg, m: int,
                   loads: torch.Tensor, labels: torch.Tensor) -> None:
    """`repro`'s ``_hub_reconcile``, once, on the device of ``hubs[0]`` (the
    home device): the shards' vote tables from their post-scan label slices
    ``parts``, merged; the current hub labels assembled from the same
    slices; H1's capacity-gated walk over the slots, which updates
    ``loads`` in place; the winners written into ``labels`` (storage order,
    whole, on the home device)."""
    from repro_torch.kernels import ops

    h = hubs[0]
    dev = h.owner.device
    with obs.annotate("halo-exchange", kind="hub-votes"):
        cur = collectives.hub_gather(parts, h.owner, h.local, mesh)[0]
        votes = collectives.hub_votes(parts, [x.src for x in hubs], [x.slot for x in hubs],
                                      [x.w for x in hubs], h.hub_pad, cfg.k, dev)
    cap = capacity_device(m, cfg.k, cfg.epsilon, cfg.capacity_mode, dev)
    with obs.annotate("hub-reconcile", kernel="hub_reconcile", slots=h.hub_pad):
        winners = ops.hub_reconcile(votes, cur, h.deg, h.owner, loads, cap)
    labels.index_copy_(0, h.ids, winners[:h.ids.shape[0]])


# ---------------------------------------------------------------------------
# the sharded schedules: "sharded", "halo", "async"
# ---------------------------------------------------------------------------
def _to(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return x if x.device == dev else x.to(dev, non_blocking=True)


def _vertex_slices(sdg: ShardedDeviceGraph, t: torch.Tensor) -> List[torch.Tensor]:
    """Shard s's slice of a storage-order per-vertex tensor, on its device
    (a view on the home device)."""
    ln = sdg.local_n
    return [_to(t[s * ln:(s + 1) * ln], sh.device) for s, sh in enumerate(sdg.shards)]


def _exchange_kind(sdg: ShardedDeviceGraph, halo: bool) -> str:
    if not halo:
        return "full-gather"
    return "per-vertex" if sdg.halo.granularity == "vertex" else "halo"


def _halo_tails(sdg: ShardedDeviceGraph, xs: List[torch.Tensor],
                wire: Optional[torch.dtype]) -> List[torch.Tensor]:
    """One field's exchanged tail per shard, by the layout's plan, followed
    by the hub region when the plan replicates hubs (at storage width)."""
    spec = sdg.halo
    if spec.granularity == "vertex":
        tails = collectives.vertex_halo_exchange(
            xs, [sh.send_ids for sh in sdg.shards], sdg.mesh, wire_dtype=wire)
    elif spec.b_max == 0:                # no cross-shard reference at all
        tails = [x.new_zeros((0,)) for x in xs]
    else:
        tails = collectives.halo_exchange(xs, [sh.halo_rows for sh in sdg.shards], sdg.mesh,
                                          sdg.blocks_per_shard, sdg.block_v)
    if sdg.hubs_on:
        hub = sdg.shards[0].hub
        region = collectives.hub_gather(xs, hub.owner, hub.local, sdg.mesh)
        tails = [torch.cat([t, r]) for t, r in zip(tails, region)]
    return tails


def _wire(algo: Algorithm, cfg, field: str) -> Optional[torch.dtype]:
    return torch.int8 if cfg.k <= 127 and field in algo.wire_int8_fields else None


def _exchange(algo: Algorithm, sdg: ShardedDeviceGraph, cfg, xs: Dict[str, List[torch.Tensor]]):
    """Every vertex field's halo tail per shard, from the start-of-superstep
    slices ``xs``."""
    return {f: _halo_tails(sdg, parts, _wire(algo, cfg, f)) for f, parts in xs.items()}


_SIDE_STREAMS: Dict[torch.device, Any] = {}


def _exchange_on_side_stream(algo: Algorithm, sdg: ShardedDeviceGraph, cfg, xs):
    """`_exchange` issued on a side stream of the home card (on the CPU,
    in line). Returns ``(tails, event)``: the boundary scan waits on the
    event. The side stream first waits for the state's last writes; the
    state is written again only after the boundary scan, which waits on the
    event, so the exchange's sources stay as read. Tails are marked as used
    on the main stream, so their memory is not reused while it reads them."""
    home = sdg.mesh.home
    if home.type != "cuda":
        return _exchange(algo, sdg, cfg, xs), None
    main = torch.cuda.current_stream(home)
    side = _SIDE_STREAMS.get(home)
    if side is None:
        side = _SIDE_STREAMS[home] = torch.cuda.Stream(device=home)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        tails = _exchange(algo, sdg, cfg, xs)
    event = torch.cuda.Event()
    event.record(side)
    for parts in tails.values():
        for t in parts:
            if t.device == home:
                t.record_stream(main)
    return tails, event


class _ShardScan:
    """One shard's superstep state under a chunk schedule: its drifting
    view (``vert``), its block tiles (``blocks``: views of the state on the
    home device, else copies), loads, score and generator. With hubs on the
    scan reads the hub-frozen vertex mask."""

    def __init__(self, algo, sdg, cfg, state, s, gen, draws, halo):
        sh = sdg.shards[s]
        self.s, self.sh, self.dev = s, sh, sh.device
        self.vmask = sh.hub.vmask_nonhub if halo and sh.hub is not None else sh.vmask
        bps = sdg.blocks_per_shard
        self.blocks = {f: _to(getattr(state, f)[s * bps:(s + 1) * bps], self.dev)
                       for f in algo.block_fields}
        self.loads0 = _to(state.loads, self.dev)
        self.loads = self.loads0
        self.score = torch.zeros((), dtype=torch.float32, device=self.dev)
        self.cap = capacity_device(sdg.m, cfg.k, cfg.epsilon, cfg.capacity_mode, self.dev)
        self.repl = {f: _to(getattr(state, f), self.dev) for f in algo.replicated_fields}
        self.gen, self.draws, self.halo = gen, draws, halo
        self.vert: Dict[str, torch.Tensor] = {}

    def scan(self, algo, sdg, cfg, step, blocks):
        """Run the chunk rule over local blocks ``blocks`` in order."""
        sh, bv = self.sh, sdg.block_v
        dst = sh.blk_dst_halo if self.halo else sh.blk_dst
        for i in blocks:
            b = self.s * sdg.blocks_per_shard + i
            v0 = i * bv if self.halo else b * bv
            lv = slice(i * bv, (i + 1) * bv)
            ctx = ChunkContext(
                blk_idx=b, v0=v0, gv0=b * bv, e_dst=dst[i], e_row=sh.blk_row[i],
                e_w=sh.blk_w[i], row_ptr=sh.blk_row_ptr[i], spans=sh.blk_spans.block(i),
                deg=sh.deg[lv], inv_wsum=sh.inv_wsum[lv], vmask=self.vmask[lv], step=step,
                n_shards=sdg.n_shards, loads0=self.loads0, repl=self.repl, draws=self.draws)
            upd = algo.chunk_rule(cfg, ctx, self.vert,
                                  {f: t[i] for f, t in self.blocks.items()},
                                  self.loads, self.cap, self.gen)
            for f, new in upd.vert.items():
                self.vert[f][v0:v0 + bv] = new
            for f, new in upd.block.items():
                self.blocks[f][i] = new
            self.loads = upd.loads
            self.score = self.score + upd.score

    def own(self, sdg, f: str) -> torch.Tensor:
        """The shard's own slice of its drifting view of field ``f``."""
        ln = sdg.local_n
        return self.vert[f][:ln] if self.halo else self.vert[f][self.s * ln:(self.s + 1) * ln]


def _merge(algo, sdg, state, runs, fields, block_fields):
    """Write every shard's slices back into the state; return the merged
    loads (exact int64 delta merge) and the summed score."""
    ln, bps = sdg.local_n, sdg.blocks_per_shard
    for r in runs:
        for f in fields:
            getattr(state, f)[r.s * ln:(r.s + 1) * ln].copy_(r.own(sdg, f))
        for f in block_fields:
            dst = getattr(state, f)[r.s * bps:(r.s + 1) * bps]
            if dst.device != r.dev:
                dst.copy_(r.blocks[f])
    loads = collectives.psum_delta_merge(
        state.loads, [r.loads - r.loads0 for r in runs], sdg.mesh)
    home = state.loads.device
    score = torch.stack([_to(r.score, home).to(torch.float64) for r in runs]).sum()
    return loads, score.to(torch.float32)


def _sharded_chunk_superstep(algo: Algorithm, sdg: ShardedDeviceGraph, cfg, state, draws, *,
                             halo: bool, split: Optional[int] = None, cache=None):
    """The chunk rule's Jacobi superstep over the mesh; returns (loads,
    score, the exchanged tails read). ``split`` runs the async form: each
    shard's first ``split`` blocks scan against its own slice while the
    exchange runs (or ``cache``, an earlier superstep's tails, is reused),
    the rest against its ``local + tail`` buffer. A halo plan with hubs
    reconciles them after the load merge."""
    fields = algo.vertex_fields
    hubs = halo and sdg.hubs_on
    gens = collectives.shard_chain_key(state.gen, sdg.mesh)
    xs = {f: _vertex_slices(sdg, getattr(state, f)) for f in fields}
    runs = [_ShardScan(algo, sdg, cfg, state, s, gens[s], draws, halo)
            for s in range(sdg.n_shards)]
    kind = _exchange_kind(sdg, halo)
    bps = sdg.blocks_per_shard
    tails = None
    if split is None:
        with obs.annotate("halo-exchange", kind=kind, hubs=int(hubs), fields=len(fields)):
            if halo:
                tails = _exchange(algo, sdg, cfg, xs)
                for r in runs:
                    r.vert = {f: torch.cat([xs[f][r.s], tails[f][r.s]]) for f in fields}
            else:
                gathered = {f: collectives.gather_shards(xs[f], sdg.mesh) for f in fields}
                for r in runs:
                    r.vert = {f: gathered[f][r.s] for f in fields}
        for r in runs:
            r.scan(algo, sdg, cfg, state.step, range(bps))
    else:
        refresh = cache is None
        event = None
        # phase 1: interior blocks drift on the shard's own slice while the
        # exchange is in flight (the nested spans are the overlap contract
        # `tools/trace_report.py --validate` checks)
        with obs.annotate("interior-scan", schedule="async", blocks=split, refresh=int(refresh)):
            if refresh:
                with obs.annotate("halo-exchange", kind=kind, hubs=int(hubs), fields=len(fields),
                                  overlap=1):
                    tails, event = _exchange_on_side_stream(algo, sdg, cfg, xs)
            else:
                tails = cache
            for r in runs:
                r.vert = {f: xs[f][r.s].clone() for f in fields}
                r.scan(algo, sdg, cfg, state.step, range(split))
        # phase 2: boundary blocks see the exchanged (or cached) tail
        if event is not None:
            torch.cuda.current_stream(sdg.mesh.home).wait_event(event)
        for r in runs:
            r.vert = {f: torch.cat([r.vert[f], tails[f][r.s]]) for f in fields}
            r.scan(algo, sdg, cfg, state.step, range(split, bps))
    loads, score = _merge(algo, sdg, state, runs, fields, algo.block_fields)
    if hubs:
        _hub_reconcile([sh.hub for sh in sdg.shards], _vertex_slices(sdg, state.labels),
                       sdg.mesh, cfg, sdg.m, loads, state.labels)
    return loads, score, tails


class _Lockstep:
    """Run one callable per shard, each in its own thread but one at a time
    in shard order, meeting at every collective: shard s runs until its
    next collective and hands over to s + 1; the last shard combines what
    all deposited and hands back to shard 0. The launch order is therefore
    fixed, as if the shards ran phase by phase in one thread. A failure in
    any shard stops them all and is raised by `run`."""

    class _Aborted(Exception):
        pass

    def __init__(self, n: int):
        self.n = n
        self.cv = threading.Condition()
        self.turn = 0
        self.slots: List[Any] = [None] * n
        self.results: List[Any] = []
        self.failed = False

    def _await(self, s: int) -> None:
        self.cv.wait_for(lambda: self.turn == s or self.failed)
        if self.failed:
            raise self._Aborted()

    def collective(self, s: int, x, combine: Callable):
        with self.cv:
            self.slots[s] = x
            if s == self.n - 1:
                try:
                    self.results = combine(list(self.slots))
                finally:
                    self.slots = [None] * self.n
                self.turn = 0
            else:
                self.turn = s + 1
            self.cv.notify_all()
            self._await(s)
            return self.results[s]

    def run(self, fns: List[Callable], devices) -> List[Any]:
        if self.n == 1:
            return [fns[0]()]
        out: List[Any] = [None] * self.n
        errors: List[BaseException] = []

        def worker(s):
            try:
                with self.cv:
                    self._await(s)
                ctx = (torch.cuda.device(devices[s]) if devices[s].type == "cuda"
                       else contextlib.nullcontext())
                with ctx:
                    out[s] = fns[s]()
                with self.cv:
                    self.turn = s + 1
                    self.cv.notify_all()
            except self._Aborted:
                pass
            except BaseException as e:   # re-raised below, in the caller's thread
                with self.cv:
                    errors.append(e)
                    self.failed = True
                    self.cv.notify_all()

        threads = [threading.Thread(target=worker, args=(s,), daemon=True)
                   for s in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


class _ShardComm:
    """The collectives of one superstep of a shard rule over the mesh."""

    def __init__(self, algo: Algorithm, sdg: ShardedDeviceGraph, cfg, halo: bool):
        self.sdg, self.halo = sdg, halo
        self.kind = _exchange_kind(sdg, halo)
        self.wire = torch.int8 if algo.wire_int8_fields and cfg.k <= 127 else None
        self.lockstep = _Lockstep(sdg.n_shards)

    def _gather_all(self, xs):
        if not self.halo:
            return collectives.gather_shards(xs, self.sdg.mesh)
        wire = self.wire if xs[0].dtype == torch.int32 else None
        tails = _halo_tails(self.sdg, xs, wire)
        return [torch.cat([x, t]) for x, t in zip(xs, tails)]

    def gather(self, idx: int, x: torch.Tensor) -> torch.Tensor:
        return self.lockstep.collective(idx, x, self._gather_all)

    def psum(self, idx: int, x: torch.Tensor) -> torch.Tensor:
        return self.lockstep.collective(idx, x, lambda xs: collectives.psum(xs, self.sdg.mesh))


def _sharded_shard_superstep(algo: Algorithm, sdg: ShardedDeviceGraph, cfg, state, draws, *,
                             halo: bool):
    """The shard rule once per shard, in lockstep; returns (loads, score).
    Every shard draws what the state's generator draws (`repro`'s shard
    rule splits one replicated key). A halo plan with hubs runs the rule
    with the hubs frozen and reconciles them after the load merge."""
    fields = algo.vertex_fields
    hubs = halo and sdg.hubs_on
    gens = collectives.replicated_key(state.gen, sdg.mesh)
    xs = {f: _vertex_slices(sdg, getattr(state, f)) for f in fields}
    comm = _ShardComm(algo, sdg, cfg, halo)
    ln, bps = sdg.local_n, sdg.blocks_per_shard

    def run(s):
        sh = sdg.shards[s]
        dev = sh.device
        ctx = ShardContext(
            n_pad=sdg.n_pad, local_n=ln, block_v=sdg.block_v, blocks=bps, v0=s * ln,
            blk_dst=sh.blk_dst_halo if halo else sh.blk_dst, blk_row=sh.blk_row,
            blk_w=sh.blk_w, blk_row_ptr=sh.blk_row_ptr, blk_spans=sh.blk_spans, deg=sh.deg,
            inv_wsum=sh.inv_wsum, vmask=sh.hub.vmask_nonhub if hubs else sh.vmask,
            step=state.step,
            repl={f: _to(getattr(state, f), dev) for f in algo.replicated_fields},
            draws=draws, idx=s, comm=comm)
        cap = capacity_device(sdg.m, cfg.k, cfg.epsilon, cfg.capacity_mode, dev)
        return algo.shard_rule(cfg, ctx, {f: xs[f][s] for f in fields},
                               _to(state.loads, dev), cap, gens[s])

    upds = comm.lockstep.run([lambda s=s: run(s) for s in range(sdg.n_shards)],
                             sdg.mesh.devices)
    for s, upd in enumerate(upds):
        for f, new in upd.vert.items():
            getattr(state, f)[s * ln:(s + 1) * ln].copy_(new)
    loads = collectives.psum_delta_merge(state.loads, [u.loads_delta for u in upds], sdg.mesh)
    if hubs:
        _hub_reconcile([sh.hub for sh in sdg.shards], _vertex_slices(sdg, state.labels),
                       sdg.mesh, cfg, sdg.m, loads, state.labels)
    home = state.loads.device
    score = torch.stack([_to(u.score, home).to(torch.float64) for u in upds]).sum()
    return loads, score.to(torch.float32)


def _check_sharded(dg, schedule: str) -> ShardedDeviceGraph:
    if not isinstance(dg, ShardedDeviceGraph):
        raise TypeError(
            f"chunk_schedule={schedule!r} needs a ShardedDeviceGraph (see "
            "prepare_sharded_device_graph); got a plain DeviceGraph")
    if schedule in ("halo", "async") and dg.halo is None:
        raise ValueError(
            f"chunk_schedule={schedule!r} needs a halo-enabled layout: build it with "
            "shard_device_graph(..., halo=True) / attach_halo, or let run_partitioner "
            "build it")
    return dg


def _finish(sdg, state, loads, score):
    state.loads.copy_(loads)
    return state._replace(step=state.step + 1,
                          score=score / scalar_device(sdg.n, state.loads.device))


def superstep(algo: Algorithm, dg, cfg, state, *, draws=None, halo=None):
    """One full superstep of ``algo`` under ``cfg.chunk_schedule``.

    "sequential" (the default, and the only schedule of a config without a
    ``chunk_schedule``) runs on one device (a `ShardedDeviceGraph`'s whole
    layout is used as it is); "sharded", "halo" and "async" run over the
    `ShardedDeviceGraph`'s mesh (module docstring). A halo plan whose
    coverage passed its threshold (``fallback``) runs the full gather,
    bit-identically, with hubs off. "async" here always refreshes its
    exchange, the ``staleness_bound=0`` semantics; `async_superstep` takes
    a cache.

    ``halo`` gives the *sequential* schedule a 1-shard hub plan — a
    `HaloSpec` with ``n_shards == 1``, or its upload `hub_oracle_slabs`
    (what the runner passes, uploaded once): `repro`'s hub oracle, the same
    rewritten slabs, frozen hubs and vote reconcile as a 1-shard hub run. A
    plan without hubs changes nothing.

    Updates the state's vertex fields, block fields and ``loads`` **in
    place** (where `repro` donates those buffers) and returns the state with
    the next ``step`` and this superstep's ``score`` (the score sum over the
    real vertex count, divided on the device: see `scalar_device`). The
    generator is advanced in place; replicated fields pass through.
    ``draws`` replays external random draws (tests only; see the rule
    modules: chunk rules take ``(step, global block index)``).
    """
    schedule = getattr(cfg, "chunk_schedule", "sequential")
    if schedule == "async":
        return async_superstep(algo, dg, cfg, state, draws=draws)[0]
    if schedule in ("sharded", "halo"):
        sdg = _check_sharded(dg, schedule)
        halo = schedule == "halo" and not sdg.halo.fallback
        if algo.kind == "chunk":
            loads, score, _ = _sharded_chunk_superstep(algo, sdg, cfg, state, draws, halo=halo)
        else:
            loads, score = _sharded_shard_superstep(algo, sdg, cfg, state, draws, halo=halo)
        return _finish(sdg, state, loads, score)
    if isinstance(dg, ShardedDeviceGraph):
        dg = dg.dg
    oracle = hub_oracle_slabs(dg, halo) if isinstance(halo, HaloSpec) else halo
    cap = capacity_device(dg.m, cfg.k, cfg.epsilon, cfg.capacity_mode, dg.device)
    loads, score = _BODIES[algo.kind](algo, dg, cfg, state, cap, draws, oracle)
    if oracle is not None:
        _hub_reconcile([oracle.hub], [state.labels], None, cfg, dg.m, loads, state.labels)
    state.loads.copy_(loads)
    return state._replace(step=state.step + 1,
                          score=score / scalar_device(dg.n, dg.device))


def async_superstep(algo: Algorithm, dg, cfg, state, cache=None, *, draws=None):
    """One ``chunk_schedule="async"`` superstep; returns ``(state, cache)``.

    The halo superstep with each shard's scan split at the layout's
    ``halo.interior_split``: the interior blocks scan while the exchange
    runs on a side stream, the boundary blocks after it, against the same
    start-of-superstep tail — bit-identical to ``"halo"`` on the same
    layout. ``cache=None`` refreshes the tail; passing the cache an earlier
    call returned reuses that tail (the runner's ``staleness_bound`` policy
    decides when). Under a fallback plan the full-gather superstep runs and
    the cache is None. The state is updated in place, as by `superstep`.
    """
    if algo.kind != "chunk":
        raise ValueError(
            f"chunk_schedule='async' overlaps the interior *block scan* with the halo "
            f"exchange; {algo.name} is kind={algo.kind!r} and has no block scan (use "
            "'sharded' or 'halo')")
    sdg = _check_sharded(dg, "async")
    if sdg.halo.fallback:
        loads, score, _ = _sharded_chunk_superstep(algo, sdg, cfg, state, draws, halo=False)
        return _finish(sdg, state, loads, score), None
    loads, score, tails = _sharded_chunk_superstep(
        algo, sdg, cfg, state, draws, halo=True, split=sdg.halo.interior_split, cache=cache)
    return _finish(sdg, state, loads, score), tails


def place_state(algo: Algorithm, state, sdg: ShardedDeviceGraph):
    """Commit a state to a sharded layout: every tensor field on the mesh's
    home device, the vertex and block fields whole, in storage order — each
    shard's slices are views of them there (copies for a shard on another
    device, taken and written back every superstep)."""
    home = sdg.mesh.home
    return state._replace(**{
        name: value.to(home) for name, value in state._asdict().items()
        if isinstance(value, torch.Tensor)})


def warm_labels(dg: DeviceGraph, k: int, gen: torch.Generator, labels) -> torch.Tensor:
    """Carried labels for surviving vertices, random draws for new ones.

    ``labels`` covers up to ``len(labels)`` surviving vertices **in original
    vertex order** (clipped to [0, k)); vertices beyond it draw a random
    label exactly like a cold init would. On a block-permuted sharded
    layout the carried slice is scattered to each vertex's storage position
    (``dg.o2s_t``).
    """
    lab = torch.randint(0, k, (dg.n_pad,), generator=gen, dtype=torch.int32,
                        device=dg.device)
    carried = torch.clamp(torch.as_tensor(labels).to(dg.device, torch.int32), 0, k - 1)
    m_keep = min(int(carried.shape[0]), dg.n_pad)
    o2s = getattr(dg, "o2s_t", None)
    if o2s is None:
        lab[:m_keep] = carried[:m_keep]
    else:
        lab[o2s[:m_keep]] = carried[:m_keep]
    return torch.where(dg.vmask, lab, 0)


def loads_from_labels(dg: DeviceGraph, k: int, labels: torch.Tensor) -> torch.Tensor:
    """Recompute b(l) from the degree vector so the invariant
    b(l) == sum deg over labels==l holds from step 0 (summed in int64, see
    `bin_sums`)."""
    return bin_sums(labels, dg.deg_out, k)
