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

What waits for later slices: the sharded, halo and async schedules and hub
replication (ROADMAP queue 1 item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.device_graph import DeviceGraph, SpanPlan, capacity_device, scalar_device
from repro_torch.core.metrics import bin_sums


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


class ChunkContext(NamedTuple):
    """What a chunk rule sees for one vertex block.

    ``v0`` is the block's offset into the per-vertex tensors and ``gv0`` its
    global vertex offset, for slicing the replicated ``[n_pad]`` tensors in
    ``repl`` (the two coincide on the sequential schedule). ``n_shards`` is
    the number of shards drifting concurrently (1 here) and ``loads0`` the
    start-of-superstep loads; `shared_headroom` rations capacity with them.
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
    are identities. ``draws`` is the optional replay hook of `superstep`
    (``step -> draws``)."""

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

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Make every vertex id in ``blk_dst`` resolvable (identity on the
        sequential schedule)."""
        return x

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum a shard-local reduction across shards (identity here)."""
        return x

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


def _chunk_superstep(algo: Algorithm, dg: DeviceGraph, cfg, state, cap, draws):
    """The sequential block loop; returns (loads, score sum)."""
    bv = dg.block_v
    vert = {f: getattr(state, f) for f in algo.vertex_fields}
    blocks = {f: getattr(state, f) for f in algo.block_fields}
    repl = {f: getattr(state, f) for f in algo.replicated_fields}
    loads = state.loads     # rules return new load tensors
    score = torch.zeros((), dtype=torch.float32, device=dg.device)
    for b in range(dg.n_blocks):
        v0 = b * bv
        ctx = ChunkContext(
            blk_idx=b, v0=v0, gv0=v0, e_dst=dg.blk_dst[b], e_row=dg.blk_row[b],
            e_w=dg.blk_w[b], row_ptr=dg.blk_row_ptr[b], spans=dg.blk_spans.block(b),
            deg=dg.deg_out[v0:v0 + bv], inv_wsum=dg.inv_wsum[v0:v0 + bv],
            vmask=dg.vmask[v0:v0 + bv], step=state.step, n_shards=1,
            loads0=state.loads, repl=repl, draws=draws)
        upd = algo.chunk_rule(cfg, ctx, vert, {f: t[b] for f, t in blocks.items()},
                              loads, cap, state.gen)
        for f, new in upd.vert.items():
            vert[f][v0:v0 + bv] = new
        for f, new in upd.block.items():
            blocks[f][b] = new
        loads = upd.loads
        score = score + upd.score
    return loads, score


def _shard_superstep(algo: Algorithm, dg: DeviceGraph, cfg, state, cap, draws):
    """The shard rule once over every slab; returns (loads, score sum)."""
    ctx = ShardContext(
        n_pad=dg.n_pad, local_n=dg.n_pad, block_v=dg.block_v,
        blocks=dg.n_blocks, v0=0, blk_dst=dg.blk_dst, blk_row=dg.blk_row,
        blk_w=dg.blk_w, blk_row_ptr=dg.blk_row_ptr, blk_spans=dg.blk_spans,
        deg=dg.deg_out, inv_wsum=dg.inv_wsum, vmask=dg.vmask, step=state.step,
        repl={f: getattr(state, f) for f in algo.replicated_fields},
        draws=draws)
    local = {f: getattr(state, f) for f in algo.vertex_fields}
    upd = algo.shard_rule(cfg, ctx, local, state.loads, cap, state.gen)
    for f, new in upd.vert.items():
        local[f].copy_(new)
    return state.loads + upd.loads_delta, upd.score


_BODIES = {"chunk": _chunk_superstep, "shard": _shard_superstep}


def superstep(algo: Algorithm, dg: DeviceGraph, cfg, state, *, draws=None):
    """One full superstep of ``algo`` under the sequential schedule.

    Updates the state's vertex fields, block fields and ``loads`` **in
    place** (where `repro` donates those buffers) and returns the state with
    the next ``step`` and this superstep's ``score`` (the score sum over the
    real vertex count, divided on the device: see `scalar_device`). The
    generator is advanced in place; replicated fields pass through.
    ``draws`` replays external random draws (tests only; see the rule
    modules).
    """
    cap = capacity_device(dg.m, cfg.k, cfg.epsilon, cfg.capacity_mode, dg.device)
    loads, score = _BODIES[algo.kind](algo, dg, cfg, state, cap, draws)
    state.loads.copy_(loads)
    return state._replace(step=state.step + 1,
                          score=score / scalar_device(dg.n, dg.device))


def warm_labels(dg: DeviceGraph, k: int, gen: torch.Generator, labels) -> torch.Tensor:
    """Carried labels for surviving vertices, random draws for new ones.

    ``labels`` covers up to ``len(labels)`` surviving vertices (clipped to
    [0, k)); vertices beyond it draw a random label exactly like a cold init
    would.
    """
    lab = torch.randint(0, k, (dg.n_pad,), generator=gen, dtype=torch.int32,
                        device=dg.device)
    carried = torch.clamp(torch.as_tensor(labels).to(dg.device, torch.int32), 0, k - 1)
    m_keep = min(int(carried.shape[0]), dg.n_pad)
    lab[:m_keep] = carried[:m_keep]
    return torch.where(dg.vmask, lab, 0)


def loads_from_labels(dg: DeviceGraph, k: int, labels: torch.Tensor) -> torch.Tensor:
    """Recompute b(l) from the degree vector so the invariant
    b(l) == sum deg over labels==l holds from step 0 (summed in int64, see
    `bin_sums`)."""
    return bin_sums(labels, dg.deg_out, k)
