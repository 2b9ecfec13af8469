"""Partitioner engine: the superstep schedule, with pluggable local rules.

The port of `repro.core.engine` for ``chunk_schedule="sequential"``: an
algorithm module contributes its **rule** (a config dataclass, a state
NamedTuple, ``init`` / ``init_from_labels`` and a per-block ``chunk_rule``);
this module owns the **schedule** — a Python loop over the vertex blocks in
which block i's label, lambda and load updates are visible to block i+1
within the same superstep (the paper's asynchrony, DESIGN.md §3).

The drifting per-vertex view is the state's own tensors: each block's new
slices are written into them in place, in stream order, so the next block's
edge phase reads them. Never snapshot the vectors at the start of a
superstep.

What waits for later slices: the sharded, halo and async schedules and hub
replication (ROADMAP queue 1 item 9), shard-kind rules (item 5).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.device_graph import DeviceGraph, capacity_device


@dataclasses.dataclass(frozen=True, eq=False)
class Algorithm:
    """A partitioning algorithm as the engine sees it.

    Attributes:
      name: registry key ("revolver", ...).
      config_cls: frozen config dataclass. The engine reads ``k``,
        ``epsilon``, ``capacity_mode``, ``max_steps``, ``patience``,
        ``theta``; everything else is rule-private.
      state_cls: state NamedTuple. Must carry ``labels`` ([n_pad] int32),
        ``loads`` ([k] f32), ``gen`` (a `torch.Generator`), ``step`` (int)
        and ``score`` (0-dim f32 tensor); may add more.
      kind: "chunk" (only chunk rules are ported so far).
      vertex_fields: state fields holding per-vertex [n_pad] tensors the
        rule updates per block. Must include "labels".
      block_fields: state fields holding per-block [n_blocks, ...] tensors
        (e.g. Revolver's LA probabilities), handed to the rule one block at
        a time.
      init: ``(dg, cfg, gen) -> state`` cold start.
      init_from_labels: ``(dg, cfg, gen, labels, probs=None,
        prob_sharpen=0.0) -> state`` warm start, or None if unsupported.
      supports_probs: whether the algorithm carries an LA probability tensor
        (enables ``keep_probs`` / ``init_probs`` / ``init_sharpen``).
      chunk_rule: the local rule.
    """

    name: str
    config_cls: type
    state_cls: type
    kind: str
    init: Callable
    vertex_fields: Tuple[str, ...] = ("labels",)
    block_fields: Tuple[str, ...] = ()
    init_from_labels: Optional[Callable] = None
    supports_probs: bool = False
    chunk_rule: Optional[Callable] = None

    def __post_init__(self):
        if self.kind != "chunk":
            raise NotImplementedError(
                f"Algorithm.kind={self.kind!r}: only chunk rules are ported; "
                "shard rules come with ROADMAP queue 1 item 5")
        if "labels" not in self.vertex_fields:
            raise ValueError(f"{self.name}: vertex_fields must include 'labels'")
        if self.chunk_rule is None:
            raise ValueError(f"{self.name}: kind='chunk' needs a chunk_rule")
        required = {"labels", "loads", "gen", "step", "score"}
        missing = required - set(self.state_cls._fields)
        if missing:
            raise ValueError(f"{self.name}: state_cls lacks {sorted(missing)}")


class ChunkContext(NamedTuple):
    """What a chunk rule sees for one vertex block.

    ``v0`` is the block's offset into the per-vertex tensors. ``draws`` is
    the optional replay hook of `superstep` (``(step, blk_idx) -> draws``);
    None means the rule draws from the state's generator.
    """

    blk_idx: int            # block index
    v0: int                 # block offset into the per-vertex tensors
    e_dst: torch.Tensor     # [e_max] int32 neighbor ids (0 pad)
    e_row: torch.Tensor     # [e_max] int32 local row in the block (0 pad)
    e_w: torch.Tensor       # [e_max] f32 eq.(4) weights (0.0 pad)
    row_ptr: torch.Tensor   # [block_v+1] int32 row runs of the slab
    deg: torch.Tensor       # [block_v] f32 outdegrees
    inv_wsum: torch.Tensor  # [block_v] f32 1/sum w_hat
    vmask: torch.Tensor     # [block_v] bool real-vertex mask
    step: int               # 0-based superstep index
    draws: Optional[Callable] = None


class ChunkUpdate(NamedTuple):
    """A chunk rule's output: the engine writes ``vert`` slices into the
    per-vertex tensors (visible to later blocks) and ``block`` tensors into
    the block's slot, and threads loads and score."""

    vert: Dict[str, torch.Tensor]    # vertex_field -> [block_v] new values
    block: Dict[str, torch.Tensor]   # block_field -> updated block tensor
    loads: torch.Tensor              # [k] updated drifting load view
    score: torch.Tensor              # 0-dim score sum over the block


def superstep(algo: Algorithm, dg: DeviceGraph, cfg, state, *, draws=None):
    """One full superstep of ``algo`` under the sequential schedule.

    Updates the state's vertex fields, block fields and ``loads`` **in
    place** (where `repro` donates those buffers) and returns the state with
    the next ``step`` and this superstep's ``score``. The generator is
    advanced in place. ``draws`` replays external random draws (tests only;
    see `repro_torch.core.revolver`).
    """
    cap = capacity_device(dg.m, cfg.k, cfg.epsilon, cfg.capacity_mode, dg.device)
    bv = dg.block_v
    vert = {f: getattr(state, f) for f in algo.vertex_fields}
    blocks = {f: getattr(state, f) for f in algo.block_fields}
    loads = state.loads     # rules return new load tensors
    score_sum = torch.zeros((), dtype=torch.float32, device=dg.device)
    for b in range(dg.n_blocks):
        v0 = b * bv
        ctx = ChunkContext(
            blk_idx=b, v0=v0, e_dst=dg.blk_dst[b], e_row=dg.blk_row[b],
            e_w=dg.blk_w[b], row_ptr=dg.blk_row_ptr[b],
            deg=dg.deg_out[v0:v0 + bv], inv_wsum=dg.inv_wsum[v0:v0 + bv],
            vmask=dg.vmask[v0:v0 + bv], step=state.step, draws=draws)
        upd = algo.chunk_rule(cfg, ctx, vert, {f: t[b] for f, t in blocks.items()},
                              loads, cap, state.gen)
        for f, new in upd.vert.items():
            vert[f][v0:v0 + bv] = new
        for f, new in upd.block.items():
            blocks[f][b] = new
        loads = upd.loads
        score_sum = score_sum + upd.score
    state.loads.copy_(loads)
    return state._replace(step=state.step + 1, score=score_sum / dg.n)


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
    b(l) == sum deg over labels==l holds from step 0. Integer-valued f32
    sums, exact in any order (also with CUDA's atomic `index_add_`)."""
    loads = torch.zeros((k,), dtype=torch.float32, device=labels.device)
    return loads.index_add_(0, labels.long(), dg.deg_out)
