"""Counted costs of one step: per-rank FLOPs, HBM bytes and collective bytes.

The port's counterpart of `repro.parallel.hlo_analysis`, which parses the
compiled, SPMD-partitioned XLA module. The port has no compiler to ask, so
it runs the step itself on meta tensors (shapes and dtypes, no storage)
under a `CostCounter`, a ``TorchDispatchMode`` that sees every aten op:

  FLOPs       `torch.utils.flop_counter`'s formulas (mm, addmm, bmm,
              baddbmm, convolution); elementwise ops are not counted, as
              `repro` counts dots and convolutions only. The hand-written
              kernels (K4, K5, K6) cannot run on meta tensors: each wrapper's
              meta route reports its own counted FLOPs and the tensors it
              reads and writes (`repro_torch.kernels.ops.count_kernel`), the
              formulas of the bound column of ``chip_smoke.py``'s kernel
              table, so a dry run never counts a plain version's
              materialised scores.
  HBM bytes   each op's tensor inputs plus its outputs, at their per-rank
              size. Views move nothing; ``empty`` allocates without a
              write; ``zero_`` / ``fill_`` / ``zeros`` write their output
              only; an indexed read (``embedding``, ``index``,
              ``index_select``, ``gather``) moves its output twice plus the
              indices, an indexed write (``index_put_``) its values twice
              plus the indices, as `repro` counts dynamic slices and
              updates. Eager PyTorch fuses nothing, so this is the bytes of
              the port's op sequence, not of a fused XLA module.
  collective  the bytes one rank sends, reported through
              `repro_torch.parallel.collectives.count_collective`: the
              partial sums a sharded contraction leaves (below), and K5 on
              a cache split along its positions, the sharded flash-decode
              (each rank runs K5 on its shard and the partials merge in one
              all-reduce of o in f32, m and l: `collectives.lse_combine`).

Per rank, without building any rank: ``shard(tree, specs)`` tags tensors
with the spec entries of `repro_torch.parallel.sharding` (which tensor axis
is split over which mesh axes), and each op carries the tags from its
inputs to its outputs — through views by the axes they map, elementwise by
broadcasting. An op's FLOPs are divided by the mesh sizes of every axis its
operands are split over, its bytes counted at each tensor's per-rank size.
A product or reduction over a split axis (a row-parallel projection, a
vocab-sharded embedding lookup, a weight gradient summed over the
data-parallel tokens) leaves a partial sum on every rank: its output is
counted as one all-reduce of its per-rank bytes and loses the tag. A copy
of a split tensor into a whole one is an all-gather. A reshape that merges
or cuts a split axis keeps each split on its own sub-axis, cutting a mesh
axis into parts where a tensor axis is smaller than it (16 model ranks over
GQA's 4 KV heads x 8 q heads a group); in backward a gradient with no
split of its own (one seeded from the scalar loss) takes the splits of the
forward tensor of its shape. This is Megatron's
plan (column-parallel in-projections, row-parallel out-projections, one
all-reduce each), which is what XLA's partitioner issues for `repro`'s
serving steps; for training it issues other resharding collectives
(all-to-all, collective-permute) that this plan does not model.

`temp` is the peak of live per-rank bytes of the tensors the step makes
(its outputs included), read from their storages' lifetimes: a tensor
autograd saves stays live until backward frees it, so ``cfg.remat``
(`torch.utils.checkpoint`) shows as recomputation and a lower peak.

Sequence parallelism (``use_activation_sharding(..., sp=True)``): the
hooks of `repro_torch.parallel.act_sharding` split the counted residual
stream along S over "model" (the split is named ``"model~sp"``: the model
ranks along S) and gather it back before a block's compute, and the
counter books Megatron-SP's plan:
  * under SP a partial sum's all-reduce is booked as it is made, as above,
    and its record rides the tensor through views, casts and sums; where
    the partial lands in the split stream (a residual add with a split
    input, the gather's backward, the shard hook) it is re-booked as a
    reduce-scatter;
  * the gather hook books an all-gather; a split tensor read by a product
    or an indexed read or write, or meeting a tensor split over "model",
    is all-gathered first, once per storage: in backward the
    reduce-scatter's gradient (a row-parallel weight's product, an MoE
    layer's dispatch, the embedding's scatter), at the stream's end the
    LM head's input;
  * a ring all-reduce is a reduce-scatter followed by an all-gather, so the
    two halves each book half of the all-reduce's bytes N (the bytes of
    the whole tensor on one rank), and a pair costs what the all-reduce it
    replaces costs (repro's ``analyze_compiled`` books every collective at
    its operand's bytes instead; XLA's SP lowering of the reduced steps is
    not this plan: ``tests/test_torch_dryrun_switches.py``);
  * elementwise work on the split stream, and its live bytes, count at
    S / model a rank; a storage the hooks split or gather is re-sized.

A loop too long to run op by op (RWKV6's training scan, S steps a layer)
runs its body once under `repeat`, counted for its trip count, as `repro`
counts a scan's body; its tensors that live across the steps are made with
`split_empty`.
"""
from __future__ import annotations

import contextlib
import math
import threading
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops
from repro_torch.parallel import collectives
from repro_torch.parallel.roofline import Costs

aten = torch.ops.aten
_STATE = threading.local()

_NO_BYTES = {  # allocate or relabel, move nothing
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty, aten.new_empty_strided,
    aten.lift_fresh, aten.set_, aten.resize_, aten._local_scalar_dense, aten.detach,
    aten._unsafe_view,
}
_WRITE_ONLY = {
    aten.zero_, aten.fill_, aten.zeros, aten.zeros_like, aten.ones, aten.ones_like, aten.full,
    aten.full_like, aten.new_zeros, aten.new_ones, aten.new_full, aten.arange,
    aten.scalar_tensor, aten.randn, aten.rand, aten.normal_, aten.uniform_,
}
_MATMUL = {aten.mm: (0, 1, None), aten.addmm: (1, 2, None), aten.bmm: (0, 1, 0),
           aten.baddbmm: (1, 2, 0)}
_REDUCE = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min, aten.logsumexp,
           aten.prod, aten.any, aten.all, aten.argmax, aten.argmin, aten.var, aten.std,
           aten.linalg_vector_norm, aten.var_mean, aten.std_mean}
_SOFTMAX = {aten._softmax, aten._log_softmax, aten.softmax, aten.log_softmax}
_GATHER = {aten.embedding, aten.index, aten.index_select, aten.gather}
_RESHAPE = {aten._unsafe_view, aten.view_copy, aten.reshape, aten._reshape_copy}
# under SP a partial sum's record rides these (a sum of partial sums is one)
_SUMS = {aten.add, aten.sub, aten.add_, aten.sub_}
_CARRY = _RESHAPE | {aten._to_copy, aten.clone, aten.contiguous}
# ops that read a sequence-split input whole (gathered first)
_WHOLE = set(_MATMUL) | _GATHER | {aten.index_put, aten.index_put_}


def _sp_on() -> bool:
    from repro_torch.parallel.act_sharding import get_ctx

    ctx = get_ctx()
    return ctx is not None and ctx.sp


def active() -> "CostCounter | None":
    """The counter whose step is running on this thread, if any."""
    return getattr(_STATE, "counter", None)


@contextlib.contextmanager
def repeat(n: int):
    """Count the ops run inside ``n`` times over (their collectives once:
    `CostCounter._collective`): a loop's body run once for its trip count,
    as `repro` counts a scan's body (no counter active: nothing to
    count)."""
    c = active()
    if c is None:
        yield
        return
    old, c.scale = c.scale, c.scale * n
    try:
        yield
    finally:
        c.scale = old


def split_empty(src: torch.Tensor, shape, dims: dict) -> torch.Tensor:
    """An empty tensor of ``shape`` like ``src``, made inside a counted step
    with the splits of ``src``'s axes that ``dims`` maps onto its own
    (``{src axis: new axis}``), so its live bytes count per rank from the
    start (an allocation from no split input would count whole)."""
    c = active()
    if c is None:
        return src.new_empty(shape)
    c._quiet = True
    try:
        t = src.new_empty(shape)
    finally:
        c._quiet = False
    _tag(t, [(dims[d], a, k) for d, a, k in _entries(src) if d in dims])
    c._track(t, fresh=True)
    return t


def _entries(t) -> tuple:
    """``t``'s splits: (tensor axis, mesh axes, outer) triples, ``outer``
    the product of the sizes of the sub-axes merged into that tensor axis
    before the split one (1 for a tensor axis that was never merged)."""
    return getattr(t, "_cc_shard", ())


def _tag(t: torch.Tensor, entries) -> None:
    entries = tuple(entries)
    if entries or _entries(t):
        t._cc_shard = entries


def _axes(part) -> tuple:
    return part if isinstance(part, tuple) else (part,)


def _base(axis: str) -> str:
    return axis.split("^")[0].split("_")[0].split("~")[0]


def _seq(axis: str) -> str:
    """The sequence-parallel split over mesh axis ``axis`` (module docstring)."""
    return f"{axis}~sp"


def _is_seq(axis: str) -> bool:
    return "~sp" in axis


def _seq_entries(t) -> list:
    return [e for e in _entries(t) if any(_is_seq(a) for a in e[1])]


def _plain_entries(t) -> list:
    return [e for e in _entries(t) if not any(_is_seq(a) for a in e[1])]


class _Partial:
    """An all-reduce booked for a partial sum, which a sequence split may
    re-book as a reduce-scatter once (`CostCounter._scatter`)."""

    __slots__ = ("key", "nbytes", "axes", "done")

    def __init__(self, key: str, nbytes: float, axes: tuple):
        self.key, self.nbytes, self.axes, self.done = key, nbytes, axes, False


def _partials(t) -> list:
    return [r for r in getattr(t, "_cc_partial", ()) if not r.done]


def _mark(t: torch.Tensor, recs) -> None:
    have = _partials(t)
    t._cc_partial = have + [r for r in recs if all(r is not h for h in have)]


def _add(entries: list, dim: int, axes: tuple, outer: int = 1) -> None:
    """Add a split unless one of its mesh axes (or the whole of one of its
    parts, or a part of it) already splits another tensor axis."""
    have = {a for _, axs, _ in entries for a in axs}

    def clash(a, h):
        return a == h or (a == _base(a) and _base(h) == a) or (h == _base(h) and _base(a) == h)

    if not any(clash(a, h) for a in axes for h in have):
        entries.append((dim, tuple(axes), outer))


def _on(entries, dim: int) -> set:
    """The mesh axes tensor axis ``dim`` is split over."""
    return {a for d, axs, _ in entries if d == dim for a in axs}


def _all_axes(t) -> set:
    return {a for _, axs, _ in _entries(t) for a in axs}


def _tensors(x, out: list | None = None) -> list:
    """The tensors in ``x`` (nested lists, tuples and dicts), in order."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _part(axis: str, k: int, sizes: dict) -> tuple[str, str]:
    """Cut mesh axis ``axis`` into a major part of size ``k`` and a minor
    part of the rest (``"model^4"``, ``"model_4"``), sized in ``sizes``:
    a split axis a reshape cuts over two tensor axes (16 model ranks over
    GQA's 4 KV heads x 8 q heads a group)."""
    major, minor = f"{axis}^{k}", f"{axis}_{k}"
    sizes[major], sizes[minor] = k, sizes[axis] // k
    return major, minor


def _reshape_entries(entries, in_shape, out_shape, sizes) -> list:
    """Map splits through a reshape by the flat offset of the sub-axis
    each one splits: it lands on the output axis holding that offset, with
    the sizes merged before it there as its ``outer``. Merged input axes
    thus keep one split each (heads into a batch of heads), and cut back
    they return to their own axes; a split over several mesh axes that
    the output cuts gives each output axis what its size takes, outer
    first, a mesh axis larger than that cut into parts (`_part`). A split
    no output axis divides is dropped."""
    out: list = []
    runs = [math.prod(out_shape[:j]) for j in range(len(out_shape))]
    for d, axes, outer in entries:
        offset = math.prod(in_shape[:d]) * outer
        size = in_shape[d] // outer
        j = next((j for j, run in enumerate(runs)
                  if run <= offset < run * out_shape[j] and offset % run == 0), None)
        if j is None:
            continue
        outer, axes = offset // runs[j], list(axes)
        while axes and j < len(out_shape):
            n = min(out_shape[j] // outer, size)
            take, f = [], 1
            while axes:
                m = sizes[axes[0]]
                if n % (f * m) == 0:
                    f *= m
                    take.append(axes.pop(0))
                elif n // f > 1 and m % (n // f) == 0:
                    major, axes[0] = _part(axes[0], n // f, sizes)
                    f = n
                    take.append(major)
                else:
                    break
            if take:
                out.append((j, tuple(take), outer))
            if not axes or f != n:
                break
            size //= n
            j, outer = j + 1, 1
    return out


def _broadcast_entries(inputs, out: torch.Tensor) -> list:
    """Elementwise splits: each input's aligned from the right, kept where
    the output axis has the input axis's size."""
    entries: list = []
    for t in inputs:
        for d, axes, outer in _entries(t):
            j = d + out.dim() - t.dim()
            if 0 <= j < out.dim() and out.shape[j] == t.shape[d]:
                _add(entries, j, axes, outer)
    return entries


def _dims(arg, ndim: int) -> list:
    if arg is None:
        return list(range(ndim))
    arg = [arg] if isinstance(arg, int) else list(arg)
    return sorted(a % ndim for a in arg) if arg else list(range(ndim))


class CostCounter(TorchDispatchMode):
    """Counts the ops of a step run on meta tensors inside ``with counter:``
    (module docstring). ``mesh`` (an `LMMesh`, devices or not) sizes the
    split axes that `shard` tags; ``None`` counts one device."""

    def __init__(self, mesh=None):
        super().__init__()
        self.sizes = dict(mesh.shape) if mesh is not None else {}
        self.sizes.update({_seq(a): n for a, n in list(self.sizes.items())})
        self._sp_seen = False                # a sequence split was made
        self._gathered: set = set()          # storages gathered for a read (live ones)
        self.flops = 0.0
        self.bytes = 0.0
        self.collective_bytes = 0.0
        self.collectives = defaultdict(lambda: {"count": 0.0, "bytes": 0.0})
        self.bytes_by_op: dict = defaultdict(float)
        self.coll_by_op: dict = defaultdict(float)
        self.kernel_calls: dict = defaultdict(int)
        self.scale = 1                       # `repeat`'s trip count
        self._quiet = False                  # `split_empty` makes its tensor
        self._forward_splits: dict = {}      # shape -> splits of a forward tensor
        self.live = 0
        self.peak = 0
        self._storages: dict = {}            # storage key -> [local bytes, live views]

    # ---- splits -----------------------------------------------------------
    def factor(self, axes) -> int:
        """Ranks ``axes`` split over; a mesh axis named whole counts once,
        however many of its parts are named beside it."""
        axes = set(axes)
        whole = {a for a in axes if _base(a) == a}
        return math.prod(self.sizes.get(a, 1) for a in axes
                         if a in whole or _base(a) not in whole)

    def local_bytes(self, t: torch.Tensor) -> float:
        """``t``'s bytes on one rank under its splits."""
        return t.numel() * t.element_size() / self.factor(_all_axes(t))

    def split_axes(self, t: torch.Tensor, dim: int) -> tuple:
        """The mesh axes tensor axis ``dim`` of ``t`` is split over."""
        return tuple(sorted(_on(_entries(t), dim % t.dim())))

    def shard(self, tree, specs) -> None:
        """Tag every tensor leaf of ``tree`` with its spec from ``specs`` (a
        tree of `sharding.P` of the same nesting): entry i names the mesh
        axes tensor axis i is split over."""
        from repro_torch.parallel.sharding import tree_map_with_path

        def tag(_, x, spec):
            entries = [(i, _axes(part), 1) for i, part in enumerate(spec) if part is not None]
            for i, axes, _ in entries:
                if x.shape[i] % self.factor(axes):
                    raise ValueError(f"axis {i} of {tuple(x.shape)} does not split over {axes}")
            _tag(x, [e for e in entries if self.factor(e[1]) > 1])

        tree_map_with_path(tag, tree, specs)

    def _divisor(self, tensors) -> int:
        axes = set()
        for t in tensors:
            axes |= _all_axes(t)
        return self.factor(axes)

    # ---- counts -----------------------------------------------------------
    def _collective(self, kind: str, nbytes: float, axes) -> None:
        """One collective, counted once even inside `repeat`: a loop body's
        reductions over a split are sums that accumulate on each rank (a
        scan's gradients of its shared weights) and cross once."""
        if nbytes <= 0 or (axes is not None and self.factor(axes) == 1):
            return
        self.collective_bytes += nbytes
        self.collectives[kind]["count"] += 1
        self.collectives[kind]["bytes"] += nbytes

    def _reduce(self, name: str, out: torch.Tensor, axes: set) -> None:
        """A partial sum over ``axes`` on every rank: one all-reduce of the
        output's per-rank bytes."""
        if out is not None and axes and self.factor(axes) > 1:
            nbytes = self.local_bytes(out)
            key = f"{name} {list(out.shape)}"
            collectives.count_collective("all-reduce", nbytes, tuple(sorted(axes)))
            self.coll_by_op[f"all-reduce {key}"] += nbytes
            if _sp_on():
                _mark(out, [_Partial(key, nbytes, tuple(sorted(axes)))])

    def kernel(self, name: str, flops: float, reads, writes) -> None:
        """A hand-written kernel's meta route (`kernels.ops.count_kernel`):
        ``flops`` over the whole call, the tensors it reads once and writes
        once. K5 (``decode_attention``) on a cache split along its
        positions adds the sharded flash-decode's combine (module
        docstring)."""
        tensors = [t for t in list(reads) + list(writes) if t is not None]
        self.flops += flops / self._divisor(tensors) * self.scale
        nbytes = sum(self.local_bytes(t) for t in tensors) * self.scale
        self.bytes += nbytes
        self.bytes_by_op[f"kernel {name}"] += nbytes
        self.kernel_calls[name] += self.scale
        if name == "decode_attention":
            axes = self.split_axes(reads[1], 2)
            if axes:
                o = writes[0]
                rows = self.local_bytes(o) / o.element_size() / o.shape[-1]
                nbytes = 4 * rows * o.shape[-1] + 2 * 4 * rows     # o in f32, m and l
                collectives.count_collective("all-reduce", nbytes, axes)
                self.coll_by_op[f"all-reduce {name} combine"] += nbytes

    def costs(self) -> Costs:
        return Costs(flops=self.flops, bytes=self.bytes, collective_bytes=self.collective_bytes,
                     collectives={k: dict(v) for k, v in self.collectives.items()})

    def top_bytes(self, n: int = 12) -> list:
        return sorted(self.bytes_by_op.items(), key=lambda kv: -kv[1])[:n]

    def top_collectives(self, n: int = 12) -> list:
        return sorted(((k, v) for k, v in self.coll_by_op.items() if v),
                      key=lambda kv: -kv[1])[:n]

    # ---- sequence parallelism (module docstring) ----------------------------
    def _stream_entries(self, spec, seq: bool) -> list:
        """The residual stream's splits under a hook's ``spec`` (dim 0 over
        the data axes, with ``seq`` dim 1 along S): the hook states the
        layout, whatever splits a gradient took from a forward tensor of
        its shape (`_backward_splits`)."""
        entries = []
        if spec[0] is not None and self.factor(_axes(spec[0])) > 1:
            entries.append((0, _axes(spec[0]), 1))
        if seq and spec[1] is not None and self.factor(_axes(spec[1])) > 1:
            entries.append((1, tuple(_seq(a) for a in _axes(spec[1])), 1))
        return entries

    def split_seq(self, t: torch.Tensor, spec) -> None:
        """``t`` (a view a hook returns) split along dim 1 over the mesh axes
        of ``spec[1]`` from here: a partial sum it carries is
        reduce-scattered into the split, a whole tensor is cut where it lies
        (no collective), and its storage counts at its split size."""
        self._scatter(_partials(t))
        t._cc_partial = []
        _tag(t, self._stream_entries(spec, seq=True))
        self._sp_seen = True
        self._resize(t)

    def gather_seq(self, t: torch.Tensor, spec) -> bool:
        """All-gather a split ``t`` (a view a hook returns) along S: booked,
        its splits along S dropped, its storage re-sized to the whole.
        Returns whether ``t`` was split."""
        if not _seq_entries(t):
            return False
        self._all_gather(t)
        _tag(t, self._stream_entries(spec, seq=False))
        self._resize(t)
        return True

    def _all_gather(self, t: torch.Tensor, nbytes: float | None = None) -> None:
        """Book the all-gather of ``t`` along S (of ``nbytes``, its whole
        bytes, when given: a view gathers its storage)."""
        axes = tuple(sorted({_base(a) for _, axs, _ in _seq_entries(t) for a in axs}))
        whole = (t.numel() * t.element_size() if nbytes is None else nbytes) / self.factor(
            {a for _, axs, _ in _plain_entries(t) for a in axs})
        collectives.count_collective("all-gather", whole / 2, axes)
        self.coll_by_op[f"all-gather {list(t.shape)}"] += whole / 2

    def _scatter(self, recs) -> None:
        """Re-book the all-reduces of ``recs`` over the split's mesh axis
        as reduce-scatters of half their bytes (module docstring)."""
        for r in recs:
            if r.done or {_base(a) for a in r.axes} != {"model"}:
                continue
            r.done = True
            self.collective_bytes -= r.nbytes
            self.collectives["all-reduce"]["count"] -= 1
            self.collectives["all-reduce"]["bytes"] -= r.nbytes
            self.coll_by_op[f"all-reduce {r.key}"] -= r.nbytes
            collectives.count_collective("reduce-scatter", r.nbytes / 2, r.axes)
            self.coll_by_op[f"reduce-scatter {r.key}"] += r.nbytes / 2

    def _gather_conflicts(self, packet, ins) -> list:
        """A split input read by a product or an indexed read or write, or
        meeting a tensor split over the same mesh axis on another of its
        axes, is all-gathered first (once per storage while it lives) and
        read whole by this op: only elementwise work, reductions and views
        run on the split. Returns (tensor, its splits) to restore after the
        op."""
        restore = []
        whole = packet in _WHOLE or packet in flop_registry
        for t in ins:
            seq = _seq_entries(t)
            if not seq:
                continue
            bases = {_base(a) for _, axs, _ in seq for a in axs}
            if not whole and not any(_base(a) in bases for u in ins if u is not t
                                     for _, axs, _ in _plain_entries(u) for a in axs):
                continue
            key = t.untyped_storage()._cdata
            if key not in self._gathered:           # the whole storage, once
                self._all_gather(t, t.untyped_storage().nbytes())
                self._gathered.add(key)
            restore.append((t, _entries(t)))
            _tag(t, _plain_entries(t))
        return restore

    def _carry_partials(self, packet, view: bool, ins, outs) -> None:
        recs = []
        for t in ins:
            recs += [r for r in _partials(t) if all(r is not h for h in recs)]
        if not recs or not outs:
            return
        if packet in _SUMS:
            if any(_seq_entries(t) for t in ins):   # lands in the split stream
                self._scatter(recs)
            else:
                _mark(outs[0], recs)
        elif view or packet in _CARRY:
            for o in outs:
                _mark(o, recs)
        else:                           # read whole: its all-reduce stands
            for r in recs:
                r.done = True

    # ---- live bytes -------------------------------------------------------
    def _release(self, key) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]
            self._gathered.discard(key)

    def _resize(self, t: torch.Tensor) -> None:
        """Re-size ``t``'s storage to its per-rank bytes under its splits now
        (a hook split or gathered it)."""
        entry = self._storages.get(t.untyped_storage()._cdata)
        if entry is not None:
            new = t.untyped_storage().nbytes() / self.factor(_all_axes(t))
            self.live += new - entry[0]
            entry[0] = new
            self.peak = max(self.peak, self.live)

    def _track(self, t: torch.Tensor, fresh: bool) -> None:
        key = t.untyped_storage()._cdata
        entry = self._storages.get(key)
        if entry is None:
            if not fresh:
                return                            # a view of an argument
            f = self.factor(_all_axes(t))
            entry = self._storages[key] = [t.untyped_storage().nbytes() / f, 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    # ---- the mode ---------------------------------------------------------
    def __enter__(self):
        if active() is not None:
            raise RuntimeError("a CostCounter is already counting on this thread")
        _STATE.counter = self
        collectives._HOOK.fn = self._collective
        ops.KERNEL_HOOK.fn = self.kernel
        return super().__enter__()

    def __exit__(self, *exc):
        ops.KERNEL_HOOK.fn = None
        collectives._HOOK.fn = None
        _STATE.counter = None
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        ins = _tensors((args, kwargs))
        restore = self._gather_conflicts(func.overloadpacket, ins) if self._sp_seen else ()
        try:
            self._count(func, args, kwargs, ins, out)
        finally:
            for t, entries in restore:
                _tag(t, entries)
        return out

    def _count(self, func, args, kwargs, ins, out) -> None:
        outs = _tensors(out)
        packet = func.overloadpacket
        if func.is_view:
            self._view(packet, args, outs)
            self._backward_splits(outs)
            self._carry_partials(packet, True, ins, outs)
            for t in outs:
                self._track(t, fresh=False)
            return
        name = packet.__name__
        reduced: set = set()
        self._propagate(packet, func, args, kwargs, ins, outs, reduced)
        self._backward_splits(outs)
        self._carry_partials(packet, False, ins, outs)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out) / \
                self._divisor(ins + outs) * self.scale
        nbytes = self._bytes(packet, func, args, ins, outs) * self.scale
        self.bytes += nbytes
        if nbytes:
            shape = list(outs[0].shape) if outs else []
            self.bytes_by_op[f"{name} {shape}"] += nbytes
        in_ids = {id(t) for t in ins}
        in_keys = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            if id(t) not in in_ids:
                self._track(t, fresh=t.untyped_storage()._cdata not in in_keys)

    def _backward_splits(self, outs) -> None:
        """A gradient is split as its forward tensor is: in the forward pass
        remember each split tensor's shape, in backward give an unsplit
        output the splits of a forward tensor of its shape (a gradient
        seeded from the scalar loss carries no split of its own)."""
        backward = torch._C._current_graph_task_id() != -1
        for t in outs:
            entries = _entries(t)
            if not backward:
                if _plain_entries(t):           # a split along S is not a gradient's
                    self._forward_splits[tuple(t.shape)] = tuple(_plain_entries(t))
            elif not entries and t.dim():
                _tag(t, self._forward_splits.get(tuple(t.shape), ()))

    # ---- split rules ------------------------------------------------------
    def _view(self, packet, args, outs) -> None:
        src = args[0]
        entries = _entries(src)
        if not entries:
            return
        for o in outs:
            _tag(o, self._view_entries(packet, args, src, o, entries))

    def _view_entries(self, packet, args, src, o, entries) -> list:
        nd = src.dim()
        if packet in (aten.t, aten.transpose):
            d0, d1 = (0, 1) if packet is aten.t else (args[1] % nd, args[2] % nd)
            perm = list(range(nd))
            perm[d0], perm[d1] = perm[d1], perm[d0]
        elif packet is aten.permute:
            perm = [p % nd for p in args[1]]
        else:
            perm = None
        if perm is not None:
            return [(perm.index(d), a, k) for d, a, k in entries]
        if packet in (aten.select, aten.unbind):
            dim = (args[1] if len(args) > 1 else 0) % nd
            return [(d - (d > dim), a, k) for d, a, k in entries if d != dim]
        if packet in (aten.slice, aten.split, aten.split_with_sizes, aten.chunk, aten.narrow,
                      aten.alias, aten.detach):
            return [(d, a, k) for d, a, k in entries if o.shape[d] % self.factor(a) == 0]
        if packet is aten.expand:
            shift = o.dim() - nd
            return [(d + shift, a, k) for d, a, k in entries]
        return _reshape_entries(entries, list(src.shape), list(o.shape), self.sizes)

    def _propagate(self, packet, func, args, kwargs, ins, outs, reduced: set) -> None:
        if not outs:
            return
        out = outs[0]
        name = packet.__name__
        if packet in _MATMUL:
            ia, ib, batch = _MATMUL[packet]
            a, b = args[ia], args[ib]
            m, k_a, k_b, n = a.dim() - 2, a.dim() - 1, b.dim() - 2, b.dim() - 1
            entries: list = []
            for t, keep in ((a, {m: out.dim() - 2}), (b, {n: out.dim() - 1})):
                if batch is not None:
                    keep[0] = 0
                for d, axes, k in _entries(t):
                    if d in keep:
                        _add(entries, keep[d], axes, k)
            reduced |= _on(_entries(a), k_a) | _on(_entries(b), k_b)
            _tag(out, entries)
            self._reduce(name, out, reduced)
            return
        if packet in _REDUCE:
            src = args[0]
            dims = _dims(kwargs.get("dim", args[1] if len(args) > 1 and not
                                    isinstance(args[1], bool) else None), max(src.dim(), 1))
            keep = kwargs.get("keepdim", args[2] if len(args) > 2 and isinstance(args[2], bool)
                              else False)
            entries = []
            for d, a, k in _entries(src):
                if d in dims:
                    reduced.update(a)
                else:
                    _add(entries, d if keep else d - sum(x < d for x in dims), a, k)
            for o in outs:
                if o.dim() == (src.dim() if keep else src.dim() - len(dims)):
                    _tag(o, entries)
            self._reduce(name, out, reduced)
            return
        if packet in _SOFTMAX:
            src, dim = args[0], args[1] % max(args[0].dim(), 1)
            split = _on(_entries(src), dim)
            if split:                   # the max and the sum of each row, over the split
                nbytes = 2 * self.local_bytes(out) / out.shape[dim]
                collectives.count_collective("all-reduce", nbytes, tuple(sorted(split)))
                self.coll_by_op[f"all-reduce {name} stats"] += nbytes
            _tag(out, _entries(src))
            return
        if packet in _GATHER:
            self._gather(packet, args, out, reduced)
            return
        if packet in _RESHAPE:
            _tag(out, _reshape_entries(_entries(args[0]), list(args[0].shape),
                                       list(out.shape), self.sizes))
            return
        if packet is aten.copy_:
            dst, src = args[0], args[1]
            lost = _all_axes(src) - _all_axes(dst)
            if lost and self.factor(lost) > 1:
                nbytes = self.local_bytes(src)
                collectives.count_collective("all-gather", nbytes, tuple(sorted(lost)))
                self.coll_by_op[f"all-gather copy_ {list(src.shape)}"] += nbytes
            return
        if packet in (aten.index_put_, aten.index_put):
            accumulate = len(args) > 3 and args[3] or kwargs.get("accumulate", False)
            _tag(out, _entries(args[0]))
            if accumulate:                          # sums over a split: an all-reduce
                self._reduce(name, out, _all_axes(args[2]) - _all_axes(args[0]))
            return
        if func._schema.is_mutable and outs and ins and outs[0] is ins[0]:
            return                                  # in place: the target keeps its splits
        for o in outs:
            _tag(o, _broadcast_entries(ins, o))

    def _gather(self, packet, args, out, reduced: set) -> None:
        if packet is aten.embedding:
            table, idx = args[0], args[1]
            entries = list(_entries(idx))
            for d, a, k in _entries(table):
                if d == 1:
                    _add(entries, out.dim() - 1, a, k)
                else:
                    reduced.update(a)
        elif packet is aten.index:
            src, indices = args[0], args[1]
            pos = [i for i, x in enumerate(indices) if x is not None]
            idx = [x for x in indices if x is not None]
            width = max(x.dim() for x in idx)
            entries = [e for e in _entries(src) if e[0] < pos[0]]
            for x in idx:
                for d, a, k in _entries(x):
                    _add(entries, pos[0] + d + width - x.dim(), a, k)
            for d, a, k in _entries(src):
                if d in pos:
                    reduced.update(a)
                elif d > pos[-1]:
                    _add(entries, d - len(pos) + width, a, k)
            if torch._C._current_graph_task_id() == -1 and _on(_entries(src), pos[0]):
                # its gradient, a scatter-add into a table of this shape,
                # lands in the same shards (`_backward_splits`)
                self._forward_splits[tuple(src.shape)] = _entries(src)
        else:                                        # index_select / gather along dim
            src, dim, idx = args[0], args[1] % args[0].dim(), args[2]
            entries = list(_entries(idx)) if packet is aten.gather else \
                [e for e in _entries(src) if e[0] != dim]
            reduced |= _on(_entries(src), dim)
        _tag(out, entries)
        self._reduce(packet.__name__, out, reduced)

    # ---- byte rules -------------------------------------------------------
    def _bytes(self, packet, func, args, ins, outs) -> float:
        if packet in _NO_BYTES:
            return 0.0
        if packet in _WRITE_ONLY:
            return sum(self.local_bytes(t) for t in outs)
        if packet in _GATHER:
            idx = [t for t in ins if not t.is_floating_point()]
            return 2 * sum(self.local_bytes(t) for t in outs) + \
                sum(self.local_bytes(t) for t in idx)
        if packet in (aten.index_put_, aten.index_put):
            values = args[2]
            idx = [t for t in _tensors(args[1])]
            return 2 * self.local_bytes(values) + sum(self.local_bytes(t) for t in idx)
        seen, total = set(), 0.0
        for t in ins:
            if id(t) not in seen:
                seen.add(id(t))
                total += self.local_bytes(t)
        return total + sum(self.local_bytes(t) for t in outs)


__all__ = ["CostCounter", "active", "repeat", "split_empty"]
