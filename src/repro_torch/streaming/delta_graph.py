"""Incremental graph state: merge edge deltas without a full host rebuild.

The port of `repro.streaming.delta_graph`. Three structures are maintained
across deltas:

  * `dir_keys`  — sorted int64 keys of the directed edge set;
  * `sym_keys`, `sym_w` — sorted keys + eq.-(4) weights of the symmetrized
    adjacency (weight 1 = one direction present, 2 = both);
  * the padded block slabs of the `DeviceGraph` (blk_dst / blk_row / blk_w),
    kept on the host and resident on the device.

A delta of d events merges in O(m + d log m) on the host (`IncrementalGraph`,
copied from `repro` with its numpy arithmetic unchanged): canonicalize the
delta, splice it into the maintained arrays, recompute the eq.-(4) weights
of the touched vertex pairs only. `IncrementalDeviceGraph` then rewrites
only the block slabs owning a touched vertex, on the host and on the
device, with each rewritten block's row pointer; the span plan (the work
split K1 and K3 read) is derived anew from the row pointer every delta.
The slab width `e_max` is kept across deltas until a
block overflows it; then every slab is re-padded with headroom
(`e_headroom`) into newly allocated device slabs.

Over a `BlocksMesh` (``mesh=``) the layout is `repro`'s mesh-aligned one:
padded with empty blocks to a multiple of the shard count, optionally in a
permuted block->shard storage order (``assignment=``), each dirty slab
written straight into its storage row on the device of the shard that owns
it; `IncrementalDeviceGraph.as_sharded` wraps it for the sharded, halo and
async schedules, with a halo and hub plan rebuilt every delta under
monotonic shape floors.

The vertex space is declared up front (`n`): vertices materialize
implicitly as edges touch them and contribute nothing while isolated.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.device_graph import (
    _VERTEX_FIELDS,
    DeviceGraph,
    ShardedDeviceGraph,
    SpanPlan,
    _upload_shards,
    block_vertex_perms,
    resolve_device,
    vertex_arrays,
)
from repro_torch.core.halo import DEFAULT_HALO_THRESHOLD, HubConfig, build_halo_spec
from repro_torch.graphs.blocking import (
    block_adjacency,
    block_slab_sizes,
    check_integer_weights,
    fill_block_slab,
    locality_block_order,
    slab_row_ptr,
)
from repro_torch.graphs.csr import (
    Graph,
    canonicalize_edges,
    decode_edge_keys,
    graph_from_sorted_state,
    merge_sorted_keys,
    remove_sorted_keys,
    sorted_isin,
)
from repro_torch.streaming.stream import EdgeDelta

@dataclasses.dataclass
class MergeInfo:
    """What one delta merge did (diagnostics + StreamRunner reporting)."""

    added: int = 0              # directed edges actually inserted
    deleted: int = 0            # directed edges actually removed
    dup_dropped: int = 0        # insertions already present (or in-delta dups)
    missing_dropped: int = 0    # deletions of absent edges
    touched_vertices: Optional[np.ndarray] = None   # endpoints of changed pairs
    dirty_blocks: int = 0       # block slabs rewritten (device layer)
    repadded: bool = False      # e_max overflow forced a full re-pad
    m: int = 0                  # |E| after the merge


class IncrementalGraph:
    """Host-side CSR state maintained across deltas (see module docstring)."""

    def __init__(self, n: int):
        if n <= 0:
            raise ValueError(f"vertex space must be positive, got {n}")
        self.n = n
        self.dir_keys = np.empty(0, dtype=np.int64)
        self.sym_keys = np.empty(0, dtype=np.int64)
        self.sym_w = np.empty(0, dtype=np.float32)
        self.deltas_applied = 0

    @property
    def m(self) -> int:
        return int(self.dir_keys.size)

    def _check_delta(self, delta: EdgeDelta):
        """Reject malformed deltas before any state is touched, naming the
        delta so a bad producer in a long stream is attributable."""
        idx = self.deltas_applied
        pairs = (("add_src", delta.add_src, "add_dst", delta.add_dst),
                 ("del_src", delta.del_src, "del_dst", delta.del_dst))
        for sname, s, dname, d in pairs:
            s, d = np.asarray(s), np.asarray(d)
            if s.shape != d.shape:
                raise ValueError(
                    f"delta {idx}: {sname}/{dname} shape mismatch "
                    f"{s.shape} vs {d.shape}")
            for name, a in ((sname, s), (dname, d)):
                if a.dtype.kind == "f" and not np.isfinite(a).all():
                    raise ValueError(
                        f"delta {idx}: {name} contains NaN/inf edge data")
                if a.dtype.kind not in "iu" and not (
                        a.dtype.kind == "f"
                        and (not a.size or (a == np.floor(a)).all())):
                    raise ValueError(
                        f"delta {idx}: {name} dtype {a.dtype} is not a "
                        "vertex-id array")
                if a.size and int(a.min()) < 0:
                    raise ValueError(
                        f"delta {idx}: {name} contains negative vertex ids "
                        f"(min {int(a.min())})")
                if a.size and int(a.max()) >= self.n:
                    raise ValueError(
                        f"delta {idx}: {name} contains vertex ids >= "
                        f"n={self.n} (max {int(a.max())})")

    def apply(self, delta: EdgeDelta) -> MergeInfo:
        """Merge one delta. Deletions apply before insertions, so an edge
        deleted and re-added within the same delta ends up present.
        Malformed deltas (id out of [0, n), NaN/inf data, shape-mismatched
        src/dst) raise ValueError naming the delta index, before any state
        is modified."""
        self._check_delta(delta)
        n = self.n
        info = MergeInfo()

        dels = canonicalize_edges(delta.del_src, delta.del_dst, n)
        dels = dels[sorted_isin(self.dir_keys, dels)]
        info.missing_dropped = delta.n_del - int(dels.size)
        dir_mid = remove_sorted_keys(self.dir_keys, dels)

        adds = canonicalize_edges(delta.add_src, delta.add_dst, n)
        adds = adds[~sorted_isin(dir_mid, adds)]
        info.dup_dropped = delta.n_add - int(adds.size)
        self.dir_keys = merge_sorted_keys(dir_mid, adds)
        info.added, info.deleted = int(adds.size), int(dels.size)
        info.m = self.m

        # ---- eq.-(4) weight maintenance for the touched pairs only --------
        changed = np.concatenate([dels, adds])
        if changed.size:
            u, v = decode_edge_keys(changed, n)
            pu, pv = np.minimum(u, v).astype(np.int64), np.maximum(u, v).astype(np.int64)
            pairs = np.unique(pu * n + pv)
            pu, pv = decode_edge_keys(pairs, n)
            pu, pv = pu.astype(np.int64), pv.astype(np.int64)
            fwd, rev = pu * n + pv, pv * n + pu
            cnt = (
                sorted_isin(self.dir_keys, fwd).astype(np.int8)
                + sorted_isin(self.dir_keys, rev).astype(np.int8)
            )
            present = sorted_isin(self.sym_keys, fwd)

            # slots to drop: pair lost its last direction
            gone = present & (cnt == 0)
            if gone.any():
                drop = np.sort(np.concatenate([fwd[gone], rev[gone]]))
                idx = np.searchsorted(self.sym_keys, drop)
                self.sym_keys = np.delete(self.sym_keys, idx)
                self.sym_w = np.delete(self.sym_w, idx)

            # weight rewrites: pair survives with a (possibly) new direction count
            upd = present & (cnt > 0)
            if upd.any():
                keys = np.concatenate([fwd[upd], rev[upd]])
                w = np.concatenate([cnt[upd], cnt[upd]]).astype(np.float32)
                self.sym_w[np.searchsorted(self.sym_keys, keys)] = w

            # fresh slots: pair gained its first direction
            new = (~present) & (cnt > 0)
            if new.any():
                keys = np.concatenate([fwd[new], rev[new]])
                w = np.concatenate([cnt[new], cnt[new]]).astype(np.float32)
                order = np.argsort(keys)
                keys, w = keys[order], w[order]
                idx = np.searchsorted(self.sym_keys, keys)
                self.sym_keys = np.insert(self.sym_keys, idx, keys)
                self.sym_w = np.insert(self.sym_w, idx, w)

            info.touched_vertices = np.unique(np.concatenate([pu, pv])).astype(np.int64)
        else:
            info.touched_vertices = np.empty(0, dtype=np.int64)
        self.deltas_applied += 1
        return info

    def to_graph(self) -> Graph:
        """O(m) materialization of the standard `Graph` container."""
        return graph_from_sorted_state(self.n, self.dir_keys, self.sym_keys, self.sym_w)


class IncrementalDeviceGraph:
    """Pads an evolving graph into a `DeviceGraph` resident on the device.

    `apply(delta)` merges the delta (`IncrementalGraph`) and returns a
    `DeviceGraph` whose slabs stay resident across deltas: without a re-pad
    only the slab rows of blocks owning a touched vertex are rewritten and
    copied up, with their `blk_row_ptr` rows; the span plan (`blk_spans`)
    is derived anew from the whole row pointer every delta, so it always
    follows the slabs. An `e_max` overflow re-pads every slab with headroom
    into newly allocated device slabs. The flat directed edges (`dir_src` /
    `dir_dst`) and the per-vertex arrays are uploaded every delta, as
    `repro` does. `upload_bytes` counts what the last delta moved host ->
    device (`as_sharded`'s plan included).

    **Aliasing:** the returned `DeviceGraph` shares its slabs and row
    pointer with the next delta's (until a re-pad), which rewrites them in
    place: hold only the latest one, as `StreamRunner` does.

    **Mesh** (``mesh=``, a `BlocksMesh`; its home device is the layout's):
    the block count is padded up front to a multiple of the shard count
    with empty blocks that never hold a vertex (slab rewrites stop at the
    real blocks). The whole layout lives on the home device; a shard on
    another device keeps its own resident copy of its slab rows, and a
    dirty block's row is written on the device of the shard that owns it.

    **Locality-aware assignment** (``assignment="locality"`` or an explicit
    block permutation; requires ``mesh``): the maintained slabs live in
    permuted *storage* order with neighbor ids rewritten into the permuted
    space, so a rewritten dirty slab still lands on the shard that owns the
    block. A "locality" permutation is decided once, from the block-level
    edge-cut matrix of the first non-empty merge, and then held fixed for
    the whole stream (the carried labels and probabilities depend on a
    stable layout).

    **Halo** (`as_sharded(halo=True)`): the exchange plan is rebuilt every
    delta from the current slabs, its shapes (`b_max`, `h_max`, the hub
    region and the vote table) floored at their historical maxima and the
    hub set only ever growing, as in `repro`.
    """

    def __init__(
        self,
        n: int,
        *,
        n_blocks: int = 8,
        block_multiple: int = 8,
        edge_chunk: int = 256,
        e_headroom: float = 1.5,
        mesh=None,
        assignment: Union[str, np.ndarray, None] = "contiguous",
        device=None,
    ):
        if mesh is None:
            self.device = resolve_device("cuda" if device is None else device)
        else:
            self.device = mesh.home
            if device is not None and resolve_device(device).type != self.device.type:
                raise ValueError(f"mesh {mesh} is not on device={device!r}")
        self.inc = IncrementalGraph(n)
        n_blocks = max(1, min(n_blocks, n))
        block_v = -(-n // n_blocks)
        block_v = -(-block_v // block_multiple) * block_multiple
        self.block_v = block_v
        self.n_blocks = -(-n // block_v)
        # blocks that can ever hold a real vertex (slab rewrites stop here;
        # alignment blocks beyond stay all-zero for the whole stream)
        self._real_blocks = self.n_blocks
        self.mesh = mesh
        if mesh is not None:
            self.n_blocks += (-self.n_blocks) % mesh.n_shards
        self.n_pad = self.n_blocks * block_v
        self.edge_chunk = edge_chunk
        self.e_headroom = float(e_headroom)
        self.e_max = 0
        # host copies of the slabs (each delta rewrites the dirty rows here
        # first) and of the row pointer, in storage order
        self._blk_dst = np.zeros((self.n_blocks, 0), dtype=np.int32)
        self._blk_row = np.zeros((self.n_blocks, 0), dtype=np.int32)
        self._blk_w = np.zeros((self.n_blocks, 0), dtype=np.float32)
        self._row_ptr = np.zeros((self.n_blocks, block_v + 1), dtype=np.int32)
        # the resident slabs and row pointer: the whole layout on the home
        # device, and each shard's rows on its own device (views of the
        # home tensors for a shard on the home device)
        self._dev: dict = {}
        self._shard_dev: Optional[list] = None
        self.upload_bytes = 0
        self.graph: Optional[Graph] = None
        self.device_graph: Optional[DeviceGraph] = None
        # block->shard assignment state (storage permutation)
        if isinstance(assignment, str) and assignment not in ("contiguous", "locality"):
            raise ValueError(
                f"unknown assignment {assignment!r}; expected 'contiguous', "
                "'locality', or an explicit block permutation")
        if not isinstance(assignment, str) and assignment is not None:
            assignment = np.asarray(assignment, dtype=np.int64)
        if mesh is None and ((isinstance(assignment, str) and assignment == "locality")
                             or isinstance(assignment, np.ndarray)):
            raise ValueError("a block->shard assignment needs a mesh")
        self.block_perm: Optional[np.ndarray] = None  # storage -> orig block
        self._pos: Optional[np.ndarray] = None        # orig block -> storage
        self.o2s: Optional[np.ndarray] = None
        self.s2o: Optional[np.ndarray] = None
        self._o2s_t: Optional[torch.Tensor] = None    # on the home device
        self._s2o_t: Optional[torch.Tensor] = None
        # "locality" is decided once, from the first non-empty merge; the
        # flag (not `block_perm is None` — the decision may be the
        # identity) keeps it from being re-decided every delta
        self._perm_decided = not (isinstance(assignment, str) and assignment == "locality")
        if isinstance(assignment, np.ndarray):
            self._set_perm(assignment)
        # the halo plan's monotonic shape floors and hub set
        self._b_max_floor = 0
        self._h_max_floor = 0
        self._hub_pad_floor = 0
        self._he_max_floor = 0
        self._hub_ids: Tuple[int, ...] = ()
        # storage-order host copies of the per-vertex arrays, for the hub
        # selection in as_sharded
        self._deg_host: Optional[np.ndarray] = None
        self._vmask_host: Optional[np.ndarray] = None

    def _set_perm(self, perm: np.ndarray):
        perm = np.asarray(perm, dtype=np.int64)
        if perm.shape != (self.n_blocks,) or not np.array_equal(
                np.sort(perm), np.arange(self.n_blocks)):
            raise ValueError(f"perm must be a permutation of range({self.n_blocks})")
        if np.array_equal(perm, np.arange(self.n_blocks)):
            return
        self.block_perm = perm
        self._pos = np.empty(self.n_blocks, dtype=np.int64)
        self._pos[perm] = np.arange(self.n_blocks)
        self.o2s, self.s2o = block_vertex_perms(perm, self.block_v)
        # uploaded once: the permutation is fixed for the rest of the stream
        self._o2s_t = torch.from_numpy(self.o2s.astype(np.int64)).to(self.device)
        self._s2o_t = torch.from_numpy(self.s2o.astype(np.int64)).to(self.device)
        self.upload_bytes += self._o2s_t.nbytes + self._s2o_t.nbytes

    def _storage_row(self, blk: int) -> int:
        return int(self._pos[blk]) if self._pos is not None else int(blk)

    @property
    def n(self) -> int:
        return self.inc.n

    @property
    def perm_decided(self) -> bool:
        """Whether the block->shard assignment is settled (a "locality"
        one is decided by the first non-empty merge)."""
        return self._perm_decided

    @property
    def b_max_floor(self) -> int:
        """Monotonic halo width (padded boundary blocks per shard); growth
        is a "halo-widen" event of `StreamRunner`."""
        return self._b_max_floor

    @property
    def h_max_floor(self) -> int:
        """Monotonic per-vertex need-list padding (per shard pair), the
        vertex-granularity analogue of `b_max_floor`."""
        return self._h_max_floor

    @property
    def hub_pad_floor(self) -> int:
        """Monotonic replicated-hub-region length; growth is a
        "hub-promote" event of `StreamRunner`."""
        return self._hub_pad_floor

    @property
    def he_max_floor(self) -> int:
        """Monotonic vote-table length per shard."""
        return self._he_max_floor

    @property
    def deg_host(self) -> Optional[np.ndarray]:
        """The latest layout's padded outdegrees in storage order (host)."""
        return self._deg_host

    @property
    def hub_ids(self) -> Tuple[int, ...]:
        """The replicated hub set (storage ids; monotonic across deltas)."""
        return self._hub_ids

    def _round_e(self, need: int) -> int:
        return -(-max(need, 1) // self.edge_chunk) * self.edge_chunk

    def _fill(self, g: Graph, blk: int) -> int:
        """Rewrite original block ``blk``'s host slab row and row pointer in
        its storage row; returns that row."""
        row = self._storage_row(blk)
        fill_block_slab(g, blk, self.block_v, self._blk_dst, self._blk_row, self._blk_w,
                        out_blk=row, dst_map=self.o2s)
        sl = slice(row, row + 1)
        ptr = slab_row_ptr(self._blk_row[sl], self._blk_w[sl], self.block_v)
        check_integer_weights(self._blk_w[sl], ptr)
        self._row_ptr[row] = ptr[0]
        return row

    def apply(self, delta: EdgeDelta) -> Tuple[DeviceGraph, MergeInfo]:
        info = self.inc.apply(delta)
        g = self.inc.to_graph()
        self.graph = g
        self.upload_bytes = 0

        sizes = block_slab_sizes(g.adj_ptr, g.n, self.block_v, self._real_blocks)
        need = int(sizes.max()) if sizes.size else 0
        full = need > self.e_max or self.e_max == 0
        if full:
            # overflow: re-pad every slab with headroom
            self.e_max = self._round_e(int(need * self.e_headroom))
            self._blk_dst = np.zeros((self.n_blocks, self.e_max), dtype=np.int32)
            self._blk_row = np.zeros((self.n_blocks, self.e_max), dtype=np.int32)
            self._blk_w = np.zeros((self.n_blocks, self.e_max), dtype=np.float32)
            dirty = np.arange(self._real_blocks)
            info.repadded = True
        else:
            touched = info.touched_vertices
            dirty = np.unique(touched // self.block_v) if touched.size else np.empty(0, np.int64)
        rows = [self._fill(g, int(blk)) for blk in dirty]
        info.dirty_blocks = int(len(dirty))

        if not self._perm_decided and g.m > 0:
            # decide the stream's assignment from the first non-empty merge
            # (the slabs are still in natural order here), then rewrite
            # every slab into permuted storage once
            adj = block_adjacency(self._blk_dst, self._blk_w, self.block_v)
            self._perm_decided = True
            self._set_perm(locality_block_order(adj, self.mesh.n_shards))
            if self.block_perm is not None:
                for a in (self._blk_dst, self._blk_row, self._blk_w, self._row_ptr):
                    a[:] = 0
                for blk in range(self._real_blocks):
                    self._fill(g, blk)
                full = True
        self._upload(rows, full)
        return self._assemble(g), info

    def restore(self, dir_keys: np.ndarray, sym_keys: np.ndarray, sym_w: np.ndarray,
                blk_dst: np.ndarray, blk_row: np.ndarray, blk_w: np.ndarray,
                deltas_applied: int, *, block_perm: Optional[np.ndarray] = None,
                perm_decided: bool = True, floors: Optional[dict] = None,
                hub_ids=()) -> DeviceGraph:
        """Rebuild the state a checkpoint recorded: the sorted edge arrays,
        the host slabs in storage order (``e_max`` follows their width),
        the block permutation and whether it is decided, the halo plan's
        ``floors`` (``b_max`` / ``h_max`` / ``hub_pad`` / ``he_max``) and
        the hub set. The row pointer is derived from the slabs and the span
        plan from the row pointer, as every delta derives them; every slab
        is uploaded anew."""
        if blk_dst.shape[0] != self.n_blocks or not (
                blk_dst.shape == blk_row.shape == blk_w.shape):
            raise ValueError(
                f"stream checkpoint slab shapes {blk_dst.shape}/{blk_row.shape}/"
                f"{blk_w.shape} do not fit {self.n_blocks} blocks")
        inc = self.inc
        inc.dir_keys = dir_keys.astype(np.int64)
        inc.sym_keys = sym_keys.astype(np.int64)
        inc.sym_w = sym_w.astype(np.float32)
        inc.deltas_applied = deltas_applied
        self.upload_bytes = 0
        self.e_max = int(blk_dst.shape[1])
        self._blk_dst = blk_dst.astype(np.int32)
        self._blk_row = blk_row.astype(np.int32)
        self._blk_w = blk_w.astype(np.float32)
        self._row_ptr = slab_row_ptr(self._blk_row, self._blk_w, self.block_v)
        check_integer_weights(self._blk_w, self._row_ptr)
        if block_perm is not None:
            self._set_perm(block_perm)
        self._perm_decided = bool(perm_decided)
        floors = floors or {}
        self._b_max_floor = int(floors.get("b_max", 0))
        self._h_max_floor = int(floors.get("h_max", 0))
        self._hub_pad_floor = int(floors.get("hub_pad", 0))
        self._he_max_floor = int(floors.get("he_max", 0))
        self._hub_ids = tuple(int(h) for h in hub_ids)
        self.graph = inc.to_graph()
        self._upload([], True)
        return self._assemble(self.graph)

    def as_sharded(self, *, halo: bool = False,
                   halo_threshold: float = DEFAULT_HALO_THRESHOLD,
                   halo_granularity: str = "auto",
                   hubs: Optional[HubConfig] = None) -> ShardedDeviceGraph:
        """Wrap the latest layout for the sharded, halo and async schedules.

        The slabs are already mesh-aligned, permuted and resident on their
        shards' devices; this attaches the assignment (so carried labels and
        probabilities convert at the API boundary) and, for ``halo=True``,
        the exchange plan rebuilt from the current slabs (``halo_granularity``
        and ``hubs`` as in `build_halo_spec`). Every exchange shape is
        floored at its historical maximum (``b_max``, ``h_max``, the hub
        region ``hub_pad``, the vote table ``he_max``) and the hub set only
        grows; a plan that falls back to the full gather leaves the hub
        floors as they are, as in `repro`.
        """
        if self.mesh is None:
            raise ValueError("as_sharded needs a mesh-aligned layout")
        if self.device_graph is None:
            raise ValueError("no device layout yet; apply a delta first")
        n_shards = self.mesh.n_shards
        spec = None
        if halo:
            spec = build_halo_spec(
                self._blk_dst, self._blk_w, n_shards, self.block_v,
                threshold=halo_threshold, granularity=halo_granularity,
                b_max_floor=self._b_max_floor, h_max_floor=self._h_max_floor,
                hubs=hubs, deg=self._deg_host, vmask=self._vmask_host,
                blk_row=self._blk_row, hub_ids_floor=self._hub_ids,
                hub_pad_floor=self._hub_pad_floor, he_max_floor=self._he_max_floor)
            self._b_max_floor = spec.b_max
            self._h_max_floor = spec.h_max
            if not spec.fallback:
                self._hub_ids = tuple(int(h) for h in spec.hub_ids)
                self._hub_pad_floor = max(self._hub_pad_floor, spec.hub_pad)
                self._he_max_floor = max(self._he_max_floor, spec.he_max)
        dg = self.device_graph
        shards = _upload_shards(dg, self.mesh, spec, row_ptr=self._row_ptr,
                                slabs=self._shard_dev)
        self.upload_bytes += _fresh_bytes(shards, [dg] + list(self._shard_dev))
        return ShardedDeviceGraph(
            dg=dg, mesh=self.mesh, n_shards=n_shards,
            blocks_per_shard=self.n_blocks // n_shards, shards=shards,
            block_perm=(tuple(int(b) for b in self.block_perm)
                        if self.block_perm is not None else None),
            o2s=self.o2s, s2o=self.s2o, o2s_t=self._o2s_t, s2o_t=self._s2o_t, halo=spec)

    def _assemble(self, g: Graph) -> DeviceGraph:
        """The `DeviceGraph` of the resident slabs and row pointer, with the
        span plan derived from the host row pointer and ``g``'s per-vertex
        arrays and flat edges uploaded (in storage order: per-vertex arrays
        follow their block, vertex ids go through ``o2s``, as
        `permute_blocks` rewrites a static layout)."""
        dev = self.device
        host = vertex_arrays(g, self.n_pad)
        if self.block_perm is not None:
            perm, nb, bv = self.block_perm, self.n_blocks, self.block_v
            for f in _VERTEX_FIELDS:
                host[f] = host[f].reshape(nb, bv)[perm].reshape(-1)
            for f in ("dir_src", "dir_dst"):
                host[f] = self.o2s[host[f]]
        self._deg_host, self._vmask_host = host["deg_out"], host["vmask"]
        vert = {f: torch.from_numpy(np.ascontiguousarray(a)).to(dev) for f, a in host.items()}
        spans = SpanPlan.from_row_ptr(self._row_ptr, dev)
        self.upload_bytes += sum(t.nbytes for t in vert.values()) + sum(
            t.nbytes for t in (spans.spans, spans.hubs))
        self.device_graph = DeviceGraph(
            n=g.n, n_pad=self.n_pad, m=g.m, n_blocks=self.n_blocks,
            block_v=self.block_v, e_max=self.e_max, blk_spans=spans, **self._dev, **vert)
        return self.device_graph

    def _upload(self, rows, full: bool) -> None:
        """Bring the resident slabs and row pointer up to the host's: all
        of them after a re-pad (or the assignment's one-time rewrite), else
        the given storage rows, each on the home device and, when its
        shard sits on another device, on that shard's copy too."""
        dev = self.device
        host = {"blk_dst": self._blk_dst, "blk_row": self._blk_row,
                "blk_w": self._blk_w, "blk_row_ptr": self._row_ptr}
        devices = self.mesh.devices if self.mesh is not None else (dev,)
        bps = self.n_blocks // len(devices)
        if full:
            self._dev = {f: torch.from_numpy(a).to(dev) for f, a in host.items()}
            self.upload_bytes += sum(a.nbytes for a in host.values())
            self._shard_dev = []
            for s, sdev in enumerate(devices):
                blocks = slice(s * bps, (s + 1) * bps)
                own = {f: t[blocks] if sdev == dev else t[blocks].to(sdev)
                       for f, t in self._dev.items()}
                if sdev != dev:
                    self.upload_bytes += sum(t.nbytes for t in own.values())
                self._shard_dev.append(own)
            return
        for row in rows:
            s = row // bps
            for f, a in host.items():
                src = torch.from_numpy(a[row])
                self._dev[f][row].copy_(src)
                self.upload_bytes += src.nbytes
                if devices[s] != dev:
                    self._shard_dev[s][f][row - s * bps].copy_(src)
                    self.upload_bytes += src.nbytes


def _fresh_bytes(shards, resident) -> int:
    """Bytes of the tensors in ``shards`` that are not (views of) the
    ``resident`` layouts' tensors: what building them uploaded."""
    def storages(tensors):
        return {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors if isinstance(t, torch.Tensor)}

    def fields(obj):
        if obj is None:
            return []
        if isinstance(obj, dict):
            return list(obj.values())
        out = []
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, SpanPlan):
                out += [v.spans, v.hubs]
            elif dataclasses.is_dataclass(v):
                out += fields(v)
            else:
                out.append(v)
        return out

    old = {}
    for r in resident:
        old.update(storages(fields(r)))
    new = {}
    for sh in shards:
        new.update(storages(fields(sh)))
    return sum(n for p, n in new.items() if p not in old)
