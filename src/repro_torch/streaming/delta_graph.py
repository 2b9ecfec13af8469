"""Incremental graph state: merge edge deltas without a full host rebuild.

The port of `repro.streaming.delta_graph` for one device and the contiguous
block assignment. Three structures are maintained across deltas:

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

The vertex space is declared up front (`n`): vertices materialize
implicitly as edges touch them and contribute nothing while isolated.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device_graph import (
    DeviceGraph,
    SpanPlan,
    resolve_device,
    vertex_arrays,
)
from repro_torch.graphs.blocking import (
    block_slab_sizes,
    check_integer_weights,
    fill_block_slab,
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

_ITEM9 = "queue 1 item 9, slice B (the stream's sharded layouts)"


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
    """Pads an evolving graph into a `DeviceGraph` on one device.

    `apply(delta)` merges the delta (`IncrementalGraph`) and returns a
    `DeviceGraph` whose slabs stay resident on the device across deltas:
    without a re-pad only the slab rows of blocks owning a touched vertex
    are rewritten and copied up, with their `blk_row_ptr` rows; the span
    plan (`blk_spans`) is derived anew from the whole row pointer every
    delta, so it always follows the slabs. An `e_max` overflow re-pads
    every slab with headroom into newly allocated device slabs. The flat
    directed edges (`dir_src` / `dir_dst`) and the per-vertex arrays are
    uploaded every delta, as `repro` does.

    **Aliasing:** the returned `DeviceGraph` shares its slabs and row
    pointer with the next delta's (until a re-pad), which rewrites them in
    place: hold only the latest one, as `StreamRunner` does.

    Only the contiguous block assignment on one device is ported: `mesh=`,
    another `assignment` and `as_sharded` raise NotImplementedError (ROADMAP
    queue 1 item 9, slice B).
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
        assignment="contiguous",
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                f"IncrementalDeviceGraph(mesh=...) is not ported yet; it comes "
                f"with ROADMAP {_ITEM9}")
        if not (isinstance(assignment, str) and assignment == "contiguous"):
            raise NotImplementedError(
                f"IncrementalDeviceGraph(assignment={assignment!r}) is not ported "
                f"yet; it comes with ROADMAP {_ITEM9}")
        self.device = resolve_device(device)
        self.inc = IncrementalGraph(n)
        n_blocks = max(1, min(n_blocks, n))
        block_v = -(-n // n_blocks)
        block_v = -(-block_v // block_multiple) * block_multiple
        self.block_v = block_v
        self.n_blocks = -(-n // block_v)
        self.n_pad = self.n_blocks * block_v
        self.edge_chunk = edge_chunk
        self.e_headroom = float(e_headroom)
        self.e_max = 0
        # host copies of the slabs (each delta rewrites the dirty rows here
        # first) and of the row pointer
        self._blk_dst = np.zeros((self.n_blocks, 0), dtype=np.int32)
        self._blk_row = np.zeros((self.n_blocks, 0), dtype=np.int32)
        self._blk_w = np.zeros((self.n_blocks, 0), dtype=np.float32)
        self._row_ptr = np.zeros((self.n_blocks, block_v + 1), dtype=np.int32)
        # the device-resident slabs and row pointer
        self._dev: dict = {}
        self.graph: Optional[Graph] = None
        self.device_graph: Optional[DeviceGraph] = None

    @property
    def n(self) -> int:
        return self.inc.n

    def as_sharded(self, **kwargs):
        raise NotImplementedError(
            f"IncrementalDeviceGraph.as_sharded is not ported yet; it comes with "
            f"ROADMAP {_ITEM9}")

    def _round_e(self, need: int) -> int:
        return -(-max(need, 1) // self.edge_chunk) * self.edge_chunk

    def _fill(self, g: Graph, blk: int):
        """Rewrite block ``blk``'s host slab row and row pointer."""
        fill_block_slab(g, blk, self.block_v, self._blk_dst, self._blk_row, self._blk_w)
        sl = slice(blk, blk + 1)
        ptr = slab_row_ptr(self._blk_row[sl], self._blk_w[sl], self.block_v)
        check_integer_weights(self._blk_w[sl], ptr)
        self._row_ptr[blk] = ptr[0]

    def apply(self, delta: EdgeDelta) -> Tuple[DeviceGraph, MergeInfo]:
        info = self.inc.apply(delta)
        g = self.inc.to_graph()
        self.graph = g

        sizes = block_slab_sizes(g.adj_ptr, g.n, self.block_v, self.n_blocks)
        need = int(sizes.max()) if sizes.size else 0
        if need > self.e_max or self.e_max == 0:
            # overflow: re-pad every slab with headroom
            self.e_max = self._round_e(int(need * self.e_headroom))
            self._blk_dst = np.zeros((self.n_blocks, self.e_max), dtype=np.int32)
            self._blk_row = np.zeros((self.n_blocks, self.e_max), dtype=np.int32)
            self._blk_w = np.zeros((self.n_blocks, self.e_max), dtype=np.float32)
            dirty = np.arange(self.n_blocks)
            info.repadded = True
        else:
            touched = info.touched_vertices
            dirty = np.unique(touched // self.block_v) if touched.size else np.empty(0, np.int64)
        for blk in dirty:
            self._fill(g, int(blk))
        info.dirty_blocks = int(len(dirty))
        self._upload(dirty, info.repadded)
        return self._assemble(g), info

    def restore(self, dir_keys: np.ndarray, sym_keys: np.ndarray, sym_w: np.ndarray,
                blk_dst: np.ndarray, blk_row: np.ndarray, blk_w: np.ndarray,
                deltas_applied: int) -> DeviceGraph:
        """Rebuild the state a checkpoint recorded: the sorted edge arrays
        and the host slabs (``e_max`` follows their width). The row pointer
        is derived from the slabs and the span plan from the row pointer,
        as every delta derives them; every slab is uploaded anew."""
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
        self.e_max = int(blk_dst.shape[1])
        self._blk_dst = blk_dst.astype(np.int32)
        self._blk_row = blk_row.astype(np.int32)
        self._blk_w = blk_w.astype(np.float32)
        self._row_ptr = slab_row_ptr(self._blk_row, self._blk_w, self.block_v)
        check_integer_weights(self._blk_w, self._row_ptr)
        self.graph = inc.to_graph()
        self._upload(np.arange(self.n_blocks), True)
        return self._assemble(self.graph)

    def _assemble(self, g: Graph) -> DeviceGraph:
        """The `DeviceGraph` of the device slabs and row pointer, with the
        span plan derived from the host row pointer and ``g``'s per-vertex
        arrays uploaded."""
        dev = self.device
        vert = {f: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for f, a in vertex_arrays(g, self.n_pad).items()}
        self.device_graph = DeviceGraph(
            n=g.n, n_pad=self.n_pad, m=g.m, n_blocks=self.n_blocks,
            block_v=self.block_v, e_max=self.e_max,
            blk_spans=SpanPlan.from_row_ptr(self._row_ptr, dev),
            **self._dev, **vert)
        return self.device_graph

    def _upload(self, dirty: np.ndarray, repadded: bool) -> None:
        """Bring the device slabs and row pointer up to the host's: all of
        them after a re-pad, else the dirty blocks' rows."""
        dev = self.device
        host = {"blk_dst": self._blk_dst, "blk_row": self._blk_row,
                "blk_w": self._blk_w, "blk_row_ptr": self._row_ptr}
        if repadded:
            self._dev = {f: torch.from_numpy(a).to(dev) for f, a in host.items()}
        else:
            for blk in dirty:
                for f, a in host.items():
                    self._dev[f][blk].copy_(torch.from_numpy(a[blk]))
