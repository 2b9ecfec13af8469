"""Sharding rules: param/batch/cache trees -> spec trees, and the split of a
tree into per-rank shards.

The port's copy of `repro.parallel.sharding`. Logical plan, mesh axes
("pod",)+"data"+"model":
  * batch            -> ("pod","data") = the DP axes (when divisible)
  * vocab / heads / FFN hidden / experts / SSM channels -> "model"
  * megatron pairs: column-parallel in-projections (None,"model"),
    row-parallel out-projections ("model",None) — one all-reduce per block
  * decode caches: KV heads -> "model" when divisible, else cache seq ->
    "model" (flash-decode over the sharded seq axis:
    `repro_torch.parallel.collectives.sharded_decode_attention`)
  * long_500k (batch=1): cache seq -> "data" as well

Stacked layer params ([L, ...]) get leading None axes by stack depth of
their top-level collection.

The functions take trees in `repro`'s layout: nested dicts, tuples and
lists whose leaves have a ``.shape``. For parameters that is
`repro_torch.models.convert.lm_params_to_tree` of a model, or
`param_shapes` for a full-size config (a fake-tensor init: nothing is
allocated); the port's caches already carry `repro`'s cache names and
nesting. A spec is a `P`, a tuple of entries (None, an axis name or a
tuple of names) that compares equal, entry by entry, to `repro`'s
``PartitionSpec``. The meshes are `repro_torch.launch.mesh.LMMesh`es
(or anything with ``shape`` and ``axis_names``).

`shard_tree` is the port's counterpart of ``device_put(x,
NamedSharding(mesh, spec))``: it splits each leaf along its spec'd axes
into one tensor a rank, on the rank's device (a view where that device is
the leaf's own); `unshard_tree` puts the pieces back together.
"""
from __future__ import annotations

import math
import re
from typing import Callable, List

import torch

# stack depth of each top-level param collection (leading stacked axes)
_STACK_DEPTH = {
    "blocks": 1, "dense_blocks": 1, "enc_blocks": 1, "dec_blocks": 1,
    "trailing": 1, "mamba": 2, "lora": 1,
}

# ordered (regex on "a/b/c" path, base spec for the unstacked param)
_RULES = [
    (r"(embed|unembed)/emb$", ("model", None)),
    (r"dec_pos$", (None, None)),
    # attention projections (megatron column/row)
    (r"(wq|wk|wv|wq_b|wk_b|wv_b)/w$", (None, "model")),
    (r"(wq|wk|wv|wq_b|wk_b|wv_b)/b$", ("model",)),
    (r"wo/w$", ("model", None)),
    (r"wo/b$", (None,)),
    (r"(wq_a|wkv_a)/w$", (None, None)),          # low-rank stems: replicated
    # dense mlp
    (r"(w_gate|w_up)/w$", (None, "model")),
    (r"(w_gate|w_up)/b$", ("model",)),
    (r"w_down/w$", ("model", None)),
    (r"w_down/b$", (None,)),
    # moe (expert-parallel over "model"; raw [E, ...] arrays)
    (r"moe/(w_gate|w_up|w_down)$", ("model", None, None)),
    (r"router/w$", (None, None)),
    # mamba2 (split projections; B/C/dt replicated per SSD TP)
    (r"(in_z|in_x)/w$", (None, "model")),
    (r"(in_bc|in_dt)/w$", (None, None)),
    (r"conv_w_x$", (None, "model")),
    (r"conv_b_x$", ("model",)),
    (r"conv_w_bc$", (None, None)),
    (r"conv_b_bc$", (None,)),
    (r"(A_log|D|dt_bias)$", ("model",)),
    (r"mix/norm/g$", ("model",)),                # gated-rmsnorm over d_inner
    (r"out_proj/w$", ("model", None)),
    # rwkv6 time mix
    (r"time/(wr|wk|wv|wg)/w$", (None, "model")),
    (r"time/wo/w$", ("model", None)),
    (r"time/w0$", ("model",)),
    (r"decay_w2$", (None, "model")),
    (r"time/u$", ("model", None)),
    (r"ln_x/(g|b)$", ("model",)),
    # rwkv6 channel mix
    (r"chan/wk/w$", (None, "model")),
    (r"chan/wv/w$", ("model", None)),
    (r"chan/wr/w$", (None, None)),
    # zamba2 shared block extras
    (r"shared/out/w$", ("model", None)),
    (r"lora/(q|k|v)/a$", (None, None)),
    (r"lora/(q|k|v)/b$", (None, "model")),
]


class P(tuple):
    """A partition spec: one entry a tensor axis, None (replicated), an axis
    name or a tuple of names (the first major). A 1-tuple entry shards as its
    name does and is stored as the name, as `repro`'s ``PartitionSpec``
    stores it, so the two compare equal entry by entry."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _is_node(x) -> bool:
    return isinstance(x, (dict, list)) or (isinstance(x, tuple) and not isinstance(x, P))


def tree_map_with_path(fn: Callable, tree, *rest):
    """``fn(path, leaf, *rest_leaves)`` over the leaves of nested dicts,
    tuples and lists (a `P` is a leaf), keeping the nesting; ``path`` is
    the tuple of keys and indices from the root."""
    def walk(path, node, *others):
        if isinstance(node, dict):
            return {k: walk(path + (k,), v, *(o[k] for o in others)) for k, v in node.items()}
        if _is_node(node):
            return type(node)(walk(path + (i,), v, *(o[i] for o in others))
                              for i, v in enumerate(node))
        return fn(path, node, *others)
    return walk((), tree, *rest)


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _base_spec(path_str: str):
    for rx, spec in _RULES:
        if re.search(rx, path_str):
            return spec
    return ()


def _names(part) -> tuple:
    return part if isinstance(part, tuple) else (part,)


def _size(mesh, part) -> int:
    return math.prod(int(mesh.shape[n]) for n in _names(part))


def param_specs(params_shape, *, cfg=None, mesh=None, moe_ep2d: bool = False):
    """Tree of `P` matching a params tree (or `param_shapes` of a config).

    When cfg/mesh are given, attention projections whose HEAD COUNT does
    not divide the model-axis size are replicated instead of column-
    sharded (Megatron GQA rule: a fractional head per device would force a
    re-gather of K/V each layer — replicating small-n_kv projections is
    strictly cheaper). Applies to q as well (internvl's 14 heads,
    whisper's 8, vs model=16). An axis whose mesh size does not divide the
    leaf's dimension is dropped (replicated). ``moe_ep2d`` stores the
    routed experts over ("pod", "model").
    """
    msz = int(mesh.shape.get("model", 1)) if mesh is not None else 1

    def heads_ok(ps: str) -> bool:
        if cfg is None or msz == 1:
            return True
        if re.search(r"(wq|wq_b)/[wb]$", ps):
            return cfg.n_heads % msz == 0
        if re.search(r"(wk|wv|wk_b|wv_b)/[wb]$", ps):
            n_kv = cfg.n_kv or cfg.n_heads
            return n_kv % msz == 0
        if re.search(r"wo/w$", ps):
            return cfg.n_heads % msz == 0
        return True

    def leaf_spec(path, leaf):
        ps = _path_str(path)
        top = ps.split("/", 1)[0]
        depth = _STACK_DEPTH.get(top, 0)
        base = _base_spec(ps)
        if not heads_ok(ps):
            base = ()
        if moe_ep2d and re.search(r"moe/(w_gate|w_up|w_down)$", ps):
            base = (("pod", "model"), None, None)   # cross-pod EP storage
        spec = (None,) * depth + tuple(base)
        nd = len(leaf.shape)
        spec = list((spec + (None,) * nd)[:nd])
        if mesh is not None:    # auto-repair: drop non-dividing axes
            for ax, part in enumerate(spec):
                if part is not None and leaf.shape[ax] % _size(mesh, part):
                    spec[ax] = None   # e.g. whisper's vocab 51865 vs 16
        return P(*spec)

    return tree_map_with_path(leaf_spec, params_shape)


def dp_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _dp_size(mesh) -> int:
    return math.prod(int(mesh.shape[a]) for a in dp_axes(mesh))


def batch_specs(batch_shape, mesh):
    """Shard the leading batch axis over the DP axes when divisible."""
    dp = dp_axes(mesh)
    dsz = _dp_size(mesh)

    def leaf_spec(path, leaf):
        nd = len(leaf.shape)
        if leaf.shape and leaf.shape[0] % dsz == 0:
            return P(*((dp,) + (None,) * (nd - 1)))
        return P(*((None,) * nd))

    return tree_map_with_path(leaf_spec, batch_shape)


def _model_size(mesh) -> int:
    return int(mesh.shape.get("model", 1))


def cache_specs(cfg, cache_shape, mesh):
    """Decode-cache sharding (see module docstring)."""
    dp = dp_axes(mesh)
    dsz = _dp_size(mesh)
    msz = _model_size(mesh)

    def leaf_spec(path, leaf):
        ps = _path_str(path)
        shape = leaf.shape
        nd = len(shape)
        top = ps.split("/", 1)[0]
        if top == "pos":
            return P(dp) if shape and shape[0] % dsz == 0 else P(None)
        spec = [None] * nd

        if top in ("main", "dense", "self", "cross", "kv"):
            if nd == 5:          # gqa KV: [L, B, H, S, D]
                b_ax, h_ax, s_ax = 1, 2, 3
            elif nd == 4:        # mla latent: [L, B, S, R]
                b_ax, h_ax, s_ax = 1, None, 2
            else:
                return P(*spec)
            batch_ok = shape[b_ax] % dsz == 0
            if batch_ok:
                spec[b_ax] = dp
            if h_ax is not None and shape[h_ax] % msz == 0:
                spec[h_ax] = "model"
            elif shape[s_ax] % msz == 0:
                spec[s_ax] = "model"           # flash-decode over seq shards
            if not batch_ok and spec[s_ax] is None and shape[s_ax] % dsz == 0:
                spec[s_ax] = dp                 # long-context: seq over data
            elif not batch_ok and spec[s_ax] == "model" and \
                    shape[s_ax] % (dsz * msz) == 0:
                spec[s_ax] = ("model",) + dp   # seq over both
            return P(*spec)

        if top in ("ssm", "trail_ssm"):
            # [*stack, B, ...states]; stack depth 2 for grouped, 1 trailing
            b_ax = 2 if top == "ssm" else 1
            if shape[b_ax] % dsz == 0:
                spec[b_ax] = dp
            # shard head/channel axis (first axis after batch) over model
            if nd > b_ax + 1 and shape[b_ax + 1] % msz == 0:
                spec[b_ax + 1] = "model"
            return P(*spec)

        if top == "wkv":                        # [L, B, H, N, N]
            if shape[1] % dsz == 0:
                spec[1] = dp
            if shape[2] % msz == 0:
                spec[2] = "model"
            return P(*spec)

        if top in ("x_time", "x_chan"):         # [L, B, 1, d]
            if shape[1] % dsz == 0:
                spec[1] = dp
            return P(*spec)

        if top == "h0":                         # [B, 1, d]
            if shape[0] % dsz == 0:
                spec[0] = dp
            return P(*spec)

        return P(*spec)

    return tree_map_with_path(leaf_spec, cache_shape)


def zero_dp_specs(specs, shapes, mesh):
    """ZeRO-style extension: additionally shard large leaves over "data"
    on the first free, divisible axis (used for optimizer moments and the
    fp32 master copy)."""
    dsz = int(mesh.shape.get("data", 1))

    def extend(path, spec, leaf):
        shape = tuple(leaf.shape)
        if math.prod(shape or (1,)) < (1 << 20):
            return spec
        parts = list(spec) + [None] * (len(shape) - len(spec))
        for ax, dim in enumerate(shape):
            if parts[ax] is None and dim % dsz == 0:
                parts[ax] = "data"
                return P(*parts)
        return spec

    return tree_map_with_path(extend, specs, shapes)


def validate_specs(specs, shapes, mesh) -> List[str]:
    """Return a list of leaves whose spec doesn't divide the shape."""
    bad = []

    def check(path, spec, leaf):
        for ax, part in enumerate(spec):
            if part is not None and leaf.shape[ax] % _size(mesh, part):
                bad.append(f"{_path_str(path)}: {tuple(leaf.shape)} vs {spec}")

    tree_map_with_path(check, specs, shapes)
    return bad


def param_shapes(cfg) -> dict:
    """`repro`'s parameter tree of ``cfg`` at its full size with fake-tensor
    leaves (shapes and dtypes; no storage): the port's init run under
    `FakeTensorMode`, stacked by `convert.lm_params_to_tree`."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import init_lm
    from repro_torch.models.convert import lm_params_to_tree

    with FakeTensorMode():
        model = init_lm(cfg, torch.Generator(device="cpu"), "cpu")
        return lm_params_to_tree(model)


# --------------------------------------------------------------------------
# per-rank shards
# --------------------------------------------------------------------------
def _shard(x: torch.Tensor, spec, mesh, rank: int, dev: torch.device) -> torch.Tensor:
    """Rank ``rank``'s piece of ``x`` under ``spec``: each spec'd axis cut
    into equal parts, the rank's index along the entry's mesh axes picking
    one (`narrow`: a view), then moved to ``dev`` (a copy only if ``dev``
    is not ``x``'s device)."""
    for ax, part in enumerate(spec):
        if part is None:
            continue
        n = _size(mesh, part)
        if x.shape[ax] % n:
            raise ValueError(f"axis {ax} of {tuple(x.shape)} does not split {n} ways ({spec})")
        chunk = x.shape[ax] // n
        x = x.narrow(ax, mesh.axis_index(rank, part) * chunk, chunk)
    return x if x.device == dev else x.to(dev)


def shard_tree(tree, specs, mesh) -> list:
    """One tree a rank (rank order, `LMMesh` row-major): each leaf split
    along its spec'd axes, the rank's piece on its device. A piece on the
    leaf's own device is a view of it, not a copy."""
    return [tree_map_with_path(lambda _, x, s, r=r: _shard(x, s, mesh, r, mesh.device_of(r)),
                               tree, specs)
            for r in range(mesh.n_ranks)]


def unshard_tree(shards: list, specs, mesh, *, device=None):
    """The inverse of `shard_tree`: each leaf put back together from the
    ranks' pieces (on ``device``, default rank 0's), concatenated along its
    spec'd axes; along a mesh axis the spec replicates over, the piece of
    index 0 is taken."""
    dev = mesh.device_of(0) if device is None else torch.device(device)

    def join(path, spec):
        def leaf(rank):
            node = shards[rank]
            for k in path:
                node = node[k]
            return node

        def build(ax: int, coords: dict):
            while ax < len(spec) and spec[ax] is None:
                ax += 1
            if ax == len(spec):
                return leaf(mesh.rank_of(**coords)).to(dev)
            names = _names(spec[ax])
            parts = []
            for flat in range(_size(mesh, spec[ax])):
                sub = dict(coords)
                for name in reversed(names):
                    flat, sub[name] = divmod(flat, int(mesh.shape[name]))
                parts.append(build(ax + 1, sub))
            return torch.cat(parts, dim=ax)

        return build(0, {})

    return tree_map_with_path(join, specs)


__all__ = ["P", "param_specs", "batch_specs", "cache_specs", "zero_dp_specs",
           "validate_specs", "dp_axes", "param_shapes", "shard_tree", "unshard_tree",
           "tree_map_with_path"]
