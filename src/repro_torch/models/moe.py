"""Mixture-of-Experts layer (DeepSeek-V2 style: shared + routed top-k).

The counterpart of `repro.models.moe`: the single-device path
(``_apply_moe_local``) and, under a mesh context
(`repro_torch.parallel.act_sharding`), the expert-parallel paths.
Dispatch is sort-based ("dropless-with-capacity"):
the [T*K] (token, choice) pairs are sorted by expert id (a stable sort),
each expert takes up to C slots (capacity factor over the mean load) in
that order, overflow is dropped. The [E, C, d] buffer is filled by a
gather (slot (e, c) reads the c-th pair of expert e's run), the experts
run as batched products over E, and the combine puts each pair's gated
output back in (token, choice) order (zeros for a dropped pair) and sums
the K choices of a token in a fixed order. Nothing scatters with
duplicate indices and nothing adds with atomics, so two calls on the card
are bit-equal; `repro` combines with ``.at[token_of].add`` in sorted-pair
order instead, which differs from the port's sum by rounding only.

The router's per-expert load, drop count, mean probabilities and picks
come back with ``return_stats`` (``top_idx`` is the input of the expert
placement, `repro_torch.core.placement`).

Expert parallelism (`apply_moe`'s dispatch selection is `repro`'s) runs
over an `LMMesh` driven by one process, each rank's parameters cut from
the layer's by `repro_torch.parallel.sharding.shard_tree` (views on the
layer's own device):

  _apply_moe_shardmap  each (data, model) rank takes its data rank's batch
                       rows and its E/model experts, packs its own pairs
                       (capacity from its own token count) and adds its
                       share of the shared experts (Megatron split); a
                       psum over the model ranks completes the layer
  _apply_moe_ep2d      experts over pod x model: each rank packs its pairs
                       per destination pod, the pods swap those buffers
                       (an index move between the ranks' buffers in place
                       of `repro`'s ``all_to_all``), each rank runs its
                       experts on what it received (`_dispatch_local`),
                       the model ranks psum, and the results move back

The psums run in rank order in f64 (`repro_torch.parallel.collectives.psum`)
and round once; the combine stays the gather-and-sum above. While
`record_dispatch` is active every call records its path and its drops.
"""
from __future__ import annotations

import contextlib
import dataclasses
from types import SimpleNamespace

import torch
from torch import nn

from repro_torch.models.common import Dense, _normal, _param, swiglu
from repro_torch.models.mlp import MLP, apply_mlp, init_mlp
from repro_torch.parallel.act_sharding import get_ctx
from repro_torch.parallel.collectives import _to, psum
from repro_torch.parallel.sharding import P, _dp_size, dp_axes, shard_tree


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    n_experts: int             # routed experts
    top_k: int
    d_ff_expert: int
    n_shared: int = 0          # shared experts (always active)
    capacity_factor: float = 1.25
    norm_topk: bool = False    # renormalize top-k gates to sum to 1
    routed_scale: float = 1.0  # DeepSeek routed_scaling_factor


class MoE(nn.Module):
    """``router.w`` [d, E] f32, ``w_gate``/``w_up`` [E, d, f] and ``w_down``
    [E, f, d] (raw tensors, as `repro` keeps them), and the optional shared
    `MLP` of ``n_shared * f`` hidden units."""

    def __init__(self, router: Dense, w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, shared: MLP | None = None):
        super().__init__()
        self.router = router
        self.w_gate, self.w_up, self.w_down = _param(w_gate), _param(w_up), _param(w_down)
        self.shared = shared


def init_moe(gen: torch.Generator, spec: MoESpec, dtype) -> MoE:
    scale = 1.0 / (spec.d_model ** 0.5)
    e, d, f = spec.n_experts, spec.d_model, spec.d_ff_expert
    router = Dense(_normal(gen, (d, e), scale, torch.float32))
    w_gate = _normal(gen, (e, d, f), scale, dtype)
    w_up = _normal(gen, (e, d, f), scale, dtype)
    w_down = _normal(gen, (e, f, d), 1.0 / (f ** 0.5), dtype)
    shared = init_mlp(gen, d, f * spec.n_shared, dtype) if spec.n_shared else None
    return MoE(router, w_gate, w_up, w_down, shared)


def _route(p_router: Dense, x2d: torch.Tensor, spec: MoESpec):
    """x2d [T, d] -> (gates [T, K] f32, the picked experts [T*K] int64 in
    (token, choice) order, the probabilities in descending order [T, E]
    f32, their experts [T, E] int64).

    The logits are sorted first (stable: equal logits keep the lower
    expert first, as ``jax.lax.top_k`` breaks ties) and the softmax runs on
    the sorted row, so its sum takes the exponentials in sorted order: a
    permutation of the experts (an expert placement,
    `repro_torch.core.placement.apply_placement`) then permutes the
    probabilities exactly, and a placed layer routes, drops and combines
    as the unplaced one does, bit for bit. A softmax over the unsorted row
    sums in memory order, which rounds differently once the experts move.
    The top K are the sorted row's first K."""
    logits = x2d.float() @ p_router.w                              # [T, E]
    logits, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    probs = torch.softmax(logits, dim=-1)
    gates = probs[:, :spec.top_k]
    if spec.norm_topk:
        gates = gates / gates.sum(-1, keepdim=True)
    if spec.routed_scale != 1.0:        # x * 1.0 is x: a launch saved
        gates = gates * spec.routed_scale
    return gates, order[:, :spec.top_k].reshape(-1), probs, order


def _unsort(probs: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """The sorted probabilities back in expert order."""
    return torch.scatter(torch.empty_like(probs), -1, order, probs)


def route(p_router: Dense, x2d: torch.Tensor, spec: MoESpec):
    """x2d [T, d] -> (gates [T, K] f32, idx [T, K] int32, probs [T, E] f32)
    (`_route`: the softmax of the sorted logits)."""
    gates, flat, probs, order = _route(p_router, x2d, spec)
    return gates, flat.view(-1, spec.top_k).to(torch.int32), _unsort(probs, order)


def moe_capacity(n_tokens: int, spec: MoESpec) -> int:
    c = int(n_tokens * spec.top_k * spec.capacity_factor / spec.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


_RECORDS: list | None = None


@contextlib.contextmanager
def record_dispatch():
    """While active, every `apply_moe` call appends ``{"path": "local" |
    "shardmap" | "ep2d", "dropped": 0-dim int64 tensor}`` (pairs dropped
    at a capacity, over all ranks) to the list it yields."""
    global _RECORDS
    prev, _RECORDS = _RECORDS, []
    try:
        yield _RECORDS
    finally:
        _RECORDS = prev


def _record(path: str, dropped: torch.Tensor) -> None:
    if _RECORDS is not None:
        _RECORDS.append({"path": path, "dropped": dropped})


def apply_moe(p: MoE, x: torch.Tensor, spec: MoESpec, *, return_stats: bool = False):
    """x [B, S, d] (or [T, d]) -> same shape; with ``return_stats`` also
    ``{"expert_load" [E] f32, "dropped" (0-dim int64), "router_probs_mean"
    [E] f32, "top_idx" [T, K] int32}``.

    Dispatch selection (`repro`'s): under a mesh context and without
    ``return_stats``, the cross-pod path when ``ctx.moe_ep2d``, pod > 1 and
    E divides by pod·model; else the expert-parallel path when
    ``ctx.moe_shardmap``, model > 1 and E divides by model; else the
    single-device path."""
    ctx = get_ctx()
    if ctx is not None and not return_stats:
        mesh = ctx.mesh
        psz = int(mesh.shape.get("pod", 1))
        msz = int(mesh.shape.get("model", 1))
        if ctx.moe_ep2d and psz > 1 and spec.n_experts % (psz * msz) == 0:
            return _apply_moe_ep2d(p, x, spec, mesh)
        if ctx.moe_shardmap and msz > 1 and spec.n_experts % msz == 0:
            return _apply_moe_shardmap(p, x, spec, mesh)
    return _apply_moe_local(p, x, spec, return_stats=return_stats)


def _pair_dispatch(x2, key, k: int, e_loc: int, cap: int, wg, wu, wd, *,
                   foreign: bool = False):
    """Sort-pack N (row, choice) pairs onto ``e_loc`` experts and run them.

    ``key`` [N] int64 holds each pair's expert id relative to this rank;
    with ``foreign``, a key of ``e_loc`` marks another rank's pair (it sorts
    last and is never kept; `_foreign_key`). Pair i reads row ``i // k`` of
    ``x2``. Expert j takes the first ``cap`` of its pairs in stable sorted
    order. Returns (each pair's expert output [N, d] in pair order, 0 where
    it was not kept; ``keep`` [N] bool in pair order; ``count`` [e_loc]
    pairs routed to each expert)."""
    n, d = key.shape[0], x2.shape[1]
    dev = x2.device
    order = torch.argsort(key, stable=True)                       # [N]
    sorted_e = key[order]
    experts = torch.arange(e_loc + 1 if foreign else e_loc, device=dev)
    seg_start = torch.searchsorted(sorted_e, experts)
    count = (torch.searchsorted(sorted_e, experts, right=True) - seg_start)[:e_loc]
    pos = torch.arange(n, device=dev) - seg_start[sorted_e]
    keep = pos < cap
    if foreign:
        keep = keep & (sorted_e < e_loc)
    slot = torch.where(keep, sorted_e * cap + pos, 0)             # a drop reads slot 0

    # slot (e, c) holds expert e's c-th pair in sorted order, if it has one
    c_idx = torch.arange(cap, device=dev)
    filled = c_idx[None, :] < count[:, None]                      # [e_loc, C]
    src = torch.clamp(seg_start[:e_loc, None] + c_idx[None, :], max=n - 1)
    h = torch.where(filled[..., None], x2[order[src] // k], 0)    # [e_loc, C, d]

    # ---- expert computation (batched over the experts) ----------------------
    act = swiglu(torch.bmm(h, wg), torch.bmm(h, wu))
    out = torch.bmm(act, wd).reshape(e_loc * cap, d)

    # ---- back to pair order -------------------------------------------------
    pair_slot = torch.empty_like(slot)
    pair_slot[order] = slot
    pair_keep = torch.empty_like(keep)
    pair_keep[order] = keep
    return torch.where(pair_keep[:, None], out[pair_slot], 0), pair_keep, count


def _foreign_key(rel: torch.Tensor, e_loc: int) -> torch.Tensor:
    """Rank-relative expert ids -> `_pair_dispatch`'s keys with
    ``foreign``: an id outside [0, e_loc) (another rank's) becomes e_loc."""
    return torch.where((rel >= 0) & (rel < e_loc), rel, e_loc)


def _combine(out: torch.Tensor, gates: torch.Tensor, t: int, k: int) -> torch.Tensor:
    """Gate each (token, choice) output and sum a token's K choices in
    order: [T*K, d] -> [T, d]."""
    contrib = out * gates.to(out.dtype).reshape(-1, 1)
    return contrib.reshape(t, k, out.shape[-1]).sum(dim=1)


def _apply_moe_local(p: MoE, x: torch.Tensor, spec: MoESpec, *, return_stats: bool = False):
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    t = x2.shape[0]
    e, k = spec.n_experts, spec.top_k
    gates, flat, probs, order = _route(p.router, x2, spec)
    out, keep, count = _pair_dispatch(x2, flat, k, e, moe_capacity(t, spec),
                                      p.w_gate, p.w_up, p.w_down)
    y2 = _combine(out, gates, t, k)
    if p.shared is not None:
        y2 = y2 + apply_mlp(p.shared, x2)
    y = y2.reshape(shape)
    if not return_stats and _RECORDS is None:
        return y
    dropped = torch.sum(~keep)
    _record("local", dropped)
    if return_stats:
        return y, {"expert_load": count.float(), "dropped": dropped,
                   "router_probs_mean": _unsort(probs, order).mean(dim=0),
                   "top_idx": flat.view(t, k).to(torch.int32)}
    return y


# --------------------------------------------------------------------------
# expert parallelism over an LMMesh
# --------------------------------------------------------------------------
def _moe_tree(p: MoE) -> dict:
    """The layer's parameters in `repro`'s layout (tensor leaves)."""
    tree = {"router": {"w": p.router.w}, "w_gate": p.w_gate, "w_up": p.w_up,
            "w_down": p.w_down}
    if p.shared is not None:
        tree["shared"] = {n: {"w": getattr(p.shared, n).w} for n in ("w_gate", "w_up", "w_down")}
    return tree


def _moe_pspec(spec: MoESpec, experts) -> dict:
    """`repro`'s in-specs of the MoE parameters: routed experts over
    ``experts`` (an axis name or a tuple), the router replicated, the shared
    experts' Megatron split over "model"."""
    pspec = {"router": {"w": P(None, None)}, "w_gate": P(experts, None, None),
             "w_up": P(experts, None, None), "w_down": P(experts, None, None)}
    if spec.n_shared:
        pspec["shared"] = {"w_gate": {"w": P(None, "model")}, "w_up": {"w": P(None, "model")},
                           "w_down": {"w": P("model", None)}}
    return pspec


def _rank_params(tree: dict) -> SimpleNamespace:
    """A rank's shard tree as the attributes `route`, `apply_mlp` and the
    expert products read (plain tensors: views stay in the autograd graph)."""
    dense = lambda w: SimpleNamespace(w=w, b=None)            # noqa: E731
    shared = None
    if "shared" in tree:
        shared = SimpleNamespace(**{n: dense(v["w"]) for n, v in tree["shared"].items()})
    return SimpleNamespace(router=dense(tree["router"]["w"]), w_gate=tree["w_gate"],
                           w_up=tree["w_up"], w_down=tree["w_down"], shared=shared)


def _apply_moe_shardmap(p: MoE, x: torch.Tensor, spec: MoESpec, mesh):
    """Expert-parallel MoE: `repro`'s ``shard_map`` path over an `LMMesh`.

    Under megatron TP the [B,S,d] activations are replicated across the
    "model" axis, so EP dispatch needs NO all-to-all — every model rank
    already holds every token. Each rank packs the pairs routed to ITS
    E/model experts (rank-relative sort, capacity from its own token
    count), runs its expert products, combines its gated outputs into a
    [T, d] partial and adds its share of the shared experts; a psum over
    the model ranks of its data rank completes the layer. The router is
    replicated and every model rank of a data rank routes the same rows, so
    the routing runs once a data rank, on its first model rank's device,
    and each rank reads it from there. Where the batch does not divide by
    the DP size, every data rank would compute the whole batch alike: the
    port computes it once, with data rank 0's ranks."""
    dp = dp_axes(mesh)
    msz = int(mesh.shape["model"])
    e_loc, k = spec.n_experts // msz, spec.top_k
    shape = x.shape
    batch_ok = shape[0] % _dp_size(mesh) == 0
    n_dp = _dp_size(mesh) if batch_ok else 1
    rows = shape[0] // n_dp
    shards = shard_tree(_moe_tree(p), _moe_pspec(spec, "model"), mesh)
    outs, dropped = [None] * n_dp, []
    for group in mesh.groups("model"):
        di = mesh.axis_index(group[0], dp)
        if di >= n_dp:
            continue
        x2_home = x.narrow(0, di * rows, rows).reshape(-1, shape[-1])
        t = x2_home.shape[0]
        gates_home, flat_home, _, _ = _route(_rank_params(shards[group[0]]).router,
                                             _to(x2_home, mesh.device_of(group[0])), spec)
        gates_home = gates_home.to(x.dtype)
        partials = []
        for r in group:
            dev = mesh.device_of(r)
            x2, gates = _to(x2_home, dev), _to(gates_home, dev)
            pr = _rank_params(shards[r])
            key = _foreign_key(_to(flat_home, dev) - mesh.axis_index(r, "model") * e_loc, e_loc)
            out, keep, _ = _pair_dispatch(x2, key, k, e_loc, moe_capacity(t, spec),
                                          pr.w_gate, pr.w_up, pr.w_down, foreign=True)
            if _RECORDS is not None:
                dropped.append(_to(((key < e_loc) & ~keep).sum(), x.device))
            y2 = _combine(out, gates, t, k)
            if pr.shared is not None:                 # megatron partial (f/model)
                y2 = y2 + apply_mlp(pr.shared, x2)
            partials.append(y2)
        outs[di] = _to(psum(partials, None)[0], x.device).reshape((rows,) + shape[1:])
    if _RECORDS is not None:
        _record("shardmap", torch.stack(dropped).sum())
    return torch.cat(outs, dim=0) if n_dp > 1 else outs[0]


def _dispatch_local(x2, flat_e, flat_w, e_loc: int, cap: int, wg, wu, wd, dtype, *,
                    return_dropped: bool = False):
    """Sort-pack [T*] (row, expert, weight) onto this rank's ``e_loc``
    experts (ids already rank-relative; out of range = not this rank's),
    run the expert products, and return the weighted per-row outputs [T*,
    d] (and, with ``return_dropped``, how many in-range rows the capacity
    dropped)."""
    out, keep, count = _pair_dispatch(x2, _foreign_key(flat_e.long(), e_loc), 1, e_loc, cap,
                                      wg, wu, wd, foreign=True)
    y = out * flat_w[:, None].to(dtype)
    if return_dropped:
        return y, torch.clamp_min(count - cap, 0).sum()
    return y


def _apply_moe_ep2d(p: MoE, x: torch.Tensor, spec: MoESpec, mesh):
    """Cross-pod expert parallelism (EP over pod x model): `repro`'s path
    over an `LMMesh`.

    Expert storage divides by pod·model; the price is one pod-level
    exchange each way for the tokens routed to the remote pod's experts.
    Each rank packs its pairs per destination pod with a fixed capacity
    (``cap_x``), the buffers move between the pods' ranks of the same
    (data, model) coordinates, each rank dispatches what it received
    through its own experts (`_dispatch_local`, k=1, capacity ``cap2``,
    gates applied after), the model ranks psum, and the results move back
    through the inverse exchange."""
    dp = dp_axes(mesh)
    psz, msz = int(mesh.shape["pod"]), int(mesh.shape["model"])
    e_pod = spec.n_experts // psz                  # experts per pod
    e_loc = e_pod // msz                           # experts per rank
    k = spec.top_k
    shape = x.shape
    if shape[0] % _dp_size(mesh):
        raise ValueError(f"batch {shape[0]} does not split over the DP axes {dp} "
                         f"({_dp_size(mesh)} ranks)")
    rows = shape[0] // _dp_size(mesh)
    shards = shard_tree(_moe_tree(p), _moe_pspec(spec, ("pod", "model")), mesh)
    n = mesh.n_ranks
    x2s, gates_, send_x, send_e, pair_slot, pair_keep = ([None] * n for _ in range(6))
    dropped = []
    cap_x = cap2 = None
    # ---- each rank routes its rows and packs them per destination pod --------
    for r in range(n):
        dev = mesh.device_of(r)
        di = mesh.axis_index(r, dp)
        x2 = _to(x.narrow(0, di * rows, rows), dev).reshape(-1, shape[-1])
        t = x2.shape[0]
        cap_x = int(t * k * spec.capacity_factor / psz)
        cap_x = max(8, min(t * k, -(-cap_x // 8) * 8))
        cap2 = max(8, -(-psz * cap_x * 2 // e_pod) // 8 * 8)
        gates, flat_e, _, _ = _route(_rank_params(shards[r]).router, x2, spec)
        dest, rel_pod = flat_e // e_pod, flat_e % e_pod
        order = torch.argsort(dest, stable=True)
        sorted_d = dest[order]
        seg = torch.searchsorted(sorted_d, torch.arange(psz + 1, device=dev))
        pos = torch.arange(t * k, device=dev) - seg[sorted_d]
        keep = pos < cap_x
        slot = torch.where(keep, sorted_d * cap_x + pos, 0)
        c_idx = torch.arange(cap_x, device=dev)
        filled = c_idx[None, :] < (seg[1:] - seg[:-1])[:, None]          # [psz, cap_x]
        pair = order[torch.clamp(seg[:-1, None] + c_idx[None, :], max=t * k - 1)]
        send_x[r] = torch.where(filled[..., None], x2[pair // k], 0)      # [psz, cap_x, d]
        send_e[r] = torch.where(filled, rel_pod[pair], -1)                # [psz, cap_x]
        pair_slot[r] = torch.empty_like(slot)
        pair_slot[r][order] = slot
        pair_keep[r] = torch.empty_like(keep)
        pair_keep[r][order] = keep
        x2s[r], gates_[r] = x2, gates
        if _RECORDS is not None and mesh.axis_index(r, "model") == 0:   # ranks pack alike
            dropped.append(_to((~keep).sum(), x.device))

    def peer(r: int, pod: int) -> int:
        return mesh.rank_of(**{**mesh.coords(r), "pod": pod})

    # ---- exchange over "pod", then each rank's experts on what it received ---
    outs = [None] * n
    for r in range(n):
        dev, me = mesh.device_of(r), mesh.axis_index(r, "pod")
        recv_x = torch.cat([_to(send_x[peer(r, q)][me], dev) for q in range(psz)])
        recv_e = torch.cat([_to(send_e[peer(r, q)][me], dev) for q in range(psz)])
        rel_here = torch.where(recv_e >= 0, recv_e - mesh.axis_index(r, "model") * e_loc, -1)
        pr = _rank_params(shards[r])
        outs[r], drop = _dispatch_local(
            recv_x, rel_here, torch.ones((psz * cap_x,), dtype=torch.float32, device=dev),
            e_loc, cap2, pr.w_gate, pr.w_up, pr.w_down, x.dtype, return_dropped=True)
        if _RECORDS is not None:
            dropped.append(_to(drop, x.device))
    summed = [None] * n
    for group in mesh.groups("model"):
        total = psum([outs[r] for r in group], None)[0]
        for r in group:
            summed[r] = _to(total, mesh.device_of(r)).reshape(psz, cap_x, -1)

    # ---- results back to the senders (the inverse exchange), then combine ---
    y = [None] * _dp_size(mesh)
    for group in mesh.groups("model"):
        r = group[0]                 # the model ranks of a group agree after the psum
        dev, me = mesh.device_of(r), mesh.axis_index(r, "pod")
        back = torch.cat([_to(summed[peer(r, q)][me], dev) for q in range(psz)])
        contrib = torch.where(pair_keep[r][:, None], back[pair_slot[r]], 0)
        t = x2s[r].shape[0]
        y2 = _combine(contrib, gates_[r], t, k)
        if spec.n_shared:
            y2 = y2 + psum([apply_mlp(_rank_params(shards[m]).shared, x2s[m]) for m in group],
                           None)[0]
        y[mesh.axis_index(r, dp)] = _to(y2, x.device).reshape((rows,) + shape[1:])
    if _RECORDS is not None:
        _record("ep2d", torch.stack(dropped).sum())
    return torch.cat(y, dim=0)


def moe_ref(p: MoE, x: torch.Tensor, spec: MoESpec) -> torch.Tensor:
    """O(T*E) dense oracle (no capacity drops) for tests."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    gates, idx, _ = route(p.router, x2, spec)
    y2 = torch.zeros_like(x2)
    for j in range(spec.n_experts):
        w = torch.where(idx == j, gates, 0.0).sum(-1)             # [T]
        act = swiglu(x2 @ p.w_gate[j], x2 @ p.w_up[j])
        y2 = y2 + (act @ p.w_down[j]) * w[:, None].to(x2.dtype)
    if p.shared is not None:
        y2 = y2 + apply_mlp(p.shared, x2)
    return y2.reshape(shape)
