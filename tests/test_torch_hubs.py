"""The port's hub replication against `repro`'s on the CPU.

Three layers:

  * H1's plain version (`repro_torch.kernels.hub_reconcile`), with the
    port's vote merge and current-label assembly
    (`repro_torch.parallel.collectives`), against `repro`'s
    ``engine._hub_reconcile`` with ``axis=None`` on the same numpy inputs:
    seeded tables with forced ties, slots without votes, pad slots that
    get votes, moves refused for capacity, loads past 2^24. Winners and
    loads bit-equal. H1's schedule (`hub_reconcile_schedule`, the kernel's
    speculate-verify-commit walk on the host) held to both over windows,
    chunks, k and tables that refuse densely, all or nothing, and its
    exactness guard term by term.
  * Hub supersteps against `repro`'s with replayed draws: `repro` runs in a
    subprocess pinned to 8 forced host devices (``--xla_force_host_platform
    _device_count``, fixed when JAX's backend starts), this module run as a
    program (`_worker`), which saves each leg's starting state, every
    superstep's state and the draws `repro` made (the harness of
    tests/test_torch_sharded.py). The port starts from the same state on its
    own layout of the same graph and replays the draws: labels, lambda,
    loads and restream's budgets bit-equal after every superstep,
    probabilities within K2's tolerance. Legs: Revolver's sequential hub
    oracle, Revolver on 4 shards under halo (block and vertex plans) and
    async (staleness 0), restream and Spinner under halo. The subprocess
    also gives `repro`'s hub counters.
  * `repro`'s in-process hub tests (tests/test_halo.py), restated for the
    port, and the hub quality gate of tests/test_sharded.py.

Every hub leg selects its hubs by outdegree quantile (0.95, as `repro`'s
parity worker), which does not depend on the shard count.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jengine  # noqa: E402

from repro_torch.core import engine, run_partitioner  # noqa: E402
from repro_torch.core.convert import (  # noqa: E402
    restream_state_from_numpy,
    revolver_state_from_numpy,
    spinner_state_from_numpy,
)
from repro_torch.core.device_graph import (  # noqa: E402
    host_arrays,
    prepare_device_graph,
    prepare_sharded_device_graph,
)
from repro_torch.core.halo import HubConfig, build_halo_spec  # noqa: E402
from repro_torch.core.registry import get_algorithm  # noqa: E402
from repro_torch.graphs import load_dataset  # noqa: E402
from repro_torch.graphs.generators import dc_sbm  # noqa: E402
from repro_torch.kernels import hub_reconcile as h1  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import BlocksMesh  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
K2_TOL = dict(atol=5e-6, rtol=5e-5)
K, STEPS, QUANTILE = 8, 3, 0.95

# (name, algo, dataset, scale, n_blocks, n_shards, schedule, assignment,
#  granularity): every leg runs STEPS hub supersteps from `repro`'s init at
#  seed 0 (n_shards 1 with "sequential": the hub oracle)
LEGS = [
    ("revolver-oracle", "revolver", "WIKI", 0.002, 16, 1, "sequential", "contiguous", "auto"),
    ("revolver-halo-block", "revolver", "WIKI", 0.002, 16, 4, "halo", "contiguous", "block"),
    ("revolver-halo-vertex", "revolver", "LJ", 0.0005, 16, 4, "halo", "locality", "vertex"),
    ("revolver-async", "revolver", "WIKI", 0.002, 16, 4, "async", "contiguous", "vertex"),
    ("restream-halo", "restream", "WIKI", 0.002, 16, 4, "halo", "contiguous", "vertex"),
    ("spinner-halo", "spinner", "WIKI", 0.002, 16, 4, "halo", "contiguous", "block"),
]
# repro's hub quality gate (tests/sharded_parity_worker.py::hub_quality, there
# at 64 blocks; 32 here, still 4 blocks a shard)
HUB_QUALITY = dict(dataset="WIKI", scale=0.0005, steps=40, n_blocks=32, shards=8)
COUNTERS = dict(dataset="WIKI", scale=0.002, n_blocks=16, shards=4)
_FIELDS = {"revolver": ("labels", "lam", "loads", "probs"),
           "restream": ("labels", "loads", "used", "rank"),
           "spinner": ("labels", "loads")}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small CPU ops: torch's intra-op threads buy little here and
    contend with the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# H1's plain version against `repro`'s reconcile
# --------------------------------------------------------------------------
def _reconcile_case(seed: int, k: int, base_load: float):
    """A hub plan on one shard and its inputs: 200 hubs and 40 pad slots
    over 600 local rows, 0-6 votes a hub (some slots none, some pad slots
    given votes, some exact ties between two labels), degrees up to 60,
    loads within a few degrees of the capacity (every other label with
    room)."""
    rng = np.random.default_rng(seed)
    local_n, n_hubs, pad = 600, 200, 40
    hub_pad = n_hubs + pad
    labels = rng.integers(0, k, local_n).astype(np.int32)
    owner = np.full(hub_pad, -1, np.int32)
    owner[:n_hubs] = 0
    local = np.zeros(hub_pad, np.int32)
    local[:n_hubs] = np.sort(rng.choice(local_n, n_hubs, replace=False))
    deg = np.zeros(hub_pad, np.float32)
    deg[:n_hubs] = rng.integers(1, 61, n_hubs)
    src, slot, w = [], [], []
    by_label = [np.flatnonzero(labels == lab) for lab in range(k)]
    for j in range(hub_pad):
        if j % 7 == 3 and j < n_hubs:           # an exact tie between two labels
            a, b = rng.choice(k, 2, replace=False)
            wt = int(rng.integers(1, 3))
            for lab in (a, b):
                src.append(int(rng.choice(by_label[lab])))
                slot.append(j)
                w.append(wt)
            continue
        for _ in range(int(rng.integers(0, 7)) if j % 5 else 0):
            src.append(int(rng.integers(0, local_n)))
            slot.append(j)
            w.append(int(rng.integers(1, 3)))
    pad_votes = 9                               # a vote slab's 0-weight tail
    src = np.asarray(src + [0] * pad_votes, np.int32)
    slot = np.asarray(slot + [0] * pad_votes, np.int32)
    w = np.asarray(w + [0] * pad_votes, np.float32)
    loads = (base_load + rng.integers(0, 80, k) - 150 * (np.arange(k) % 2)).astype(np.float32)
    cap = np.float32(base_load + 60.5)
    return dict(labels=labels, owner=owner, local=local, deg=deg, src=src, slot=slot, w=w,
                loads=loads, cap=cap, k=k, local_n=local_n)


RECONCILE_CASES = [(0, 8, 1000.0), (1, 5, 1000.0), (2, 8, float(2 ** 25)), (3, 64, 200.0),
                   (4, 2, 1000.0)]


def _repro_reconcile(c):
    """`repro`'s ``_hub_reconcile`` on case ``c``: (labels, loads)."""
    graph = {"hub_owner": jnp.asarray(c["owner"]), "hub_local": jnp.asarray(c["local"]),
             "hub_deg": jnp.asarray(c["deg"]), "hub_src": jnp.asarray(c["src"][None]),
             "hub_slot": jnp.asarray(c["slot"][None]), "hub_w": jnp.asarray(c["w"][None])}
    labels, loads = jengine._hub_reconcile(
        graph, c["k"], jnp.float32(c["cap"]), None, jnp.zeros((), jnp.int32),
        jnp.asarray(c["labels"]), jnp.asarray(c["loads"]), c["local_n"])
    return np.asarray(labels), np.asarray(loads)


def _port_inputs(c):
    """The port's reconcile inputs for case ``c``, merged as the engine
    merges them: (votes, cur, deg, owner, loads, cap)."""
    labels = torch.from_numpy(c["labels"].copy())
    owner = torch.from_numpy(c["owner"])
    local = torch.from_numpy(c["local"]).long()
    votes = collectives.hub_votes(
        [labels], [torch.from_numpy(c["src"]).long()], [torch.from_numpy(c["slot"]).long()],
        [torch.from_numpy(c["w"].astype(np.int32))], owner.shape[0], c["k"], CPU)
    cur = collectives.hub_gather([labels], owner, local, None)[0]
    return (votes, cur, torch.from_numpy(c["deg"]), owner,
            torch.from_numpy(c["loads"].copy()), torch.tensor(c["cap"]))


def _scatter_winners(c, winners):
    labels = c["labels"].copy()
    n_hubs = int((c["owner"] >= 0).sum())
    labels[c["local"][:n_hubs]] = winners[:n_hubs].numpy()
    return labels


@pytest.mark.parametrize("seed,k,base_load", RECONCILE_CASES)
def test_plain_reconcile_matches_repro(seed, k, base_load):
    c = _reconcile_case(seed, k, base_load)
    want_labels, want_loads = _repro_reconcile(c)
    votes, cur, deg, owner, loads, cap = _port_inputs(c)
    ops.reset_launch_counts()
    winners = ops.hub_reconcile(votes, cur, deg, owner, loads, cap)
    assert ops.launch_counts()["hub_reconcile"] == 0       # the plain version ran
    n_hubs = int((c["owner"] >= 0).sum())
    np.testing.assert_array_equal(_scatter_winners(c, winners), want_labels)
    np.testing.assert_array_equal(loads.numpy(), want_loads)
    # the case exercises every gate: moves taken, refused for capacity, ties
    cand, flagged = h1.hub_candidates(votes, cur, owner)
    moved = (winners != cur).sum().item()
    assert 0 < moved < int(flagged.sum()), (moved, int(flagged.sum()))
    assert (votes.sum(1)[:n_hubs] == 0).any() and (votes[n_hubs:].sum() > 0)


# --------------------------------------------------------------------------
# H1's schedule (the kernel's speculate-verify-commit walk, on the host)
# against the plain version and `repro`
# --------------------------------------------------------------------------
def _schedule_equal(inputs, **kw) -> dict:
    """The schedule and the plain version on copies of ``inputs``: winners
    and loads bit-equal. Returns the schedule's counts."""
    votes, cur, deg, owner, loads, cap = inputs
    la, lb = loads.clone(), loads.clone()
    want = h1.hub_reconcile_plain(votes, cur, deg, owner, la, cap)
    got, counts = h1.hub_reconcile_schedule(votes, cur, deg, owner, lb, cap, **kw)
    assert torch.equal(got, want)
    assert torch.equal(lb.view(torch.int32), la.view(torch.int32))   # bit for bit
    assert counts["flagged"] == int(h1.hub_candidates(votes, cur, owner)[1].sum())
    return counts


@pytest.mark.parametrize("window", [1, 32, h1.WINDOW, 1024])
@pytest.mark.parametrize("seed,k,base_load", RECONCILE_CASES)
def test_schedule_matches_repro(seed, k, base_load, window):
    """The schedule on the cases `repro` is held to above: `repro`'s labels
    and loads bit for bit. Loads past 2^24 and k 64 take the serial body,
    the rest the parallel one."""
    c = _reconcile_case(seed, k, base_load)
    want_labels, want_loads = _repro_reconcile(c)
    inputs = _port_inputs(c)
    loads = inputs[4].clone()
    winners, counts = h1.hub_reconcile_schedule(*inputs[:4], loads, inputs[5], window=window)
    np.testing.assert_array_equal(_scatter_winners(c, winners), want_labels)
    np.testing.assert_array_equal(loads.numpy(), want_loads)
    serial = base_load >= 2 ** 24 or k > h1.PARALLEL_MAX_K
    assert counts["body"] == ("serial" if serial else "parallel"), counts
    _schedule_equal(inputs, window=window, chunk=64, serial_below=0)


def test_guard_refuses_loads_past_2_24():
    """The case with loads past 2^24 fails the guard on the loads alone; a
    case below passes it."""
    for base_load, want in ((float(2 ** 25), False), (1000.0, True)):
        votes, cur, deg, owner, loads, cap = _port_inputs(_reconcile_case(2, 8, base_load))
        flagged = h1.hub_candidates(votes, cur, owner)[1]
        assert h1.parallel_walk_exact(deg[flagged].numpy(), loads.numpy(), cap) is want


@pytest.mark.parametrize("deg,loads,cap,want", [
    ([3.0, 5.0], [10.0, 20.0], 40.5, True),
    ([3.5, 5.0], [10.0, 20.0], 40.0, False),                   # a fractional degree
    ([-1.0, 5.0], [10.0, 20.0], 40.0, False),                  # a negative degree
    ([3.0, 5.0], [-0.0, 20.0], 40.0, False),                   # a -0.0 load
    ([3.0, float("nan")], [10.0, 20.0], 40.0, False),
    ([3.0, 5.0], [10.0, float("inf")], 40.0, False),
    ([3.0, 5.0], [10.0, 20.0], float("nan"), True),            # takes nothing, exactly
    ([3.0, 5.0], [10.0, 20.0], float("inf"), False),           # floor(cap) past 2^24
    ([16.0, 5.0], [10.0, 2.0 ** 24 - 16], 2.0 ** 24 - 16, True),    # top + max degree == 2^24
    ([17.0, 5.0], [10.0, 2.0 ** 24 - 16], 2.0 ** 24 - 16, False),
    ([2.0 ** 24, 2.0 ** 24, 2.0 ** 24], [0.0, 0.0], 0.0, True),   # the sum's floor holds
    ([2.0 ** 23] * 5, [0.0, 0.0, 0.0, 0.0, 2.0 ** 23], 2.0 ** 23, False),   # no floor holds
    ([1.0] * 5, [0.0, 0.0, 0.0, 0.0, 2.0 ** 23], 2.0 ** 23, True),   # the degrees' floor
])
def test_guard_terms(deg, loads, cap, want):
    """Each term of the guard on its own."""
    assert h1.parallel_walk_exact(np.float32(deg), np.float32(loads), np.float32(cap)) is want


def _table(seed: int, k: int, hub_pad: int, *, room: int, deg_max: int):
    """A reconcile input: random votes (a fifth of the slots none, a tenth
    pad), degrees 1..deg_max and loads ``room`` below a capacity of
    1,000,000 (``room`` < 0: above it); an odd number of flagged slots."""
    rng = np.random.default_rng(seed)
    votes = rng.integers(0, 9, (hub_pad, k)).astype(np.int32)
    votes[rng.random(hub_pad) < 0.2] = 0
    owner = rng.integers(0, 4, hub_pad).astype(np.int32)
    owner[rng.random(hub_pad) < 0.1] = -1
    cur = rng.integers(0, k, hub_pad).astype(np.int32)
    deg = rng.integers(1, deg_max + 1, hub_pad).astype(np.float32)
    cap = np.float32(1_000_000)
    loads = (cap - room - rng.integers(0, max(abs(room), 1), k)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (votes, cur, deg, owner, loads)]
    flagged = torch.nonzero(h1.hub_candidates(t[0], t[1], t[3])[1]).view(-1)
    if flagged.numel() % 2 == 0 and flagged.numel():
        t[3][flagged[0]] = -1        # an odd flagged count: no window's multiple
    return (*t, torch.tensor(cap))


TABLES = {  # name: (room, deg_max)
    "refusal_dense": (2_000, 1_000),
    "none_refused": (900_000, 100),
    "all_refused": (-10, 100),
    "mixed": (20_000, 2_000),
}


@pytest.mark.parametrize("serial_below", [0, h1.SERIAL_BELOW])
@pytest.mark.parametrize("chunk", [700, h1.CHUNK])
@pytest.mark.parametrize("window", [1, 32, 1024])
@pytest.mark.parametrize("k", [1, 2, 8, 32, 64])
@pytest.mark.parametrize("table", list(TABLES))
def test_schedule_matches_plain(table, k, window, chunk, serial_below):
    """The schedule bit-equal to the plain version on seeded tables: dense
    refusals, none refused, all refused; flagged counts that are not a
    multiple of the window, and chunks of 700 slots, so that windows meet a
    chunk's end; with and without serial steps. k 64 takes the serial body.
    Where the capacity refuses all or nothing, every guess holds: a window
    a round."""
    room, deg_max = TABLES[table]
    inputs = _table(7 + k, k, 3_001, room=room, deg_max=deg_max)
    counts = _schedule_equal(inputs, window=window, chunk=chunk, serial_below=serial_below)
    n = counts["flagged"]
    moved = int((h1.hub_reconcile_plain(*inputs[:4], inputs[4].clone(), inputs[5])
                 != inputs[1]).sum())
    if k == 1:
        assert n == 0 and counts["rounds"] == 0
        return
    assert n % 2 == 1
    assert counts["body"] == ("serial" if k > h1.PARALLEL_MAX_K else "parallel")
    if table == "none_refused":
        assert moved == n
    elif table == "all_refused":
        assert moved == 0
    else:
        assert 0 < moved < n
    if counts["body"] == "serial":
        assert counts["rounds"] == counts["serial_steps"] == 0
        return
    assert counts["rounds"] + counts["serial_steps"] <= n     # a slot a round at least
    windows = sum(-(-min(chunk, n - q) // window) for q in range(0, n, chunk))
    if serial_below == 0:
        assert counts["serial_steps"] == 0 and counts["rounds"] >= windows
    if table in ("none_refused", "all_refused") and window >= serial_below:
        assert counts["rounds"] == windows and counts["serial_steps"] == 0


def test_schedule_on_a_table():
    """The hand-made table of `test_plain_reconcile_on_a_table` through the
    schedule, windows of 1, 2 and 128."""
    votes = torch.tensor([[0, 3, 3, 0], [0, 0, 0, 0], [5, 0, 0, 0], [0, 0, 2, 0],
                          [0, 0, 0, 9], [0, 0, 0, 4]], dtype=torch.int32)
    cur = torch.tensor([0, 1, 0, 2, 1, 0], dtype=torch.int32)
    owner = torch.tensor([0, 0, -1, 0, 0, 0], dtype=torch.int32)
    deg = torch.tensor([4, 1, 1, 1, 7, 6], dtype=torch.float32)
    for window in (1, 2, 128):
        loads = torch.tensor([10.0, 2.0, 0.0, 6.0])
        winners, counts = h1.hub_reconcile_schedule(votes, cur, deg, owner, loads,
                                                    torch.tensor(12.0), window=window)
        assert winners.tolist() == [1, 1, 0, 2, 1, 3]
        assert loads.tolist() == [0.0, 6.0, 0.0, 12.0]
        assert counts["body"] == "parallel" and counts["flagged"] == 3


def test_plain_reconcile_on_a_table():
    """The walk itself on a hand-made table: ties go to the lowest label,
    a slot without votes, a pad slot and a slot that already holds its
    winner stay, and a move that would pass the capacity is refused while a
    later, lighter one is taken against the loads as carried."""
    votes = torch.tensor([[0, 3, 3, 0],    # tie 1/2 -> 1: moves (cur 0), d 4
                          [0, 0, 0, 0],    # no votes
                          [5, 0, 0, 0],    # pad slot
                          [0, 0, 2, 0],    # cur already 2
                          [0, 0, 0, 9],    # -> 3, d 7: 6 + 7 > 12, refused
                          [0, 0, 0, 4]],   # -> 3, d 6: 6 + 6 <= 12, taken
                         dtype=torch.int32)
    cur = torch.tensor([0, 1, 0, 2, 1, 0], dtype=torch.int32)
    owner = torch.tensor([0, 0, -1, 0, 0, 0], dtype=torch.int32)
    deg = torch.tensor([4, 1, 1, 1, 7, 6], dtype=torch.float32)
    loads = torch.tensor([10.0, 2.0, 0.0, 6.0])
    winners = h1.hub_reconcile_plain(votes, cur, deg, owner, loads, torch.tensor(12.0))
    assert winners.tolist() == [1, 1, 0, 2, 1, 3]
    assert loads.tolist() == [0.0, 6.0, 0.0, 12.0]


# --------------------------------------------------------------------------
# the JAX side: this module run as a program under 8 forced host devices
# --------------------------------------------------------------------------
def _jax_leg(name, algo, dataset, scale, n_blocks, n_shards, schedule, assignment,
             granularity) -> dict:
    from repro.core import device_graph as jdg
    from repro.core import halo as jhalo
    from repro.core.registry import get_algorithm as jget
    from repro.graphs import load_dataset as jload
    from repro.launch.mesh import make_blocks_mesh as jmesh

    g = jload(dataset, scale=scale, seed=0)
    hubs = jhalo.HubConfig(quantile=QUANTILE)
    alg = jget(algo)
    cfg = alg.config_cls(k=K, chunk_schedule=schedule)
    out = {}
    if schedule == "sequential":
        dg = jdg.prepare_device_graph(g, n_blocks=n_blocks)
        spec = jhalo.build_halo_spec(
            np.asarray(dg.blk_dst), np.asarray(dg.blk_w), 1, dg.block_v, threshold=2.0,
            hubs=hubs, deg=np.asarray(dg.deg_out), vmask=np.asarray(dg.vmask),
            blk_row=np.asarray(dg.blk_row))
        layout = dg

        def step_fn(st):
            return jengine.superstep(alg, dg, cfg, st, halo=spec)
    else:
        mesh = jmesh(n_shards)
        kw = dict(n_blocks=n_blocks, halo=True, halo_threshold=2.0,
                  halo_granularity=granularity, hubs=hubs)
        layout = jdg.prepare_sharded_device_graph(g, mesh, assignment=assignment, **kw)
        if schedule == "async":
            order = jhalo.interior_first_order(layout.halo)
            if order is not None:
                perm = (np.asarray(layout.block_perm)[order] if layout.block_perm is not None
                        else order)
                layout = jdg.prepare_sharded_device_graph(g, mesh, assignment=perm, **kw)
            out["interior_split"] = np.int64(layout.halo.interior_split)
        spec = layout.halo
        out["block_perm"] = np.asarray(layout.block_perm if layout.block_perm is not None
                                       else np.arange(layout.n_blocks))

        def step_fn(st):
            if schedule == "async":
                return jengine.async_superstep(alg, layout, cfg, st)[0]
            return jengine.superstep(alg, layout, cfg, st)
    out["hub_ids"] = np.asarray(spec.hub_ids, dtype=np.int64)
    state = alg.init(layout, cfg, jax.random.PRNGKey(0))
    if schedule != "sequential":
        state = jengine.place_state(alg, state, layout)
    bps, bv = layout.n_blocks // n_shards, layout.block_v

    def snap(st, tag):
        for f, v in st._asdict().items():
            if f not in ("key", "step"):
                out[f"{tag}/{f}"] = np.asarray(jax.device_get(v))

    snap(state, "init")
    for step in range(STEPS):
        key = state.key
        if algo == "spinner":
            _, k_mig = jax.random.split(key)
            out[f"draws/{step}"] = np.asarray(jax.random.uniform(k_mig, (layout.n_pad,)))
        else:
            for s in range(n_shards):
                ks = key if s == 0 else jax.random.fold_in(key, s)
                for i in range(bps):
                    b = s * bps + i
                    if algo == "revolver":
                        ks, k_act, k_mig = jax.random.split(ks, 3)
                        out[f"draws/{step}/{b}/g"] = np.asarray(
                            jax.random.gumbel(k_act, (bv, K)))
                    else:
                        ks, k_mig = jax.random.split(ks)
                    out[f"draws/{step}/{b}/u"] = np.asarray(jax.random.uniform(k_mig, (bv,)))
        state = step_fn(state)
        snap(state, f"step{step}")
    return out


def _jax_counters() -> dict:
    """`repro`'s hub counters: a traced 4-shard halo hub run."""
    from repro.core.runner import run_partitioner as jrun
    from repro.graphs import load_dataset as jload
    from repro.launch.mesh import make_blocks_mesh as jmesh
    from repro.obs import Tracer as JTracer

    c = COUNTERS
    tracer = JTracer()
    jrun("revolver", jload(c["dataset"], scale=c["scale"], seed=0), K, seed=0, max_steps=2,
         n_blocks=c["n_blocks"], mesh=jmesh(c["shards"]), chunk_schedule="halo",
         halo_threshold=2.0, hub_replication=True, hub_quantile=QUANTILE,
         track_history=False, trace=tracer)
    return {name: tracer.series[name][0][1] for name in ("hub_count", "replica_vote_bytes")}


def _worker(out_dir: str) -> int:
    assert jax.device_count() >= 8, f"needs 8 host devices, has {jax.device_count()}"
    for leg in LEGS:
        np.savez(os.path.join(out_dir, leg[0] + ".npz"), **_jax_leg(*leg))
    with open(os.path.join(out_dir, "counters.json"), "w") as f:
        json.dump(_jax_counters(), f)
    return 0


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_hubs")
    env = dict(os.environ)
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_force_host_platform_device_count")]
    env["XLA_FLAGS"] = " ".join(flags + ["--xla_force_host_platform_device_count=8"])
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)], env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return out


# --------------------------------------------------------------------------
# the port's hub supersteps against `repro`'s
# --------------------------------------------------------------------------
_CONVERT = {"revolver": revolver_state_from_numpy, "restream": restream_state_from_numpy,
            "spinner": spinner_state_from_numpy}


@pytest.mark.parametrize("leg", LEGS, ids=[leg[0] for leg in LEGS])
def test_hub_supersteps_match_repro_with_replayed_draws(jax_runs, leg):
    name, algo, dataset, scale, n_blocks, n_shards, schedule, assignment, gran = leg
    with np.load(os.path.join(jax_runs, name + ".npz")) as z:
        want = dict(z)
    g = load_dataset(dataset, scale=scale, seed=0)
    hubs = HubConfig(quantile=QUANTILE)
    alg = get_algorithm(algo)
    cfg = alg.config_cls(k=K, chunk_schedule=schedule)
    if schedule == "sequential":
        layout = prepare_device_graph(g, n_blocks=n_blocks, device="cpu")
        a = host_arrays(layout)
        spec = build_halo_spec(a["blk_dst"], a["blk_w"], 1, a["block_v"], threshold=2.0,
                               hubs=hubs, deg=a["deg_out"], vmask=a["vmask"],
                               blk_row=a["blk_row"])
    else:
        perm = want["block_perm"]
        assign = perm if not np.array_equal(perm, np.arange(perm.size)) else "contiguous"
        layout = prepare_sharded_device_graph(
            g, BlocksMesh([CPU] * n_shards), n_blocks=n_blocks, assignment=assign, halo=True,
            halo_threshold=2.0, halo_granularity=gran, hubs=hubs)
        if schedule == "async":
            assert layout.halo.interior_split == int(want["interior_split"])
        assert layout.hubs_on
        spec = None
    hub_ids = want["hub_ids"]
    assert hub_ids.size > 0
    assert (spec.hub_ids if spec is not None else layout.halo.hub_ids) == tuple(hub_ids)
    init = {f[5:]: v for f, v in want.items() if f.startswith("init/")}
    state = _CONVERT[algo](dict(init, step=0), "cpu", seed=0)
    if algo == "spinner":
        def draws(step):
            return want[f"draws/{step}"]
    elif algo == "revolver":
        def draws(step, b):
            return want[f"draws/{step}/{b}/g"], want[f"draws/{step}/{b}/u"]
    else:
        def draws(step, b):
            return want[f"draws/{step}/{b}/u"]
    hub_moves = 0
    for step in range(STEPS):
        before = state.labels[hub_ids].clone()
        state = engine.superstep(alg, layout, cfg, state, draws=draws, halo=spec)
        hub_moves += int((state.labels[hub_ids] != before).sum())
        for f in _FIELDS[algo]:
            got, ref = getattr(state, f).numpy(), want[f"step{step}/{f}"]
            if f == "probs":
                np.testing.assert_allclose(got, ref, **K2_TOL, err_msg=f"{name} step {step}")
            else:
                np.testing.assert_array_equal(got, ref, err_msg=f"{f}: {name} step {step}")
        np.testing.assert_allclose(float(state.score), float(want[f"step{step}/score"]),
                                   rtol=1e-5)
    assert hub_moves > 0, f"{name}: no hub changed its label"


def test_hub_counters_equal_repro(jax_runs):
    with open(os.path.join(jax_runs, "counters.json")) as f:
        want = json.load(f)
    c = COUNTERS
    tracer = Tracer()
    run_partitioner("revolver", load_dataset(c["dataset"], scale=c["scale"], seed=0), K,
                    seed=0, max_steps=2, n_blocks=c["n_blocks"], device="cpu",
                    mesh=BlocksMesh([CPU] * c["shards"]), chunk_schedule="halo",
                    halo_threshold=2.0, hub_replication=True, hub_quantile=QUANTILE,
                    track_history=False, trace=tracer)
    got = {name: tracer.series[name][0][1] for name in ("hub_count", "replica_vote_bytes")}
    assert got == want and got["hub_count"] > 0


def test_hub_quality_and_balance_at_8_shards():
    """`repro`'s gate (tests/test_sharded.py, which holds `repro` to it):
    8-shard hub mode keeps >= 0.90 x plain sharded's local edges at one step
    budget, with max_norm_load <= 1.30."""
    q = HUB_QUALITY
    g = load_dataset(q["dataset"], scale=q["scale"], seed=0)
    common = dict(seed=0, max_steps=q["steps"], patience=10_000, track_history=False,
                  n_blocks=q["n_blocks"], mesh=BlocksMesh([CPU] * q["shards"]), device="cpu")
    sh = run_partitioner("revolver", g, K, chunk_schedule="sharded", **common)
    hub = run_partitioner("revolver", g, K, chunk_schedule="halo", halo_threshold=2.0,
                          hub_replication=True, hub_quantile=QUANTILE, **common)
    ratio = hub.local_edges / sh.local_edges
    assert ratio >= 0.90 and hub.max_norm_load <= 1.30, (ratio, hub.max_norm_load)


# --------------------------------------------------------------------------
# `repro`'s in-process hub tests (tests/test_halo.py), for the port
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def sbm_graph():
    return dc_sbm(1024, 8192, n_comm=16, mixing=0.25, degree_exponent=0.5, seed=3)


def _clone(state):
    gen = torch.Generator(device=state.gen.device)
    gen.set_state(state.gen.get_state())
    return state._replace(gen=gen, **{f: v.clone() for f, v in state._asdict().items()
                                      if isinstance(v, torch.Tensor)})


@pytest.mark.parametrize("algo", ["revolver", "spinner", "restream"])
def test_hub_oracle_one_shard_matches_sequential(sbm_graph, algo):
    """The sequential hub schedule and the 1-shard mesh hub schedule run the
    same plan through different code paths: whole runs give the same
    labels, and the engine's states are equal field by field."""
    common = dict(seed=3, max_steps=4, patience=10_000, track_history=False, n_blocks=8,
                  device="cpu", hub_replication=True, hub_quantile=0.9)
    r_seq = run_partitioner(algo, sbm_graph, 4, **common)
    r_mesh = run_partitioner(algo, sbm_graph, 4, chunk_schedule="halo", halo_threshold=2.0,
                             mesh=BlocksMesh([CPU]), **common)
    np.testing.assert_array_equal(r_seq.labels, r_mesh.labels)

    alg = get_algorithm(algo)
    sdg = prepare_sharded_device_graph(sbm_graph, BlocksMesh([CPU]), n_blocks=8, halo=True,
                                       halo_threshold=2.0, hubs=HubConfig(quantile=0.9))
    a = host_arrays(sdg.dg)
    spec = build_halo_spec(a["blk_dst"], a["blk_w"], 1, a["block_v"], hubs=HubConfig(0.9),
                           deg=a["deg_out"], vmask=a["vmask"], blk_row=a["blk_row"])
    seq = alg.init(sdg.dg, alg.config_cls(k=4), torch.Generator().manual_seed(1))
    one = _clone(seq)
    for step in range(4):
        seq = engine.superstep(alg, sdg.dg, alg.config_cls(k=4), seq, halo=spec)
        one = engine.superstep(alg, sdg, alg.config_cls(k=4, chunk_schedule="halo"), one)
        for f, v in seq._asdict().items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, getattr(one, f)), f"{algo} {f} step {step}"


def test_hub_replication_engages(sbm_graph):
    """With hubs on, the frozen-scan + vote-reconcile trajectory differs
    from the plain sequential one, and the result still covers every vertex
    with in-range labels."""
    common = dict(seed=3, max_steps=6, patience=10_000, track_history=False, n_blocks=8,
                  device="cpu")
    r_plain = run_partitioner("revolver", sbm_graph, 4, **common)
    r_hub = run_partitioner("revolver", sbm_graph, 4, hub_replication=True, hub_quantile=0.9,
                            **common)
    assert not np.array_equal(r_plain.labels, r_hub.labels)
    assert r_hub.labels.shape == (sbm_graph.n,)
    assert ((r_hub.labels >= 0) & (r_hub.labels < 4)).all()


def test_hub_rejects_sharded_schedule(sbm_graph):
    with pytest.raises(ValueError, match="hub_replication"):
        run_partitioner("revolver", sbm_graph, 4, hub_replication=True, device="cpu",
                        chunk_schedule="sharded", mesh=BlocksMesh([CPU]), max_steps=2)


def test_hub_knobs_require_hub_replication(sbm_graph):
    with pytest.raises(ValueError, match="hub_quantile"):
        run_partitioner("revolver", sbm_graph, 4, hub_quantile=0.9, max_steps=2, device="cpu")


def test_vote_sums_past_int32_raise():
    """A layout whose votes for one hub could reach 2^31 raises when it is
    built (the vote table is int32)."""
    from repro_torch.core.device_graph import hub_oracle_slabs

    g = dc_sbm(256, 2048, n_comm=4, seed=0)
    dg = prepare_device_graph(g, n_blocks=4, device="cpu")
    a = host_arrays(dg)
    spec = build_halo_spec(a["blk_dst"], a["blk_w"], 1, a["block_v"], hubs=HubConfig(0.9),
                           deg=a["deg_out"], vmask=a["vmask"], blk_row=a["blk_row"])
    assert hub_oracle_slabs(dg, spec) is not None
    heavy = dict(vars(spec))
    heavy["hub_w"] = np.where(spec.hub_w > 0, np.float32(2 ** 30), 0).astype(np.float32)
    with pytest.raises(ValueError, match="2\\^31"):
        hub_oracle_slabs(dg, type(spec)(**heavy))


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1]))
