"""The benchmark's run: set-up, a window of partition jobs, the trace, the
comparison with the plain reference, and the result line.

One run is one process on one card:

 1. the CUDA context;
 2. the configuration's graph made on the card from the seed
    (`graphgen`), copied to the host as the port's `Graph`;
 3. the port's layout of it, built once (`prepare_device_graph`);
 4. one warm-up job on a seed the window never uses (it loads the kernels
    from the build cache in the checkout, building them on a first run);
 5. jobs back to back for ``seconds``: each is one user's request,
    ``run_partitioner(algo, graph, k, seed=<job seed>, dg=<the layout>,
    epsilon=..., n_blocks=...)`` with the traffic's rule settings and the
    entry's other defaults, from the call to its labels on the host; a job
    started before the deadline finishes (a closed loop of one client);
 6. with ``trace``, the window's first jobs again under `torch.profiler`
    and the port's tracer, as many as fit the traffic's event budget;
 7. the comparison that decides ``correct`` (`judge`), then the metrics,
    each read by its own file under ``metrics/``.

Everything a configuration, a traffic mix, a cell's limits or a metric
holds is read from its own file, found by the name `BENCHMARK.json` gives.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import math
import pathlib
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
HERE = ROOT / "partbench"
# top-level module names no run may hold once its window has closed: JAX
# and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one purpose (``tags``) of a run's ``seed``."""
    h = hashlib.blake2b(repr((int(seed),) + tags).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One ``workloads`` entry with the files it names."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The ``workloads`` entry ``name`` of BENCHMARK.json with its files."""
    bench = load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(work)}")
    return cell_from_files(name, work[name]["config"], work[name]["traffic"], bench, root)


def cell_from_files(name: str, config: str, traffic: str, bench: dict,
                    root: pathlib.Path = ROOT) -> Cell:
    """A cell from its configuration, traffic and limit files, with the
    metrics of ``bench`` that it reports (those listing it, or no cell)."""
    part = root / "partbench"

    def mine(metrics):
        return [m for m in metrics if "workloads" not in m or name in m["workloads"]]

    return Cell(name, load_json(part / "configs" / f"{config}.json"),
                load_json(part / "traffic" / f"{traffic}.json"),
                load_json(part / "cells" / f"{name}.json")["limits"],
                mine(bench["end_to_end"]), mine(bench["per_layer"]))


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Draws:
    """The random draws a followed job takes, made here from a seed and
    handed to the program (the entry's ``draws`` replay argument) and to
    the reference alike. Revolver takes per block a Gumbel tile [block_v,
    k] and a uniform [block_v]; restream a uniform [block_v] per block;
    Spinner a uniform [n_pad] per superstep."""

    def __init__(self, algo: str, seed: int, n_pad: int, block_v: int, k: int, device):
        self.algo, self.seed = algo, seed
        self.n_pad, self.block_v, self.k, self.device = n_pad, block_v, k, device

    def _gen(self, *tags):
        import torch

        return torch.Generator(device=self.device).manual_seed(derive(self.seed, *tags))

    def __call__(self, step: int, blk: Optional[int] = None):
        import torch

        dev = self.device
        if self.algo == "spinner":
            return torch.rand(self.n_pad, generator=self._gen(step), device=dev)
        gen = self._gen(step, blk)
        if self.algo == "restream":
            return torch.rand(self.block_v, generator=gen, device=dev)
        u = torch.rand((self.block_v, self.k), generator=gen, device=dev)
        u.clamp_min_(torch.finfo(torch.float32).tiny)
        gumbel = -torch.log(-torch.log(u))
        return gumbel, torch.rand(self.block_v, generator=gen, device=dev)


@dataclasses.dataclass
class Job:
    index: int
    seed: int
    wall_s: float
    steps: int = 0
    converged: bool = False
    labels: Optional[np.ndarray] = None
    error: Optional[str] = None
    local_edges: Optional[float] = None     # the reference's recount
    max_norm_load: Optional[float] = None   # the reference's recount
    reported: Optional[tuple] = None        # the program's own (local_edges, max_norm_load)


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    algo: str
    k: int
    graph: dict               # n, m, entries, n_pad, block_v, n_blocks, block_live
    setup: Dict[str, float]   # seconds of set-up and of its parts
    jobs: List[Job]
    peak_bytes: int
    profile: object = None    # profiling.Profile of a traced run


def follow(algo: str, lay, states: dict, draws, k: int, rule: dict) -> dict:
    """The reference's supersteps from given states: state t-1 and draws
    t-1 give the reference's state t, compared with the given state t.

    ``states`` maps t to ``(labels [n], probs [n, k] or None, score of
    superstep t or None)``; every step t whose state t-1 is given is
    followed. Within a run of steps the reference carries Revolver's lambda
    and restream's budgets from its own previous step; a run from step 0
    starts lambda from the labels, as the rule does. A run from a later
    step has no lambda, which only the probability update reads, so its
    first step compares labels and score alone. Restream's budgets follow
    from the degree ramp alone (`rules.budgets_spent`).

    Returns the numbers compared: labels that differ (summed over the
    steps), the largest score gap and, for Revolver, the largest
    probability gap (step 0's against the uniform 1/k)."""
    import torch

    from partbench.reference import rules

    n = lay.n
    out = {"step_labels": 0, "step_score": 0.0}
    if algo == "revolver":
        out["step_probs"] = (float(np.max(np.abs(states[0][1] - np.float32(1.0 / k))))
                             if 0 in states else 0.0)
    carry = None
    for t in sorted(states):
        if t - 1 not in states:
            carry = None
            continue
        labels, probs, _ = states[t - 1]
        st = rules.initial_state(lay, algo, labels, k)
        lam_known = t == 1 or carry is not None
        if algo == "revolver":
            st["probs"][:n] = torch.as_tensor(probs, device=lay.device)
            if carry is not None:
                st["lam"] = carry["lam"]
        if algo == "restream":
            st["used"] = carry["used"] if carry is not None else rules.budgets_spent(
                lay, st["rank"], t - 1, rule["priority_ramp"], rule["restream_budget"])
        carry = rules.step(algo, lay, st, draws, t - 1, k, rule)
        got_labels, got_probs, got_score = states[t]
        ref_labels = carry["labels"][:n].cpu().numpy()
        out["step_labels"] += int(np.count_nonzero(ref_labels != got_labels))
        out["step_score"] = max(out["step_score"], abs(float(carry["score"]) - got_score))
        if algo == "revolver" and lam_known:
            ref_probs = carry["probs"][:n].float().cpu().numpy()
            out["step_probs"] = max(out["step_probs"],
                                    float(np.max(np.abs(ref_probs - got_probs))))
    return out


def program_states(call: Callable, early: int, late: int, n: int, k: int) -> dict:
    """The program's states of one job (see `follow`): after 0..``early``
    supersteps, and after the last three up to step ``late`` or the job's
    halting, whichever comes first. Each is the entry called with
    ``max_steps=t``: the same seed and draws give the same trajectory."""
    states = {}

    def take(t):
        res = call(max_steps=t, keep_probs=True)
        probs = None if res.probs is None else res.probs.reshape(-1, k)[:n]
        score = res.history["score"][res.steps - 1] if res.steps else None
        states[res.steps] = (np.asarray(res.labels), probs, score)
        return res.steps

    for t in range(early + 1):
        take(t)
    last = take(late)
    for t in (last - 2, last - 1):
        if t > early:
            take(t)
    return states


def control_states(algo: str, lay, states: dict, draws, k: int, rule: dict, dtype) -> dict:
    """The reference put in the program's place at ``dtype``: its own
    trajectory from the program's starting state, taken at the steps
    ``states`` holds, in the program's form."""
    import torch

    from partbench.reference import rules

    n = lay.n
    out = {0: states[0]}
    st = rules.initial_state(lay, algo, states[0][0], k, dtype)
    for t in range(1, max(states) + 1):
        st = rules.step(algo, lay, st, draws, t - 1, k, rule, dtype)
        if t in states:
            probs = st["probs"][:n].float().cpu().numpy() if algo == "revolver" else None
            out[t] = (st["labels"][:n].cpu().numpy(), probs, float(st["score"]))
        st = {key: v for key, v in st.items() if isinstance(v, torch.Tensor)}
    return out


def judge(cell: Cell, graph: dict, jobs: List[Job], call: Callable, seed: int, device,
          states_hook: Optional[Callable] = None) -> Dict[str, float]:
    """The numbers that decide ``correct``, each to be held to its limit:
    every finished job of the window recounted by the reference
    (`recount`), and one job followed superstep by superstep
    (`follow_job`)."""
    out = recount(cell, graph, jobs, device)
    out.update(follow_job(cell, graph, call, seed, device, states_hook))
    return out


def recount(cell: Cell, graph: dict, jobs: List[Job], device) -> Dict[str, float]:
    """The window's partitions recounted by the reference, which also sets
    each job's ``local_edges`` and ``max_norm_load``. Over all jobs:

    * ``bad_labels``: labels outside [0, k), summed;
    * ``load_max``: the largest part's out-degree load over |E| / k, the
      worst job's (the configuration's capacity is 1 + eps);
    * ``chance_ratio``: a random partition's share of local edges, 1 / k,
      over the job's, the worst job's (1 for a job no better than chance);
    * ``self_gap``: the widest gap between the program's own
      ``local_edges`` and ``max_norm_load`` of a job and the recount."""
    import torch

    from partbench.reference import partition

    k = int(cell.config["k"])
    edges = partition.EdgeList(graph, device)
    out = {"bad_labels": 0, "load_max": 0.0, "chance_ratio": 0.0, "self_gap": 0.0}
    for job in jobs:
        if job.labels is None:
            continue
        c = edges.count(job.labels, k)
        job.local_edges, job.max_norm_load = c.local_edges, c.max_norm_load
        out["bad_labels"] += c.bad_labels
        out["load_max"] = max(out["load_max"], c.max_norm_load)
        out["chance_ratio"] = max(out["chance_ratio"],
                                  1.0 / (k * c.local_edges) if c.local_edges > 0 else math.inf)
        if job.reported is not None:
            out["self_gap"] = max(out["self_gap"], abs(job.reported[0] - c.local_edges),
                                  abs(job.reported[1] - c.max_norm_load))
    del edges
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def follow_job(cell: Cell, graph: dict, call: Callable, seed: int, device,
               states_hook: Optional[Callable] = None) -> Dict[str, float]:
    """One job, seeded from ``seed``, followed (`follow`) over its first
    ``follow_steps`` supersteps and its last three up to ``late_step``
    (the traffic's), with draws made here from the seed: ``start_bad`` and
    ``start_z`` (the program's starting labels: out of range, and how far
    from uniform), ``step_labels``, ``step_score`` and, for Revolver,
    ``step_probs``. ``states_hook(layout, states, draws)`` may replace the
    program's states (the control)."""
    from partbench.reference import rules

    k, algo = int(cell.config["k"]), cell.traffic["algo"]
    lay = rules.Layout(graph, int(cell.config["n_blocks"]), device)
    draws = Draws(algo, derive(seed, "draws"), lay.n_pad, lay.block_v, k, device)
    fseed = derive(seed, "follow")
    states = program_states(lambda **kw: call(seed=fseed, draws=draws, **kw),
                            int(cell.traffic["follow_steps"]), int(cell.traffic["late_step"]),
                            lay.n, k)
    if states_hook is not None:
        states = states_hook(lay, states, draws)
    labels0 = states[0][0]
    out = {"start_bad": int(np.count_nonzero((labels0 < 0) | (labels0 >= k))),
           "start_z": rules.uniform_z(labels0, k)}
    out.update(follow(algo, lay, states, draws, k, rule_settings(cell)))
    return out


def control_hook(cell: Cell, dtype) -> Callable:
    """A ``states_hook`` putting the reference at ``dtype`` in the
    program's place from the program's starting state."""
    k, algo = int(cell.config["k"]), cell.traffic["algo"]

    def hook(lay, states, draws):
        return control_states(algo, lay, states, draws, k, rule_settings(cell), dtype)

    return hook


def rule_settings(cell: Cell) -> dict:
    return dict(cell.traffic.get("rule", {}), epsilon=float(cell.config["epsilon"]))


def load_reader(name: str) -> Callable:
    """The ``read(run)`` function of metric ``name`` (``metrics/<name>.py``)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "partbench_metric_" + "".join(c if c.isalnum() else "_" for c in name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(entries: List[dict], run: Run) -> dict:
    """{name: {value, unit}} of each metric whose reader finds something."""
    out = {}
    for entry in entries:
        value = load_reader(entry["name"])(run)
        if value is not None:
            out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


def emit(obj: dict, stream=None) -> None:
    print(json.dumps(obj), file=stream or sys.stdout, flush=True)


@dataclasses.dataclass
class Prepared:
    """A cell set up in this process: its graph (host arrays), the port's
    `Graph` and layout, and ``call``, the entry a job goes through."""

    graph: dict
    info: dict
    setup: Dict[str, float]
    call: Callable
    warmup_steps: int


def prepare(cell: Cell, seed: int, device, t0: float) -> Prepared:
    """Set-up: the context, the graph from the seed, the port's layout and
    one warm-up job; ``setup`` holds its seconds from ``t0``."""
    import torch

    from partbench import graphgen
    from repro_torch.core.device_graph import prepare_device_graph
    from repro_torch.core.runner import run_partitioner
    from repro_torch.graphs.csr import Graph

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, traffic = cell.config, cell.traffic
    algo, k, nb = traffic["algo"], int(cfg["k"]), int(cfg["n_blocks"])

    def sync():
        if cuda:
            torch.cuda.synchronize()

    torch.zeros(1, device=dev)
    sync()
    t_ctx = time.perf_counter()
    graph = graphgen.make_graph(cfg["graph"], derive(seed, "graph"), dev)
    sync()
    t_graph = time.perf_counter()
    if cuda:
        # the generator's temporaries are the benchmark's, not the program's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    g = Graph(**graph)
    dg = prepare_device_graph(g, n_blocks=nb, device=dev)
    sync()
    t_layout = time.perf_counter()
    kw = dict(dg=dg, epsilon=float(cfg["epsilon"]), n_blocks=nb, device=dev.type,
              **traffic.get("rule", {}))

    def call(**extra):
        return run_partitioner(algo, g, k, **{**kw, **extra})

    warm = call(seed=derive(seed, "warmup"))
    t_first = time.perf_counter()
    setup = {"setup_s": t_first - t0, "context_s": t_ctx - t0, "graph_s": t_graph - t_ctx,
             "layout_s": t_layout - t_graph, "warmup_s": t_first - t_layout}
    block_live = np.diff(graph["adj_ptr"][np.minimum(np.arange(dg.n_blocks + 1) * dg.block_v,
                                                     g.n)]).tolist()
    info = {"n": g.n, "m": g.m, "entries": int(graph["adj_idx"].size), "n_pad": dg.n_pad,
            "block_v": dg.block_v, "n_blocks": dg.n_blocks, "block_live": block_live,
            "degrees": graphgen.degree_stats(graph["deg_out"])}
    return Prepared(graph=graph, info=info, setup=setup, call=call, warmup_steps=warm.steps)


def execute(cell: Cell, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
            t0: Optional[float] = None, states_hook: Optional[Callable] = None) -> dict:
    """Run ``cell`` once and return its result object (the last line)."""
    import torch

    from repro_torch.utils.provenance import bench_provenance

    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    algo, k = cell.traffic["algo"], int(cell.config["k"])
    prep = prepare(cell, seed, dev, t0)
    graph, info, setup, call = prep.graph, prep.info, prep.setup, prep.call
    t_first = t0 + setup["setup_s"]
    emit({"provenance": bench_provenance(), "cell": cell.name, "seed": seed,
          "graph": {x: v for x, v in info.items() if x != "block_live"}, "setup": setup,
          "warmup_steps": prep.warmup_steps})

    jobs: List[Job] = []
    deadline = t_first + seconds
    while time.perf_counter() < deadline:
        j = len(jobs)
        job = Job(index=j, seed=derive(seed, "job", j), wall_s=0.0)
        a = time.perf_counter()
        try:
            res = call(seed=job.seed)
            job.steps, job.converged, job.labels = res.steps, res.converged, res.labels
            job.reported = (float(res.local_edges), float(res.max_norm_load))
        except Exception as e:   # a failed request is counted, not fatal
            job.error = f"{type(e).__name__}: {e}"
        job.wall_s = time.perf_counter() - a
        jobs.append(job)
        if job.error:
            break
    window_s = time.perf_counter() - t_first
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    emit({"jobs": [[j.index, j.wall_s, j.steps, j.converged] for j in jobs], "window_s": window_s,
          "memory_peak_bytes": peak})

    prof = None
    if trace:
        a = time.perf_counter()
        prof = profile_jobs(cell, call, jobs, cuda)
        emit({"profile": {"jobs": prof.jobs, "steps": prof.steps, "events": prof.events,
                          "wall_s": prof.wall_s, "untraced_s": prof.untraced_s, "busy_s": prof.busy_s,
                          "seconds": time.perf_counter() - a}})
    a = time.perf_counter()
    checks = judge(cell, graph, [j for j in jobs if j.error is None], call, seed, dev,
                   states_hook=states_hook)
    emit({"judge_s": time.perf_counter() - a,
          "job_readings": [[j.index, j.local_edges, j.max_norm_load] + list(j.reported or ())
                           for j in jobs if j.error is None]})
    run = Run(algo=algo, k=k, graph=info, setup=setup,
              jobs=[j for j in jobs if j.error is None], peak_bytes=peak, profile=prof)
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, run)
    failed = sum(j.error is not None for j in jobs)
    limits = cell.limits
    missing = sorted(set(checks) - set(limits))
    if missing:
        raise KeyError(f"cell {cell.name} has no limit for {missing}")
    correct = bool(jobs) and failed == 0 and all(checks[x] <= limits[x] for x in checks)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(jobs), "failed": failed,
              "metrics": metrics, "device": device_info}
    if prof is not None:
        device_info["busy_s"] = prof.busy_s
        device_info["window_s"] = prof.wall_s
        result["breakdown"] = prof.breakdown()
    if failed:
        result["errors"] = [j.error for j in jobs if j.error][:3]
    result["checks"] = {x: {"value": checks[x], "limit": limits[x]} for x in checks}
    return result


def profile_jobs(cell: Cell, call: Callable, jobs: List[Job], cuda: bool):
    """The window's first jobs again, whole, under `torch.profiler` and the
    port's tracer, until the traffic's event budget is spent."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from partbench import profiling
    from repro_torch.obs import Tracer

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    summary = profiling.Profile()
    budget = int(cell.traffic["profile_events"])
    for job in jobs[:int(cell.traffic["profile_jobs"])]:
        if job.error is not None:
            break
        tracer = Tracer()
        with profile(activities=acts) as p:
            a = time.perf_counter()
            res = call(seed=job.seed, trace=tracer)
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - a
        dev, host = profiling.raw_events(p)
        summary.add(dev, host, wall, res.steps, profiling.span_counts(tracer))
        summary.untraced_s += job.wall_s
        if summary.events >= budget:
            break
    return summary


def main(argv=None, t0: Optional[float] = None) -> int:
    import argparse

    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("no CUDA device: this benchmark runs on an NVIDIA GPU only", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    result = execute(cell, args.seed, args.seconds, bool(args.trace), t0=t0)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    emit(result)
    return 0
