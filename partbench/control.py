"""Readings that set the limits of ``correct``, at a cell's own size.

    python3 partbench/control.py --workload <cell> --seed <n> [--follows 12]
        [--controls 3]

sets the cell up once (its graph from ``--seed``, the port's layout) and
prints one JSON line per reading, then a summary line:

  * ``program``: the program's own numbers on ``--follows`` followed jobs
    and on ``--follows`` whole jobs (`harness.recount`'s ``load_max``,
    ``chance_ratio`` and ``self_gap``): the lower readings;
  * ``control``: the reference at bfloat16, the precision below the
    configuration's float32, put in the program's place (`control_hook`),
    on ``--controls`` followed jobs;
  * ``fault:<name>``: the program with a fault planted under its entry
    (`FAULTS`), on ``--controls`` followed jobs and whole jobs each.

The benchmark's own runs never run this. Its numbers are what `PERF.md`
sets each limit in ``cells/<cell>.json`` from.
"""
from __future__ import annotations

import contextlib
import pathlib
import sys
import time

if __name__ == "__main__":
    _ROOT = pathlib.Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

from partbench import harness  # noqa: E402


def _unchanged(orig):
    """A superstep that returns its state unchanged."""
    def step(algo, dg, cfg, state, **kw):
        return state._replace(step=state.step + 1)
    return step


def _half(orig):
    """A superstep that leaves the upper half of the vertices out: their
    labels, lambda and probabilities keep their values from before it."""
    def step(algo, dg, cfg, state, **kw):
        keep = {f: getattr(state, f).clone() for f in algo.vertex_fields + algo.block_fields}
        new = orig(algo, dg, cfg, state, **kw)
        for f, old in keep.items():
            cut = old.shape[0] // 2
            getattr(new, f)[cut:] = old[cut:]
        return new
    return step


def _altered(orig):
    """A superstep whose answer is altered where it is made: vertex 0's new
    label moved to the next part."""
    def step(algo, dg, cfg, state, **kw):
        new = orig(algo, dg, cfg, state, **kw)
        new.labels[0] = (new.labels[0] + 1) % cfg.k
        return new
    return step


def _start(orig):
    """A start that leaves half of the vertices out: the upper half keep
    label 0 instead of their random draw."""
    def init(dg, cfg, gen):
        from repro_torch.core import engine

        state = orig(dg, cfg, gen)
        state.labels[state.labels.shape[0] // 2:] = 0
        return state._replace(loads=engine.loads_from_labels(dg, cfg.k, state.labels))
    return init


def _reported(orig):
    """A partition altered where the entry hands it out: the upper half of
    the vertices' labels set to part 0 on their way back to the caller."""
    def to_original(dg, x):
        out = orig(dg, x)
        if out.dim() == 1 and not out.is_floating_point():
            out = out.clone()
            out[out.shape[0] // 2:] = 0
        return out
    return to_original


# faults planted under a superstep, one under the start, one at the result
FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered, "start": _start,
          "reported": _reported}


@contextlib.contextmanager
def planted(name: str):
    """The program with fault ``name`` under its entry. The runner calls
    the engine's ``superstep`` through the module, so replacing it there
    breaks every superstep of every job; the start fault wraps each
    registered rule's ``init`` instead, and the result fault the runner's
    map of labels back to the caller's vertex order."""
    from repro_torch.core import engine, registry, runner

    if name == "reported":
        orig = runner.vertices_to_original
        runner.vertices_to_original = _reported(orig)
        try:
            yield
        finally:
            runner.vertices_to_original = orig
        return

    if name == "start":
        algos = [registry.get_algorithm(a) for a in ("revolver", "spinner", "restream")]
        origs = [a.init for a in algos]
        for a, orig in zip(algos, origs):
            object.__setattr__(a, "init", _start(orig))
        try:
            yield
        finally:
            for a, orig in zip(algos, origs):
                object.__setattr__(a, "init", orig)
        return
    orig = engine.superstep
    engine.superstep = FAULTS[name](orig)
    try:
        yield
    finally:
        engine.superstep = orig


def readings(cell: harness.Cell, seed: int, follows: int, controls: int, device="cuda"):
    """Yield one reading dict at a time (see the module docstring)."""
    import torch

    prep = harness.prepare(cell, seed, torch.device(device), time.perf_counter())
    dev = torch.device(device)

    def whole(tag, n):
        """`harness.recount` over ``n`` whole jobs, with the lowest share
        of local edges and the mean supersteps among them."""
        jobs = []
        for j in range(n):
            res = prep.call(seed=harness.derive(seed, tag, j))
            jobs.append(harness.Job(index=j, seed=0, wall_s=0.0, steps=res.steps,
                                    labels=res.labels,
                                    reported=(float(res.local_edges), float(res.max_norm_load))))
        out = harness.recount(cell, prep.graph, jobs, dev)
        out["local_edges_min"] = min(j.local_edges for j in jobs)
        out["steps_mean"] = sum(j.steps for j in jobs) / n
        return out

    yield {"kind": "setup", **prep.setup}
    for i in range(follows):
        yield {"kind": "program", "i": i,
               **harness.follow_job(cell, prep.graph, prep.call, harness.derive(seed, "p", i), dev)}
    yield {"kind": "program", "whole": follows, **whole("pj", follows)}
    hook = harness.control_hook(cell, torch.bfloat16)
    for i in range(controls):
        yield {"kind": "control", "i": i,
               **harness.follow_job(cell, prep.graph, prep.call, harness.derive(seed, "c", i),
                                    dev, states_hook=hook)}
    for name in FAULTS:
        with planted(name):
            for i in range(controls):
                yield {"kind": f"fault:{name}", "i": i,
                       **harness.follow_job(cell, prep.graph, prep.call,
                                            harness.derive(seed, "f", name, i), dev)}
            yield {"kind": f"fault:{name}", "whole": controls, **whole(("fj", name), controls)}


def summarize(rows: list) -> dict:
    """Per kind, the largest and the smallest reading of each number."""
    out: dict = {}
    for row in rows:
        for key, v in row.items():
            if key in ("kind", "i") or not isinstance(v, (int, float)) or row["kind"] == "setup":
                continue
            lo_hi = out.setdefault(row["kind"], {}).setdefault(key, [v, v])
            lo_hi[0], lo_hi[1] = min(lo_hi[0], v), max(lo_hi[1], v)
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--follows", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    rows = []
    for row in readings(cell, args.seed, args.follows, args.controls):
        rows.append(row)
        harness.emit(row)
    harness.emit({"summary": summarize(rows), "cell": cell.name, "seed": args.seed})
    return 0


if __name__ == "__main__":
    sys.exit(main())
