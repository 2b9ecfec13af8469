"""The port's tracing (`repro_torch.obs`) against `repro.obs`, case for case
with tests/test_obs.py (the async-schedule cases wait for the port's
multi-GPU schedules), on the CPU:

  * tracing off (the default NULL_TRACER) leaves results bit-identical;
  * tracing on adds no blocking fetch (counted through the runner's
    `fetch`, the one helper every window fetch goes through), and neither
    do checkpoints and the state guard;
  * a traced run exports well-formed perfetto JSON with one superstep span
    per executed step that the unchanged `tools/trace_report.py --validate`
    accepts, with the span and counter names of `repro`'s trace of the same
    run, and counter series riding the drain windows;
  * the V-cycle's spans and ``level_n_vertices`` equal `repro`'s;
  * the kernel builder records a compile event per kernel.
"""
from __future__ import annotations

import importlib.util
import json
import logging
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import obs as jax_obs
from repro.core.runner import run_partitioner as jax_run_partitioner
from repro.graphs.generators import dc_sbm as jax_dc_sbm

from repro_torch import obs
from repro_torch.core import runner as runner_mod
from repro_torch.core.runner import run_partitioner
from repro_torch.graphs.generators import dc_sbm
from repro_torch.kernels import _build
from repro_torch.streaming import StreamConfig, StreamRunner, stream_from_graph

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
_TOOL = os.path.join(ROOT, "tools", "trace_report.py")
GRAPH = dict(n=256, m=2048, n_comm=4, mixing=0.25, degree_exponent=0.5, seed=5)


def _load_trace_report():
    spec = importlib.util.spec_from_file_location("trace_report", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def graph():
    return dc_sbm(**GRAPH)


def _run(graph, k, **kw):
    return run_partitioner("revolver", graph, k, device="cpu", **kw)


# --------------------------------------------------------------------------
# tracer unit mechanics
# --------------------------------------------------------------------------
def test_null_tracer_is_default_and_noop():
    assert obs.current() is obs.NULL_TRACER
    assert not obs.NULL_TRACER.enabled
    with obs.NULL_TRACER.span("x", a=1):
        pass
    with obs.annotate("edge-phase"):         # no tracer installed: no span
        pass
    obs.NULL_TRACER.counter("c", 1.0)
    obs.NULL_TRACER.compile_event("r")
    assert obs.NULL_TRACER.now_us() == 0.0


def test_use_installs_and_restores():
    t = obs.Tracer()
    with obs.use(t):
        assert obs.current() is t
        with obs.use(None):
            assert obs.current() is obs.NULL_TRACER
        assert obs.current() is t
    assert obs.current() is obs.NULL_TRACER


def test_span_nesting_and_export(tmp_path):
    t = obs.Tracer()
    with t.span("outer", run=1):
        with t.span("inner"):
            pass
    t.instant("marker", note="hi")
    t.counter("gauge", 3.0, step=0)
    path = t.save(str(tmp_path / "trace.json"))
    doc = json.loads(open(path).read())
    assert set(doc) >= {"traceEvents", "displayTimeUnit", "otherData"}
    by_name = {e["name"]: e for e in doc["traceEvents"]}
    assert by_name["inner"]["ph"] == "X" and by_name["outer"]["ph"] == "X"
    assert by_name["inner"]["ts"] >= by_name["outer"]["ts"]
    assert by_name["marker"]["ph"] == "i"
    assert by_name["gauge"]["ph"] == "C"
    assert by_name["gauge"]["args"]["value"] == 3.0
    assert t.series["gauge"] == [(0, 3.0)]
    # the same layout `repro`'s tracer writes
    ref = jax_obs.Tracer(xprof=False)
    ref.counter("gauge", 3.0, step=0)
    assert set(ref.to_dict()) == set(doc)
    assert {k for k in ref.events[0]} == {k for k in by_name["gauge"]}


def test_recompile_cause_priority():
    t = obs.Tracer()
    t.compile_event("superstep", e_max=128, algo="revolver")
    assert t.recompiles[-1]["cause"] == "first-compile"
    t.compile_event("superstep", e_max=256, algo="revolver")
    assert t.recompiles[-1]["cause"] == "shape-change(e_max)"
    t.note_recompile_cause("e_max-repad")
    t.compile_event("superstep", e_max=512, algo="revolver")
    assert t.recompiles[-1]["cause"] == "e_max-repad"
    t.note_recompile_cause("halo-widen")
    t.clear_recompile_cause()
    t.compile_event("superstep", e_max=512, algo="spinner")
    assert t.recompiles[-1]["cause"] == "shape-change(algo)"
    assert t.series["recompiles"][-1][1] == 4.0


def test_annotate_tags_dispatch_time():
    """`repro`'s annotate spans fire at jit trace time; the port's time the
    host dispatch of every call, and open a profiler range of the same
    name."""
    t = obs.Tracer()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.use(t):
            with obs.annotate("edge-phase", kernel="fused_edge_phase"):
                torch.ones(4).sum()
    ev = [e for e in t.events if e["name"] == "edge-phase"]
    assert len(ev) == 1 and ev[0]["args"]["during"] == "dispatch"
    assert ev[0]["args"]["kernel"] == "fused_edge_phase"
    assert "edge-phase" in {e.key for e in prof.key_averages()}


def test_kernel_build_records_a_compile_event(monkeypatch):
    """The port's counterpart of `record_compile` in a jitted body: a
    kernel's first use in a process (its nvcc build or its cached
    library's load) is one compile event named after the kernel."""
    fake = types.SimpleNamespace(edge_phase_launch=types.SimpleNamespace(),
                                 repro_error_string=types.SimpleNamespace())
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build", lambda names: {n: "ptxas" for n in names})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: fake)
    t = obs.Tracer()
    with obs.use(t):
        assert _build.load("edge_phase") is fake
        assert _build.load("edge_phase") is fake       # cached: no event
    assert [(r["region"], r["cause"], r["built"]) for r in t.recompiles] == [
        ("edge_phase", "first-compile", True)]
    assert t.series["recompiles"] == [(None, 1.0)]
    assert _build.load("edge_phase") is fake            # untraced: nothing
    assert len(t.recompiles) == 1


# --------------------------------------------------------------------------
# traced batch runs
# --------------------------------------------------------------------------
def test_traced_run_records_spans_and_counters(graph):
    t = obs.Tracer()
    res = _run(graph, 5, seed=1, max_steps=5, patience=10_000, trace=t)
    assert res.steps == 5
    sup = [e for e in t.events if e["name"] == "superstep" and e["ph"] == "X"]
    assert len(sup) == res.steps
    assert [e["args"]["step"] for e in sup] == list(range(res.steps))
    for name in ("local_edges", "max_norm_load", "migrations"):
        assert len(t.series[name]) == res.steps, name
        assert [s for s, _ in t.series[name]] == list(range(res.steps))
    assert [v for _, v in t.series["local_edges"]] == res.history["local_edges"]
    migs = [v for _, v in t.series["migrations"]]
    assert all(0 <= v <= graph.n for v in migs) and migs[0] > 0
    assert t.meta["runs"] == [{"algo": "revolver", "k": 5,
                               "schedule": "sequential", "steps": 5}]
    # the rules' dispatch spans: K1 and K2 once a block and superstep
    dg_blocks = 8
    phases = [e["name"] for e in t.events if e.get("args", {}).get("during") == "dispatch"]
    assert phases.count("edge-phase") == phases.count("la-update") == dg_blocks * res.steps
    summary = t.summary()
    assert summary["spans"]["superstep"]["count"] == res.steps
    json.dumps(summary)


def test_tracing_off_is_bit_identical(graph):
    kw = dict(seed=3, max_steps=4, patience=10_000, keep_probs=True)
    base = _run(graph, 4, **kw)
    traced = _run(graph, 4, trace=obs.Tracer(), **kw)
    again = _run(graph, 4, trace=None, **kw)
    np.testing.assert_array_equal(base.labels, traced.labels)
    np.testing.assert_array_equal(base.labels, again.labels)
    np.testing.assert_array_equal(base.probs, traced.probs)
    assert base.history == traced.history == again.history
    assert base.local_edges == traced.local_edges
    assert base.max_norm_load == traced.max_norm_load


@pytest.mark.parametrize("extra", ["trace", "trace+checkpoints+guard"])
def test_tracer_adds_no_device_syncs(graph, monkeypatch, tmp_path, extra):
    """The traced loop issues exactly as many blocking fetches as the
    untraced one — counters, the guard's checks and the checkpoint
    snapshot ride the existing windows."""
    counts = []
    real = runner_mod.fetch

    def counting(groups):
        counts[-1] += 1
        return real(groups)

    kw = dict(seed=2, max_steps=6, patience=10_000, sync_every=3, track_history=True)
    monkeypatch.setattr(runner_mod, "fetch", counting)
    counts.append(0)
    plain = _run(graph, 4, **kw)
    untraced = counts[-1]
    counts.append(0)
    more = {"trace": obs.Tracer()}
    if extra != "trace":
        more.update(checkpoint_dir=str(tmp_path), checkpoint_every=3, guard="raise")
    res = _run(graph, 4, **more, **kw)
    assert untraced == 4                       # 2 windows x (scores + metrics)
    assert counts[-1] == untraced
    np.testing.assert_array_equal(res.labels, plain.labels)
    if extra != "trace":
        assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000006"]


@pytest.mark.parametrize("algo", ["spinner", "restream"])
def test_trace_kwarg_smoke_other_schedules(graph, algo):
    t = obs.Tracer()
    res = run_partitioner(algo, graph, 4, seed=0, max_steps=3, patience=10_000,
                          trace=t, device="cpu")
    assert t.meta["runs"][0]["algo"] == algo
    assert t.summary()["spans"]["superstep"]["count"] == res.steps
    # K3 once a Spinner superstep, once a block and restream superstep
    per_step = 1 if algo == "spinner" else 8
    assert t.summary()["spans"]["edge-phase"]["count"] == per_step * res.steps


def _names(doc, ph):
    # compile events are left out: `repro`'s fire per jit cache miss (which
    # depends on what the process ran before), the port's per kernel build,
    # which the CPU never makes
    return {e["name"] for e in doc["traceEvents"] if e["ph"] == ph} - {"recompiles", "recompile"}


def test_span_and_counter_names_match_reference():
    """A flat sequential Revolver run on the same graph: the port's trace
    carries `repro`'s span and counter names, one superstep span per step
    each, and both pass `tools/trace_report.py --validate`."""
    tr = _load_trace_report()
    ours, ref = obs.Tracer(), jax_obs.Tracer()
    res = run_partitioner("revolver", dc_sbm(**GRAPH), 4, seed=0, max_steps=6,
                          sync_every=3, trace=ours, device="cpu")
    jres = jax_run_partitioner("revolver", jax_dc_sbm(**GRAPH), 4, seed=0,
                               max_steps=6, sync_every=3, trace=ref)
    a, b = ours.to_dict(), ref.to_dict()
    assert _names(a, "X") == _names(b, "X")
    assert _names(a, "C") == _names(b, "C")
    assert ours.summary()["spans"]["superstep"]["count"] == res.steps
    assert ref.summary()["spans"]["superstep"]["count"] == jres.steps
    assert a["otherData"]["runs"] == b["otherData"]["runs"]
    assert tr.validate(a) == [] and tr.validate(b) == []


def test_vcycle_trace_matches_reference():
    """The V-cycle's spans, its ``level_n_vertices`` counters and
    ``otherData.vcycle`` level sizes equal `repro`'s on the same graph."""
    ours, ref = obs.Tracer(), jax_obs.Tracer()
    kw = dict(seed=0, mode="vcycle", coarse_n=64, max_steps=30)
    res = run_partitioner("revolver", dc_sbm(**GRAPH), 4, trace=ours, device="cpu", **kw)
    jax_run_partitioner("revolver", jax_dc_sbm(**GRAPH), 4, trace=ref, **kw)
    assert ours.series["level_n_vertices"] == ref.series["level_n_vertices"]
    assert [v for _, v in ours.series["level_n_vertices"]] == res.vcycle["level_n_vertices"]
    spans = lambda t: {n for n in t.summary()["spans"]  # noqa: E731
                       if n in ("coarsen", "coarse-solve") or n.startswith("uncoarsen")}
    assert spans(ours) == spans(ref) and len(spans(ours)) == len(res.vcycle["budgets"]) + 1
    assert ours.meta["vcycle"][0]["level_n_vertices"] == ref.meta["vcycle"][0]["level_n_vertices"]
    assert ours.meta["vcycle"][0]["budgets"] == ref.meta["vcycle"][0]["budgets"]
    assert _load_trace_report().validate(ours.to_dict()) == []


# --------------------------------------------------------------------------
# streaming
# --------------------------------------------------------------------------
class _NotingTracer(obs.Tracer):
    """A tracer that also keeps every pre-registered recompile cause."""

    def __init__(self):
        super().__init__()
        self.noted = []

    def note_recompile_cause(self, cause):
        self.noted.append(cause)
        super().note_recompile_cause(cause)


def _stream_parts(graph, trace=None, deltas=4):
    cfg = StreamConfig(k=4, n_blocks=8, refine_max_steps=5, refine_patience=10_000)
    runner = StreamRunner(graph.n, cfg, seed=7, trace=trace, device="cpu")
    runner.run(stream_from_graph(graph, deltas, seed=0))
    return runner


def test_streaming_traced_bit_identical_and_attributed(graph):
    t = _NotingTracer()
    traced = _stream_parts(graph, trace=t)
    base = _stream_parts(graph)
    np.testing.assert_array_equal(base.labels, traced.labels)
    assert [r.local_edges for r in base.reports] == [r.local_edges for r in traced.reports]
    assert t.summary()["spans"]["delta"]["count"] == 4
    sup_steps = [e["args"]["step"] for e in t.events
                 if e["name"] == "superstep" and e["ph"] == "X"]
    assert sup_steps == list(range(traced.total_steps))
    assert len(t.series["delta_dirty_blocks"]) == 4
    assert len(t.series["delta_m"]) == 4
    assert t.series["delta_m"][-1][1] == traced.reports[-1].m
    repads = [r for r in traced.reports[1:] if r.repadded]
    assert repads, "fixture stream no longer re-pads; enlarge the deltas"
    # each re-pad after the first delta registers its cause; on the CPU no
    # kernel is built, so none is consumed and every one is cleared
    assert t.noted == ["e_max-repad"] * len(repads)
    assert t.recompiles == [] and t._pending_causes == []
    assert sum(r["steps"] for r in t.meta["runs"]) == traced.total_steps
    assert _load_trace_report().validate(t.to_dict()) == []


def test_streaming_untraced_repad_is_silent(graph, caplog):
    """`repro` warns that an untraced re-pad recompiles the jitted
    superstep; the port compiles nothing per shape, so it has nothing to
    warn about."""
    with caplog.at_level(logging.WARNING, logger="repro_torch"):
        runner = _stream_parts(graph)
    assert any(r.repadded for r in runner.reports[1:])
    assert not [r for r in caplog.records if "recompile" in r.getMessage()]


# --------------------------------------------------------------------------
# trace_report tool
# --------------------------------------------------------------------------
def test_trace_report_validates_real_trace(graph, tmp_path):
    tr = _load_trace_report()
    t = obs.Tracer()
    _run(graph, 4, seed=0, max_steps=3, patience=10_000, trace=t)
    path = str(tmp_path / "trace.json")
    t.save(path)
    doc = tr.load(path)
    assert tr.validate(doc) == []
    assert "superstep" in tr.report(doc)
    assert tr.main([path, "--validate"]) == 0
    # the tool as a program (stdlib only), as the card's smoke run calls it
    out = subprocess.run([sys.executable, _TOOL, path, "--validate"],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.startswith("OK"), out.stderr


def test_trace_report_rejects_corrupted(graph, tmp_path):
    tr = _load_trace_report()
    t = obs.Tracer()
    _run(graph, 4, seed=0, max_steps=3, patience=10_000, trace=t)
    doc = t.to_dict()
    pruned = dict(doc)
    pruned["traceEvents"] = [e for e in doc["traceEvents"] if e["name"] != "superstep"]
    assert any("superstep" in p for p in tr.validate(pruned))
    broken = dict(doc)
    broken["traceEvents"] = doc["traceEvents"] + [{"name": "x", "ph": "X"}]
    assert any("missing" in p for p in tr.validate(broken))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([1, 2, 3]))
    with pytest.raises(ValueError):
        tr.load(str(bad))
    assert tr.main([str(bad), "--validate"]) == 2


def test_resumed_run_trace_validates(graph, tmp_path):
    """A resumed run's trace counts only the steps it executed, so it
    validates too."""
    tr = _load_trace_report()
    kw = dict(seed=0, max_steps=9, patience=10_000, sync_every=3,
              checkpoint_dir=str(tmp_path), checkpoint_every=3)
    _run(graph, 4, **dict(kw, max_steps=6))
    t = obs.Tracer()
    res = _run(graph, 4, resume=True, trace=t, **kw)
    assert res.resumed_from == 6 and res.steps == 9
    assert t.meta["runs"][0]["steps"] == 3
    assert [e["name"] for e in t.events if e["ph"] == "i"] == ["resumed"]
    assert tr.validate(t.to_dict()) == []
