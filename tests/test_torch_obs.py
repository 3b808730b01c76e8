"""The port's observability stack (``repro_torch.obs``) against the JAX
package's (``repro.obs``), on the CPU.

Timing-only specs, with the reference's roofline constants put into
``repro_torch.sim.build`` (the port's own are the H100's):

* observer neutrality: summaries and handover logs bit-identical with the
  tracer, the timeline and the profiler on or off, and equal to the
  reference's;
* the trace: valid, spans nested in their request's lifetime, timestamps
  monotone per edge track, and its event list equal to the reference's
  trace of the same spec;
* the timeline JSONL equal to the reference's, byte for byte;
* the ring overwrite, the profiler's report schema against the
  reference's, and ``python -m repro_torch.obs report|validate`` output
  equal to the reference's CLI on the same artifacts.
"""
import json
from dataclasses import replace

import numpy as np
import pytest
import torch

import repro.config as ref_config
import repro_torch.sim.build as sim_build
from repro.obs import SimProfiler as RefSimProfiler
from repro.obs import Timeline as RefTimeline
from repro.obs import Tracer as RefTracer
from repro.obs.report import main as ref_obs_main
from repro.sim import Simulation as RefSimulation
from repro_torch.obs import (EDGE_GAUGES, SimProfiler, Timeline, Tracer,
                             load_timeline, load_trace, validate_trace)
from repro_torch.obs.report import main as obs_main
from repro_torch.sim import (EngineSpec, MobilitySpec, PlannerSpec, RouterSpec,
                             ScenarioSpec, Simulation, TopologySpec,
                             WorkloadSpec, get_scenario)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def reference_constants(monkeypatch):
    """The reference's roofline constants in the port's sim builder: they
    decide which layers are compute-bound, and so every virtual time."""
    monkeypatch.setattr(sim_build, "PEAK_FLOPS", ref_config.PEAK_FLOPS_BF16)
    monkeypatch.setattr(sim_build, "HBM_BW", ref_config.HBM_BW)


def _small_mobility_spec(seed=7):
    return ScenarioSpec(
        name="obs-mobility", seed=seed,
        planner=PlannerSpec(result_kb=4.0),
        topology=TopologySpec(kind="mobile", num_devices=10, num_edges=3,
                              speed=0.5, horizon_s=40.0, floor_mbps=0.1,
                              noise_sigma=0.08),
        workload=WorkloadSpec(rate_hz=6.0, horizon_s=8.0),
        router=RouterSpec(name="nearest"),
        mobility=MobilitySpec(policy="bocd"))


def _static_spec():
    """A fleet with no sampling sweep: the timeline takes 'obs' ticks."""
    return ScenarioSpec(
        name="obs-static", seed=3,
        topology=TopologySpec(num_devices=8, num_edges=2),
        workload=WorkloadSpec(rate_hz=10.0, horizon_s=5.0),
        engine=EngineSpec(timeline_dt=0.25))


SPECS = {"smoke-lm": lambda: get_scenario("smoke-lm"),
         "smoke-mobility": lambda: get_scenario("smoke-mobility"),
         "obs-mobility": _small_mobility_spec,
         "obs-static": _static_spec}


def _ref_spec(spec):
    from repro.sim import ScenarioSpec as RefSpec
    return RefSpec.from_json(spec.to_json())


def _observed(spec, tmp, tag):
    return replace(spec, engine=replace(
        spec.engine, trace=str(tmp / f"{tag}.json"),
        timeline=str(tmp / f"{tag}.jsonl")))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per spec name, once: the port's unobserved and observed runs and
    the reference's observed run, with their artifacts on disk."""
    cache = {}

    def get(name):
        if name not in cache:
            tmp = tmp_path_factory.mktemp(name)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(sim_build, "PEAK_FLOPS", ref_config.PEAK_FLOPS_BF16)
                mp.setattr(sim_build, "HBM_BW", ref_config.HBM_BW)
                spec = SPECS[name]()
                base = Simulation(spec).run()
                sim = Simulation(_observed(spec, tmp, "port"))
                observed = sim.run()
            ref_sim = RefSimulation(_ref_spec(_observed(spec, tmp, "ref")))
            ref = ref_sim.run()
            cache[name] = dict(tmp=tmp, base=base, sim=sim, observed=observed,
                               ref_sim=ref_sim, ref=ref)
        return cache[name]
    return get


# ------------------------------------------------------ observer neutrality
@pytest.mark.parametrize("name", sorted(SPECS))
def test_observer_neutrality_and_reference_summary(runs, name):
    """Summaries and handover logs bit-identical with the tracer and the
    timeline attached, and equal to the reference's observed run."""
    r = runs(name)
    assert r["observed"].summary() == r["base"].summary()
    assert r["observed"].handover_log == r["base"].handover_log
    assert json.dumps(r["observed"].summary(), sort_keys=True) == \
        json.dumps(r["ref"].summary(), sort_keys=True)
    assert [list(h) for h in r["observed"].handover_log] == \
        [list(h) for h in r["ref"].handover_log]
    assert r["sim"].scenario.engine.event_counts == \
        r["ref_sim"].scenario.engine.event_counts


@pytest.mark.parametrize("policy", ["none", "bocd", "oracle"])
def test_all_three_observers_are_neutral(policy):
    """The reference's property test at fixed draws: tracer, timeline and
    profiler attached by hand to a built engine change nothing."""
    spec = ScenarioSpec(
        name="obs-prop", seed=11 + len(policy),
        planner=PlannerSpec(result_kb=4.0),
        topology=TopologySpec(kind="mobile", num_devices=6, num_edges=2,
                              speed=0.5, horizon_s=30.0),
        workload=WorkloadSpec(rate_hz=5.0, horizon_s=5.0),
        router=RouterSpec(name="nearest"),
        mobility=MobilitySpec(policy=policy))
    base = Simulation(spec).run()
    sc = Simulation(spec).build()
    sc.engine.tracer = Tracer()
    sc.engine.timeline = Timeline(2, num_devices=6)
    sc.engine.profiler = SimProfiler()
    observed = sc.engine.run(sc.workload)
    assert observed.summary() == base.summary()
    assert observed.handover_log == base.handover_log
    assert observed.summary()["requests"] > 0
    assert validate_trace(sc.engine.tracer.to_chrome()) == []


# --------------------------------------------------------------- the trace
@pytest.mark.parametrize("name", ["smoke-lm", "smoke-mobility", "obs-mobility"])
def test_trace_equals_reference(runs, name):
    """The port's trace file is valid and its event list equals the
    reference's trace of the same spec, event by event."""
    r = runs(name)
    port = load_trace(str(r["tmp"] / "port.json"))
    ref = load_trace(str(r["tmp"] / "ref.json"))
    assert validate_trace(port) == []
    assert len(port["traceEvents"]) == len(ref["traceEvents"]) > 0
    assert port == ref


def test_trace_has_all_stages(runs):
    trace = load_trace(str(runs("smoke-mobility")["tmp"] / "port.json"))
    summary = runs("smoke-mobility")["observed"].summary()
    events = trace["traceEvents"]
    assert {"queue", "uplink", "prefill", "decode", "round",
            "transfer"} <= {e["name"] for e in events if e["ph"] == "X"}
    assert {"request", "queue", "handover"} <= \
        {e["name"] for e in events if e["ph"] in ("b", "e")}
    assert {"backlog_s", "slots", "tokens_owed", "coop_inflight"} <= \
        {e["name"] for e in events if e["ph"] == "C"}
    assert sum(1 for e in events if e["ph"] == "b" and e["name"] == "request") \
        == summary["requests"]


@pytest.mark.parametrize("name", ["smoke-mobility", "obs-mobility"])
def test_trace_spans_nested_and_monotone(runs, name):
    """Every per-request X span lies inside its request's async window, no
    duration is negative, and edge tracks never go back in time."""
    events = load_trace(str(runs(name)["tmp"] / "port.json"))["traceEvents"]
    window = {}
    for e in events:
        if e["name"] == "request" and e["ph"] in ("b", "e"):
            lo, hi = window.get(e["id"], (None, None))
            window[e["id"]] = (e["ts"], hi) if e["ph"] == "b" else (lo, e["ts"])
    checked = 0
    for e in events:
        if e["ph"] != "X":
            continue
        assert e["dur"] >= 0
        rid = (e.get("args") or {}).get("rid")
        if rid in window:
            lo, hi = window[rid]
            assert lo - 1e-3 <= e["ts"] and e["ts"] + e["dur"] <= hi + 1e-3
            checked += 1
    assert checked > 0
    last_x, last_c = {}, {}
    for e in events:
        if e.get("pid", 0) >= Tracer.PID_DEVICES:
            continue
        key = (e["pid"], e["tid"]) if e["ph"] == "X" else (e["pid"], e["name"])
        last = last_x if e["ph"] == "X" else last_c if e["ph"] == "C" else None
        if last is not None:
            assert e["ts"] >= last.get(key, -1.0)
            last[key] = e["ts"]
    assert last_x and last_c


def test_rerun_event_counts_identical(runs):
    sc = runs("smoke-mobility")["sim"].scenario
    a = (sc.engine.events_processed, dict(sc.engine.event_counts))
    sc.engine.run(sc.workload)
    assert (sc.engine.events_processed, dict(sc.engine.event_counts)) == a


def test_tracer_api_equals_reference():
    """Hand-fed tracers of both packages write the same document, and the
    validator reports the same problems."""
    docs = []
    for cls in (Tracer, RefTracer):
        t = cls()
        t.complete("a", 0.0, 1.0, 0, 0)
        t.async_begin("r", 1, 0.0, 0, 0)
        t.async_end("r", 1, 2.0, 0, 0)
        t.counter("c", 0.5, 0, {"v": 1.0})
        docs.append(t.to_chrome())
    assert docs[0] == docs[1]
    assert validate_trace(docs[0]) == []
    t = Tracer()
    t.async_begin("r", 2, 3.0, 0, 0)    # left open
    assert any("unbalanced" in p for p in validate_trace(t.to_chrome()))
    assert validate_trace({}) == ["no traceEvents array"]


# ----------------------------------------------------------------- timeline
@pytest.mark.parametrize("name", ["smoke-mobility", "obs-mobility", "obs-static"])
def test_timeline_jsonl_equals_reference(runs, name):
    r = runs(name)
    port = (r["tmp"] / "port.jsonl").read_text()
    assert port == (r["tmp"] / "ref.jsonl").read_text()
    tl = r["sim"].scenario.engine.timeline
    loaded = load_timeline(str(r["tmp"] / "port.jsonl"))
    assert loaded["header"]["samples"] == tl.num_retained > 0
    assert loaded["header"]["edge_gauges"] == list(EDGE_GAUGES)
    assert np.all(np.diff(loaded["t"]) > 0)
    assert np.all(np.diff(loaded["edge"]["completed"], axis=0) >= 0)
    if name == "obs-static":
        assert r["sim"].scenario.engine.event_counts.get("obs", 0) > 0
        assert loaded["header"]["dt"] == 0.25
    else:
        n_dev = r["sim"].spec.topology.num_devices
        assert loaded["device"]["bw_bps"].shape == (tl.num_retained, n_dev)


class _Edge:
    tokens_owed = 0
    active = ()
    queue = ()
    q_dead = 0
    coop_inflight = 0
    busy_s = 0.0
    completed = 0
    capacity = 8

    def backlog_s(self):
        return 0.0


class _Topo:
    edges = [_Edge()]


def test_timeline_ring_overwrites_oldest():
    rows = []
    for cls in (Timeline, RefTimeline):
        tl = cls(1, dt=1.0, capacity=4)
        for t in range(6):
            tl.snapshot(float(t), _Topo())
        assert tl.n == 6 and tl.num_retained == 4
        rows.append(list(tl.rows()))
    assert [r["t"] for r in rows[0]] == [2.0, 3.0, 4.0, 5.0]
    assert json.dumps(rows[0], default=float) == json.dumps(rows[1], default=float)


# ----------------------------------------------------------------- profiler
def _schema(x):
    """A report's keys, nested, with the leaves' types (walls vary)."""
    if isinstance(x, dict):
        return {k: _schema(v) for k, v in x.items()}
    return type(x).__name__ if x is not None else None


def test_profiler_report_schema_equals_reference():
    """The profiler is neutral, counts every dispatched event, and its
    report has the reference's schema and the reference's deterministic
    entries (event counts, heap peak, tombstones, cache stats)."""
    spec = _small_mobility_spec()
    base = Simulation(spec).run().summary()
    reports = []
    for cls, sim_cls, s in ((SimProfiler, Simulation, spec),
                            (RefSimProfiler, RefSimulation, _ref_spec(spec))):
        sim = sim_cls(s)
        sc = sim.build()
        prof = cls()
        prof.build_s = sim.build_s
        sc.engine.profiler = prof
        summary = sc.engine.run(sc.workload).summary()
        assert json.dumps(summary, sort_keys=True) == json.dumps(base, sort_keys=True)
        rep = prof.report(sc.engine)
        assert {k: b["count"] for k, b in rep["events"].items()} == \
            dict(sc.engine.event_counts)
        reports.append(rep)
    port, ref = reports
    assert port["wall_s"] > 0 and port["build_s"] is not None
    assert 0.0 <= port["tombstone_ratio"] <= 1.0
    assert set(port["stepper_caches"]) == {"plan", "step", "hop", "jit", "decode",
                                           "arena"}
    assert _schema(port) == _schema(ref)
    for key in ("peak_heap", "tombstones", "tombstone_ratio", "stepper_caches",
                "replanner_caches"):
        assert port[key] == ref[key], key
    assert {k: b["count"] for k, b in port["events"].items()} == \
        {k: b["count"] for k, b in ref["events"].items()}


def test_profiler_reset_keeps_build_s():
    prof = SimProfiler()
    prof.build_s = 1.25
    prof.add("round", 0.5, heap_len=10)
    prof.reset()
    assert prof.run_wall_s == 0.0 and prof.peak_heap == 0
    assert prof.report()["build_s"] == 1.25


# ---------------------------------------------------------------------- CLI
@pytest.mark.parametrize("cmd,artifact", [("report", "json"), ("report", "jsonl"),
                                          ("validate", "json")])
def test_obs_cli_output_equals_reference(runs, capsys, cmd, artifact):
    """``python -m repro_torch.obs`` on the port's artifact prints what
    ``python -m repro.obs`` prints on the reference's."""
    r = runs("smoke-mobility")
    capsys.readouterr()
    assert obs_main([cmd, str(r["tmp"] / f"port.{artifact}")]) == 0
    port = capsys.readouterr().out
    assert ref_obs_main([cmd, str(r["tmp"] / f"ref.{artifact}")]) == 0
    assert port == capsys.readouterr().out
    if cmd == "report" and artifact == "json":
        for stage in ("queue", "uplink", "prefill", "decode", "transfer",
                      "handover", "request e2e", "edge utilization"):
            assert stage in port


def test_obs_validate_rejects_broken_trace_as_reference(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [
        {"name": "x", "ph": "X", "pid": 0, "tid": 0, "ts": 1.0, "dur": -5.0},
        {"name": "q", "ph": "e", "cat": "req", "id": 1, "pid": 0, "tid": 0,
         "ts": 2.0},
    ]}))
    assert obs_main(["validate", str(bad)]) == 1
    port = capsys.readouterr()
    assert "negative duration" in port.err and "async end before begin" in port.err
    assert ref_obs_main(["validate", str(bad)]) == 1
    assert capsys.readouterr() == port
