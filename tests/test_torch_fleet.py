"""The port's fleet simulator and scenario API against the JAX package's, on
the CPU.

* Timing only: the port's ``Simulation`` of ``smoke-lm``, ``coop`` and
  ``smoke-mobility`` reproduces ``tests/goldens/*.json`` (summary and
  handover log) exactly, with the reference's roofline constants put into
  ``repro_torch.sim.build`` (the port's own are the H100's).  The goldens
  are read, never written.
* Real decode: on the reference arena suite's static scenario
  (``tests/test_arena.py::_static_spec``), with the reference's parameters
  swapped into the port's built scenario, the port and the reference give
  equal summaries, token streams (margin rule: a stream may part only
  where the port's serial token is a near-tie) and arena and decode
  counters, for the arena and for batched decode without it.
* A port-only mobile run (``_mobile_spec``) hands requests over mid-stream
  and its arena run equals its serial run.
* ``engine.dtype`` names a torch dtype, and a real-decode spec needs a
  card unless the caller asks for the CPU.  (``calibration``,
  ``engine.trace``/``engine.timeline`` and ``topology.shards > 1`` are
  ported: ``tests/test_torch_{calib,obs,shard}.py``.)
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import repro.config as ref_config
import repro_torch.sim.build as sim_build
from repro.sim import Simulation as RefSimulation
from repro_torch.models.convert import params_from_numpy
from repro_torch.sim import EngineSpec, ScenarioSpec, Simulation, get_scenario
from test_arena import _mobile_spec, _static_spec

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
MARGIN_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs files
    side by side in worker processes on a shared CPU, where wall-clock
    tests in other files feel oversubscription."""
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


def _port_spec(spec):
    """The reference's spec as the port's: both serialise to one JSON."""
    return ScenarioSpec.from_json(spec.to_json())


# ------------------------------------------------------------- goldens
@pytest.mark.parametrize("how", ["spec", "elasticity-off"])
@pytest.mark.parametrize("name", ["smoke-lm", "coop", "smoke-mobility"])
def test_timing_only_runs_equal_goldens(name, how):
    """The registered scenario as it is, and with elasticity explicitly
    off after a JSON round trip (the reference's elastic suite's pin):
    byte-identical summary and handover log."""
    spec = get_scenario(name)
    if how == "elasticity-off":
        spec = ScenarioSpec.from_json(
            dataclasses.replace(spec, autoscale=None, admission=None).to_json())
    assert spec.autoscale is None and spec.admission is None
    m = Simulation(spec).run()
    got = json.loads(json.dumps(
        {"scenario": name, "summary": m.summary(),
         "handover_log": [list(h) for h in m.handover_log]},
        sort_keys=True))
    with open(os.path.join(GOLDEN_DIR, f"{name}.json")) as f:
        want = json.load(f)
    assert got == want


# ------------------------------------------------------------- real decode
def _ref_run(spec):
    sim = RefSimulation(spec)
    m = sim.run()
    toks = {r.rid: list(r.tokens) for r in sim.scenario.workload}
    params = jax.tree_util.tree_map(np.asarray, sim.scenario.params)
    return m.summary(), toks, sim.scenario.engine.stepper.cache_stats(), params


def _record_margins(engine):
    """Per request, the top-2 logit margin of each token the engine's
    serial path picks (after its prefill, then after each decode step)."""
    margins = {}
    argmax, prefill, decode = engine._argmax, engine._prefill_real, engine._decode_real

    def rec(h):
        top2 = engine.model.logits(engine.params, h)[:, -1].topk(2, dim=-1).values
        rec.last = (top2[:, 0] - top2[:, 1]).tolist()[0]
        return argmax(h)

    def pre(req):
        prefill(req)
        margins[req.rid] = [rec.last]

    def dec(req):
        decode(req)
        margins[req.rid].append(rec.last)
    engine._argmax, engine._prefill_real, engine._decode_real = rec, pre, dec
    return margins


def _port_run(spec, ref_params, margins=False):
    sim = Simulation(_port_spec(spec), device="cpu")
    sc = sim.build()
    sc.params = sc.engine.params = params_from_numpy(sc.cfg, ref_params,
                                                     device="cpu")
    recorded = _record_margins(sc.engine) if margins else None
    m = sc.engine.run(sc.workload)
    toks = {r.rid: list(r.tokens) for r in sc.workload}
    return m.summary(), toks, sc.engine.stepper.cache_stats(), recorded


def _held(want, got, margins):
    """Token streams equal request by request, except from a token whose
    serial pick was a near-tie: a stream may part at decode step k only if
    step k's own token (margins[k + 1]; margins[0] is the prefill's, one
    B=1 path in every strategy) had a top-2 margin below MARGIN_TOL."""
    assert want.keys() == got.keys()
    for rid, w in want.items():
        g = got[rid]
        assert len(g) == len(w)
        k = next((j for j, (a, b) in enumerate(zip(w, g)) if a != b), None)
        if k is not None:
            m = margins[rid][k + 1]
            assert m < MARGIN_TOL, (
                f"request {rid}: token {k} is {g[k]}, want {w[k]} "
                f"(margin {m})")


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's static real-decode fleet, arena on and batched with
    arena off, run once."""
    return {"arena": _ref_run(_static_spec(True)),
            "batched": _ref_run(_static_spec(False))}


@pytest.fixture(scope="module")
def port_serial(reference_runs):
    """The port's serial run (batch_decode and arena off) with the
    reference's parameters, and its margins."""
    params = reference_runs["arena"][3]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sim_build, "PEAK_FLOPS", ref_config.PEAK_FLOPS_BF16)
        mp.setattr(sim_build, "HBM_BW", ref_config.HBM_BW)
        return _port_run(_static_spec(False, batch=False), params, margins=True)


@pytest.mark.parametrize("strategy", ["arena", "batched"])
def test_real_decode_fleet_equals_reference(reference_runs, port_serial,
                                            strategy):
    """Same summaries, token streams and arena/decode counters as the
    reference on the same parameters; the arena replaces the batched path
    and pads nothing, with one arena variant per model exit at most."""
    hold_against_reference(reference_runs[strategy], port_serial,
                           _static_spec(strategy == "arena"), strategy)


def hold_against_reference(reference_run, port_serial, spec, strategy):
    """The port's run of ``spec`` (``strategy``: "arena" or "batched") on
    the reference's parameters against the reference's run of it and the
    port's serial run (see test_real_decode_fleet_equals_reference)."""
    ref_summary, ref_toks, ref_stats, params = reference_run
    summary, toks, stats, _ = _port_run(spec, params)
    assert json.dumps(summary, sort_keys=True) == \
        json.dumps(ref_summary, sort_keys=True)
    _held(ref_toks, toks, port_serial[3])
    _held(port_serial[1], toks, port_serial[3])
    assert stats["arena"] == ref_stats["arena"]
    assert stats["decode"] == ref_stats["decode"]
    if strategy == "arena":
        ar = stats["arena"]
        assert ar["calls"] > 0 and ar["admits"] == ar["evicts"] > 0
        assert stats["decode"]["padded_rows"] == 0
        assert stats["decode"]["batched_calls"] == 0
        assert stats["jit"]["variants"]["arena"] == \
            ref_stats["jit"]["variants"]["arena"]
    else:
        assert stats["decode"]["batched_calls"] > 0
        assert stats["decode"]["padded_rows"] > 0
    assert json.dumps(port_serial[0], sort_keys=True) == \
        json.dumps(summary, sort_keys=True)


def test_mobile_arena_equals_serial_under_handover():
    """A mobile BOCD fleet that hands requests over mid-stream (extract ->
    ship -> re-admit): the arena run's summary equals the serial run's and
    its tokens hold against them."""
    serial = Simulation(_port_spec(_mobile_spec(False)), device="cpu")
    sc = serial.build()
    margins = _record_margins(sc.engine)
    m_off = sc.engine.run(sc.workload)
    t_off = {r.rid: list(r.tokens) for r in sc.workload}
    arena = Simulation(_port_spec(_mobile_spec(True)), device="cpu")
    m_on = arena.run()
    t_on = {r.rid: list(r.tokens) for r in arena.scenario.workload}
    s_off, s_on = m_off.summary(), m_on.summary()
    assert s_off.get("handovers", 0) > 0
    assert json.dumps(s_on, sort_keys=True) == json.dumps(s_off, sort_keys=True)
    _held(t_off, t_on, margins)
    st = arena.scenario.engine.stepper.cache_stats()
    assert st["arena"]["calls"] > 0 and st["decode"]["padded_rows"] == 0


# ------------------------------------------------------------- spec options
def test_engine_dtype_names_a_torch_dtype():
    spec = get_scenario("smoke-lm")
    bad = dataclasses.replace(spec, engine=EngineSpec(dtype="int4x"))
    with pytest.raises(ValueError, match="engine dtype"):
        Simulation(bad).build()
    ok = dataclasses.replace(spec, engine=EngineSpec(dtype="bfloat16"))
    assert Simulation(ok).build().engine.dtype is torch.bfloat16


def test_real_decode_needs_a_card_unless_asked_for_the_cpu():
    """A model-executing spec resolves its device: ``"cuda"`` (the default)
    raises on a host without a card; a timing-only spec needs none."""
    spec = dataclasses.replace(_static_spec(True), name="cuda-default")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Simulation(_port_spec(spec)).build()
    Simulation(get_scenario("smoke-lm")).build()
