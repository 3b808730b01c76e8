"""The port's calibration loop (``repro_torch.calib``: measure -> fit ->
validate) against the JAX package's, on the CPU.

* ``CalibrationTable``: the strict JSON round trip, and one schema: a table
  (and a fitted model) saved by either package loads in the other.
* fit: the same planted tables (branch-level decode samples over the smoke
  LM's ``lm_graph``; Table-I layer samples) give the same ``theta`` and
  ``r2`` within 1e-12; the anchored planner models predict what the
  reference's predict; a calibrated ``ElasticPlanner`` plans as the
  reference's.
* ``validate_scenario("smoke-lm", table=..., run_summaries=False)``: the
  same report (plan-divergence grid equal, per-exit floats within 1e-12).
* ``Simulation`` accepts ``calibration``: a calibrated ``smoke-lm`` summary
  is JSON-equal to the reference's, with the reference's roofline
  constants in ``repro_torch.sim.build`` (the port's own are the H100's).
* ``measure_alexnet`` / ``measure_lm`` on the CPU return schema-complete
  tables that fit (the reference's fitter reads them too); both default to
  the card; ``python -m repro_torch.calib`` drives the loop.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import repro.config as ref_config
import repro_torch.sim.build as sim_build
from repro.calib import fit as ref_fit
from repro.calib import table as ref_table
from repro.calib import validate as ref_validate
from repro.runtime.elastic import TierSpec as RefTierSpec
from repro.sim import PlannerSpec as RefPlannerSpec
from repro.sim import ScenarioSpec as RefScenarioSpec
from repro.sim import Simulation as RefSimulation
from repro_torch.calib import (CalibrationTable, FittedLatencyModel,
                               TimingSample, elastic_planner_from_table,
                               fit_table, measure_alexnet, measure_lm,
                               models_from_table, validate_scenario)
from repro_torch.calib.__main__ import main as calib_main
from repro_torch.configs import get_smoke_config
from repro_torch.core.graph import lm_graph
from repro_torch.core.latency_model import RegressionLatencyModel
from repro_torch.runtime.elastic import TierSpec
from repro_torch.sim import (CalibrationSpec, PlannerSpec, ScenarioSpec,
                             Simulation, WorkloadSpec, apply_overrides,
                             get_scenario)
from test_calib import ARCH, PLANTED
from test_calib import _planted_lm_table as ref_planted_lm_table

FIT_TOL = 1e-12
KINDS = {"conv", "relu", "lrn", "pool", "dropout", "fc"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs files
    side by side in worker processes on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def reference_constants(monkeypatch):
    """The reference's roofline constants in the port's sim builder: the
    analytic models that calibration is validated against rest on them."""
    monkeypatch.setattr(sim_build, "PEAK_FLOPS", ref_config.PEAK_FLOPS_BF16)
    monkeypatch.setattr(sim_build, "HBM_BW", ref_config.HBM_BW)


def _planted_lm_table(theta, batches=(1, 2, 4)):
    """The port's twin of ``test_calib._planted_lm_table``: branch-level
    decode samples whose latencies are the planted per-kind linear model
    summed over each branch of the port's smoke ``lm_graph``."""
    cfg = get_smoke_config(ARCH)
    samples = []
    for b in batches:
        g = lm_graph(cfg, batch=b, seq=1)
        for e in range(1, g.num_exits + 1):
            t = sum(float(RegressionLatencyModel._design(l.kind, l.features)
                          @ np.asarray(theta[l.kind]))
                    for l in g.branches[e - 1])
            samples.append(TimingSample(phase="decode", latency_s=t,
                                        exit_point=e, batch=b))
    return CalibrationTable(arch=ARCH, source="synthetic", samples=samples)


def _layer_table(pkg_sample, pkg_table, seed):
    """``test_calib._check_layer_fit_recovery``'s planted Table-I samples,
    built with one package's classes; returns (table, planted theta)."""
    rng = np.random.default_rng(seed)
    kinds = {"conv": ("in_maps", "comp"), "fc": ("in_size", "out_size")}
    theta = {k: rng.uniform(1e-6, 1e-3, len(f) + 1) for k, f in kinds.items()}
    samples = []
    for kind, fnames in kinds.items():
        for _ in range(10):
            feats = {n: float(rng.uniform(1.0, 200.0)) for n in fnames}
            t = float(RegressionLatencyModel._design(kind, feats) @ theta[kind])
            samples.append(pkg_sample(phase="layer", kind=kind, features=feats,
                                      latency_s=t))
    return pkg_table(arch="branchy-alexnet", source="synthetic",
                     samples=samples), theta


def _ref_spec(spec):
    """The reference's ``PlannerSpec`` for the port's."""
    return RefPlannerSpec.from_dict(spec.to_dict())


def _close(a, b, tol=FIT_TOL):
    return math.isclose(a, b, rel_tol=tol, abs_tol=tol)


def _assert_fits_equal(got, want):
    assert got.theta.keys() == want.theta.keys()
    for k in want.theta:
        np.testing.assert_allclose(got.theta[k], want.theta[k], rtol=FIT_TOL,
                                   atol=FIT_TOL)
    assert got.r2.keys() == want.r2.keys()
    for k in want.r2:
        assert _close(got.r2[k], want.r2[k]), k


# ------------------------------------------------------ table round-trip
def _sample_tables():
    kw = dict(arch=ARCH, source="synthetic", meta={"reps": 5})
    rows = [dict(phase="decode", latency_s=1e-3, exit_point=2, batch=4, seq=8,
                 reps=5),
            dict(phase="layer", kind="conv", latency_s=2e-4,
                 features={"in_maps": 3.0, "comp": 75.0})]
    return (CalibrationTable(samples=[TimingSample(**r) for r in rows], **kw),
            ref_table.CalibrationTable(
                samples=[ref_table.TimingSample(**r) for r in rows], **kw))


def test_table_json_round_trip_is_the_reference_schema(tmp_path):
    table, ref = _sample_tables()
    d = table.to_dict()
    assert d == json.loads(json.dumps(d)) == ref.to_dict()
    assert table.to_json() == ref.to_json()
    assert CalibrationTable.from_json(table.to_json()).to_dict() == d
    p = tmp_path / "t.json"
    table.save(str(p))
    assert CalibrationTable.load(str(p)).to_dict() == d


def test_tables_saved_by_either_package_load_in_the_other(tmp_path):
    table, ref = _sample_tables()
    a, b = tmp_path / "port.json", tmp_path / "ref.json"
    table.save(str(a))
    ref.save(str(b))
    assert a.read_text() == b.read_text()
    assert ref_table.CalibrationTable.load(str(a)).to_dict() == table.to_dict()
    assert CalibrationTable.load(str(b)).to_dict() == ref.to_dict()
    fitted = fit_table(_planted_lm_table(PLANTED))
    fitted.save(str(tmp_path / "fit.json"))
    back = ref_fit.FittedLatencyModel.load(str(tmp_path / "fit.json"))
    assert back.to_dict() == fitted.to_dict()
    assert FittedLatencyModel.from_json(back.to_json()).to_dict() == fitted.to_dict()


def test_table_round_trip_is_strict():
    with pytest.raises(ValueError, match="unknown CalibrationTable"):
        CalibrationTable.from_dict({"arch": ARCH, "bogus": 1})
    with pytest.raises(ValueError, match="unknown TimingSample"):
        CalibrationTable.from_dict(
            {"arch": ARCH, "samples": [{"phase": "decode", "latency_s": 0.1,
                                        "nope": 2}]})
    with pytest.raises(ValueError, match="phase"):
        TimingSample(phase="warp", latency_s=0.1)
    with pytest.raises(ValueError, match="latency_s"):
        TimingSample(phase="decode", latency_s=-0.1)
    with pytest.raises(ValueError, match="phase"):
        CalibrationTable(arch=ARCH).by_phase("warp")
    with pytest.raises(ValueError, match="unknown FittedLatencyModel"):
        FittedLatencyModel.from_dict({"arch": ARCH, "oops": 1})


# ------------------------------------------------------------------- fit
@pytest.mark.parametrize("batches", [(1, 2, 4), (1, 2)])
def test_joint_fit_equals_reference(batches):
    table = _planted_lm_table(PLANTED, batches)
    ref = ref_planted_lm_table(PLANTED, batches)
    assert table.to_dict() == ref.to_dict()
    fitted = fit_table(table)
    _assert_fits_equal(fitted, ref_fit.fit_table(ref))
    assert set(fitted.theta) == {"block", "fc"}
    cfg = get_smoke_config(ARCH)
    for s in table.samples:
        g = lm_graph(cfg, batch=s.batch, seq=1)
        pred = sum(fitted.predict(l) for l in g.branches[s.exit_point - 1])
        assert pred == pytest.approx(s.latency_s, rel=1e-6)


def test_fit_rejects_empty_and_bad_tables():
    with pytest.raises(ValueError, match="no fittable"):
        fit_table(CalibrationTable(arch=ARCH, samples=[
            TimingSample(phase="prefill", latency_s=0.1)]))
    with pytest.raises(ValueError, match="out of range"):
        fit_table(CalibrationTable(arch=ARCH, samples=[
            TimingSample(phase="decode", latency_s=0.1, exit_point=99)]))


@pytest.mark.parametrize("anchor", [True, False])
def test_models_from_table_equal_reference(anchor):
    spec = PlannerSpec()
    f_edge, f_dev = models_from_table(_planted_lm_table(PLANTED), spec,
                                      anchor=anchor)
    r_edge, r_dev = ref_fit.models_from_table(
        ref_planted_lm_table(PLANTED), _ref_spec(spec), anchor=anchor)
    g = lm_graph(get_smoke_config(ARCH), batch=1, seq=1)
    for layer in (l for b in g.branches for l in b):
        assert _close(f_edge.predict(layer), r_edge.predict(layer))
        assert _close(f_dev.predict(layer), r_dev.predict(layer))
    full = g.branches[-1]
    if anchor:
        assert sum(f_edge.predict(l) for l in full) == \
            pytest.approx(spec.edge_step_s, rel=1e-9)
        assert sum(f_dev.predict(l) for l in full) == \
            pytest.approx(spec.device_step_s, rel=1e-9)
    else:
        assert f_dev.predict(full[0]) == pytest.approx(20.0 * f_edge.predict(full[0]))


@pytest.mark.parametrize("seed", [0, 1, 7, 1234])
def test_layer_fit_equals_reference_and_recovers_planted(seed):
    table, theta = _layer_table(TimingSample, CalibrationTable, seed)
    ref, _ = _layer_table(ref_table.TimingSample, ref_table.CalibrationTable, seed)
    fitted = fit_table(table)
    _assert_fits_equal(fitted, ref_fit.fit_table(ref))
    for kind in theta:
        np.testing.assert_allclose(fitted.theta[kind], theta[kind], rtol=1e-5,
                                   atol=1e-12)
        assert fitted.r2[kind] == pytest.approx(1.0, abs=1e-9)


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (3, 0.1), (11, 10.0), (42, 2.5)])
def test_calibrated_elastic_planner_equals_reference(seed, scale):
    """``tests/test_calib.py``'s planted thetas: the port's calibrated
    ``ElasticPlanner`` picks the reference's plans, and its exit is
    non-decreasing in bandwidth where feasible."""
    rng = np.random.default_rng(seed)
    theta = {"block": rng.uniform(1e-13, 1e-11, 3) * scale,
             "fc": rng.uniform(1e-14, 1e-12, 3) * scale}
    spec = PlannerSpec()
    ep = elastic_planner_from_table(_planted_lm_table(theta, (1, 2)), spec,
                                    link_bps=1e6)
    ref = ref_fit.elastic_planner_from_table(
        ref_planted_lm_table(theta, (1, 2)), _ref_spec(spec), link_bps=1e6)
    feasible = []
    for bw in np.logspace(4, 7, 12):
        p = ep.plan_for(TierSpec(chips=8), TierSpec(chips=1), link_bps=float(bw))
        r = ref.plan_for(RefTierSpec(chips=8), RefTierSpec(chips=1),
                         link_bps=float(bw))
        assert (p.exit_point, p.partition, p.feasible) == \
            (r.exit_point, r.partition, r.feasible)
        assert _close(p.latency_s, r.latency_s)
        if p.feasible:
            feasible.append(p.exit_point)
    assert feasible == sorted(feasible)


# --------------------------------------------------------------- validate
@pytest.mark.parametrize("bw_points", [9, 25])
def test_validate_report_equals_reference(bw_points):
    got = validate_scenario("smoke-lm", table=_planted_lm_table(PLANTED),
                            bw_points=bw_points, run_summaries=False)
    want = ref_validate.validate_scenario(
        "smoke-lm", table=ref_planted_lm_table(PLANTED), bw_points=bw_points,
        run_summaries=False)
    assert got.keys() == want.keys()
    for key in ("scenario", "arch", "table", "summaries"):
        assert got[key] == want[key], key
    assert got["plan_divergence"] == want["plan_divergence"]
    assert got["plan_divergence"]["points"] == bw_points
    assert got["fit"]["theta"].keys() == want["fit"]["theta"].keys()
    for k in want["fit"]["theta"]:
        np.testing.assert_allclose(got["fit"]["theta"][k], want["fit"]["theta"][k],
                                   rtol=FIT_TOL, atol=FIT_TOL)
        assert _close(got["fit"]["r2"][k], want["fit"]["r2"][k])
    for key in ("scale", "bias_s", "mape", "per_layer_bias_s", "per_layer_mape"):
        assert _close(got[key], want[key]), key
    for rows in ("per_exit", "per_layer"):
        assert len(got[rows]) == len(want[rows]) > 0
        for g, w in zip(got[rows], want[rows]):
            assert g.keys() == w.keys() and g["name"] == w["name"]
            for k in ("predicted_s", "measured_s", "bias_s", "rel_err"):
                assert _close(g[k], w[k]), (rows, k)
    json.dumps(got)


def test_validate_rejects_mismatched_arch():
    table = CalibrationTable(arch="branchy-alexnet", samples=[
        TimingSample(phase="decode", latency_s=0.1, exit_point=1)])
    with pytest.raises(ValueError, match="arch"):
        validate_scenario("smoke-lm", table=table, run_summaries=False)


# -------------------------------------------------- spec section plumbing
def test_calibration_spec_round_trips():
    spec = ScenarioSpec(name="c", calibration=CalibrationSpec(
        table="t.json", anchor=False))
    d = spec.to_dict()
    back = ScenarioSpec.from_dict(json.loads(json.dumps(d)))
    assert back.calibration.table == "t.json"
    assert back.calibration.anchor is False
    assert ScenarioSpec.from_json(spec.to_json()).to_dict() == d
    assert RefScenarioSpec.from_json(spec.to_json()).to_dict() == d
    spec = apply_overrides(get_scenario("smoke-lm"),
                           {"calibration.table": "t.json"})
    assert spec.calibration is not None and spec.calibration.table == "t.json"
    with pytest.raises(ValueError, match="unknown CalibrationSpec"):
        CalibrationSpec.from_dict({"table": "x", "oops": 1})


@pytest.mark.parametrize("anchor", [True, False])
def test_calibrated_scenario_summary_equals_reference(tmp_path, anchor):
    """``Simulation`` accepts ``calibration``: a scenario pointed at a table
    builds its planner on the fitted models (anchored: the full branch
    still costs the spec's step times) and runs model-only; its summary is
    the reference's, which reads the same table file."""
    p = tmp_path / "table.json"
    _planted_lm_table(PLANTED).save(str(p))
    spec = dataclasses.replace(
        get_scenario("smoke-lm"),
        workload=WorkloadSpec(rate_hz=10.0, horizon_s=3.0),
        calibration=CalibrationSpec(table=str(p), anchor=anchor))
    sim = Simulation(spec)
    sc = sim.build()
    full = sc.graph.branches[-1]
    f_edge, f_dev = models_from_table(CalibrationTable.load(str(p)),
                                      spec.planner, graph=sc.graph,
                                      anchor=anchor)
    assert [sc.planner.f_edge.predict(l) for l in full] == \
        [f_edge.predict(l) for l in full]
    if anchor:
        assert sum(sc.planner.f_edge.predict(l) for l in full) == \
            pytest.approx(spec.planner.edge_step_s, rel=1e-9)
    got = sim.run().summary()
    assert got["requests"] > 0
    want = RefSimulation(RefScenarioSpec.from_json(spec.to_json())).run().summary()
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    plain = Simulation(dataclasses.replace(spec, calibration=None)).run().summary()
    assert json.dumps(plain, sort_keys=True) != json.dumps(got, sort_keys=True)


# ----------------------------------------------------------------- measure
def test_measure_alexnet_on_the_cpu():
    table = measure_alexnet(reps=1, device="cpu")
    assert table.arch == "branchy-alexnet" and table.source == "measure_alexnet"
    assert len(table.samples) == 38                 # unique layers, 5 branches
    assert {s.phase for s in table.samples} == {"layer"}
    assert {s.kind for s in table.samples} == KINDS
    assert all(s.latency_s > 0 and s.features for s in table.samples)
    assert table.meta == {"reps": 1, "smoke": True, "platform": "cpu",
                          "num_exits": 5}
    fitted = fit_table(table)
    assert set(fitted.theta) == KINDS
    ref = ref_table.CalibrationTable.from_json(table.to_json())
    _assert_fits_equal(fitted, ref_fit.fit_table(ref))


@pytest.mark.parametrize("decode_path", ["batched", "arena"])
def test_measure_lm_on_the_cpu(decode_path):
    table = measure_lm(batches=(1, 2), seqs=(4,), reps=1, warmup=1,
                       decode_path=decode_path, device="cpu")
    spec = PlannerSpec()
    n_exits = lm_graph(get_smoke_config(spec.arch), batch=1, seq=1).num_exits
    assert table.arch == spec.arch and table.source == "measure_lm"
    assert table.meta == {"reps": 1, "warmup": 1, "batches": [1, 2],
                          "seqs": [4], "decode_path": decode_path,
                          "platform": "cpu", "num_exits": n_exits,
                          "edge_step_s": spec.edge_step_s,
                          "device_step_s": spec.device_step_s}
    assert [len(table.by_phase(ph)) for ph in ("prefill", "decode", "head")] == \
        [2, 2 * n_exits, 2]
    assert table.exits() == list(range(1, n_exits + 1))
    assert all(s.latency_s > 0 for s in table.samples)
    fitted = fit_table(table)
    assert set(fitted.theta) == {"block", "fc"}
    ref = ref_table.CalibrationTable.from_json(table.to_json())
    _assert_fits_equal(fitted, ref_fit.fit_table(ref))
    report = validate_scenario("smoke-lm", table=table, bw_points=3,
                               run_summaries=False)
    assert len(report["per_exit"]) == n_exits


def test_measurement_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        measure_alexnet(reps=1)
    with pytest.raises(RuntimeError, match="cuda"):
        measure_lm(batches=(1,), reps=1)


def test_cli_measures_fits_and_validates(tmp_path, capsys):
    t, f, r = (str(tmp_path / n) for n in ("t.json", "f.json", "r.json"))
    assert calib_main(["measure", "--smoke", "--reps", "1", "--device", "cpu",
                       "--out", t]) == 0
    assert len(CalibrationTable.load(t).samples) == 38
    assert calib_main(["fit", "--table", t, "--out", f]) == 0
    assert set(FittedLatencyModel.load(f).theta) == KINDS
    planted = str(tmp_path / "planted.json")
    _planted_lm_table(PLANTED).save(planted)
    assert calib_main(["validate", "--table", planted, "--no-summaries",
                       "--bw-points", "5", "--out", r]) == 0
    with open(r) as fh:
        assert json.load(fh)["plan_divergence"]["points"] == 5
    assert "plan divergence" in capsys.readouterr().out
