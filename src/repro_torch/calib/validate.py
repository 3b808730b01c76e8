"""Validate the analytic latency models against measured kernels.

:func:`validate_scenario` answers the calibration loop's question — *how
wrong is the simulator's cost surface, and would the planner decide
differently on the real one?* — for one scenario:

1. measure (or load) a :class:`~repro_torch.calib.table.CalibrationTable` for the
   scenario's architecture;
2. compare per-exit branch step times and per-segment marginals between the
   analytic models and the measurements (signed bias + MAPE, after a single
   scalar aligns simulated seconds with host seconds — absolute scale is a
   scenario knob, shape is what calibration tests);
3. sweep the scenario's bandwidth range and count plan divergence: how
   often the calibrated planner picks a different (exit, partition) than
   the analytic one;
4. run the scenario model-only under both cost surfaces and report the two
   summaries (byte-identical exactly when no plan ever diverged).

The report is a plain JSON-able dict, the reference's report for the same
table (``tests/test_torch_calib.py`` holds the two equal).
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Union

import numpy as np

from repro_torch.calib.fit import fit_table, models_from_table
from repro_torch.calib.measure import measure_lm
from repro_torch.calib.table import CalibrationTable

__all__ = ["validate_scenario"]

#: bandwidth grid resolution for the plan-divergence sweep
DEFAULT_BW_POINTS = 25


def _branch_sums(graph, f) -> List[float]:
    return [sum(f.predict(l) for l in graph.branches[e])
            for e in range(graph.num_exits)]


def _align_scale(pred: np.ndarray, meas: np.ndarray) -> float:
    """Least-squares scalar k minimizing ||k*pred - meas||: compares the
    shape of two cost surfaces independent of units."""
    denom = float(pred @ pred)
    return float(pred @ meas) / denom if denom > 0 else 1.0


def _err_rows(names, pred: np.ndarray, meas: np.ndarray) -> List[Dict]:
    rows = []
    for n, p, m in zip(names, pred, meas):
        rows.append({
            "name": n, "predicted_s": float(p), "measured_s": float(m),
            "bias_s": float(p - m),
            "rel_err": float((p - m) / m) if m > 0 else None})
    return rows


def _mape(rows: List[Dict]) -> float:
    errs = [abs(r["rel_err"]) for r in rows if r["rel_err"] is not None]
    return float(np.mean(errs)) if errs else 0.0


def _bias(rows: List[Dict]) -> float:
    return float(np.mean([r["bias_s"] for r in rows])) if rows else 0.0


def validate_scenario(spec_or_name: Union[str, object], *,
                      table: Optional[CalibrationTable] = None,
                      bw_points: int = DEFAULT_BW_POINTS,
                      run_summaries: bool = True,
                      reps: int = 3, device="cuda") -> Dict:
    """Full model-vs-measured validation for one scenario (see module
    docstring).  ``table=None`` measures a quick one in place on ``device``
    (decode sweep at the scenario's prompt length); pass a saved table for
    reproducible reports.  ``run_summaries=False`` skips the two model-only
    fleet runs (the expensive step) and reports ``summaries: None``."""
    from repro_torch.core.partitioner import optimize_with_fallback
    from repro_torch.sim import CalibrationSpec, Simulation, get_scenario
    from repro_torch.sim.build import build_stack

    spec = get_scenario(spec_or_name) if isinstance(spec_or_name, str) \
        else spec_or_name
    if table is None:
        table = measure_lm(spec.planner, seqs=(spec.workload.prompt_len,),
                           reps=reps, device=device)
    if table.arch != spec.planner.arch:
        raise ValueError(
            f"table measures arch {table.arch!r} but scenario "
            f"{spec.name!r} plans over {spec.planner.arch!r}")
    fitted = fit_table(table)

    # ---- per-exit / per-segment error: analytic vs measured (B=1 decode)
    sc = build_stack(spec.planner)
    graph = sc.graph
    decode = [s for s in table.by_phase("decode") if s.batch == 1]
    if not decode:
        raise ValueError(
            f"table for {table.arch!r} carries no B=1 decode samples: "
            "measure with 1 in batches= to validate per-exit error")
    meas_by_exit: Dict[int, List[float]] = {}
    for s in decode:
        meas_by_exit.setdefault(s.exit_point, []).append(s.latency_s)
    exits = sorted(meas_by_exit)
    meas = np.asarray([float(np.median(meas_by_exit[e])) for e in exits])
    pred_full = np.asarray(_branch_sums(graph, sc.planner.f_edge))
    pred = np.asarray([pred_full[e - 1] for e in exits])
    k = _align_scale(pred, meas)
    per_exit = _err_rows([f"exit{e}" for e in exits], k * pred, meas)
    # segment marginals: consecutive-exit differences (the shared exit-head
    # cost cancels) — per-layer error at the LM's segment granularity
    per_layer = []
    if len(exits) > 1:
        dm = np.diff(meas)
        dp = np.diff(k * pred)
        names = [f"seg{exits[i]}..{exits[i + 1]}"
                 for i in range(len(exits) - 1)]
        per_layer = _err_rows(names, dp, dm)

    # ---- plan divergence over the scenario's bandwidth range
    f_edge_c, f_dev_c = models_from_table(fitted, spec.planner, graph=graph)
    topo = spec.topology
    lo = topo.lo_mbps if topo.kind == "static" else topo.floor_mbps
    hi = topo.hi_mbps if topo.kind == "static" else topo.peak_mbps
    bws = np.logspace(np.log10(max(lo, 1e-3)), np.log10(max(hi, 1e-3)),
                      bw_points) * 1e6 / 8.0          # Mbps -> bytes/s
    req = spec.planner.latency_req_s
    points, diverged = [], 0
    for bw in bws:
        pa = optimize_with_fallback(graph, sc.planner.f_edge,
                                    sc.planner.f_device, float(bw), req)
        pc = optimize_with_fallback(graph, f_edge_c, f_dev_c, float(bw), req)
        same = (pa.exit_point, pa.partition) == (pc.exit_point, pc.partition)
        diverged += 0 if same else 1
        points.append({
            "bw_mbps": round(float(bw) * 8.0 / 1e6, 4),
            "analytic": [pa.exit_point, pa.partition],
            "calibrated": [pc.exit_point, pc.partition],
            "diverged": not same})
    plan_divergence = {
        "rate": diverged / len(points) if points else 0.0,
        "diverged": diverged, "points": len(points), "grid": points}

    # ---- model-only summaries under both cost surfaces
    summaries = None
    if run_summaries:
        base = dataclasses.replace(
            spec, engine=dataclasses.replace(spec.engine,
                                             real_decode=False),
            calibration=None)
        s_analytic = Simulation(base).run().summary()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="calib_table_")
        os.close(fd)
        try:
            table.save(path)
            cal = dataclasses.replace(
                base, calibration=CalibrationSpec(table=path))
            s_calibrated = Simulation(cal).run().summary()
        finally:
            os.unlink(path)
        summaries = {
            "analytic": s_analytic, "calibrated": s_calibrated,
            "identical": json.dumps(s_analytic, sort_keys=True)
            == json.dumps(s_calibrated, sort_keys=True)}

    return {
        "scenario": spec.name,
        "arch": spec.planner.arch,
        "table": {"source": table.source, "samples": len(table.samples),
                  "meta": table.meta},
        "fit": {"theta": fitted.theta, "r2": fitted.r2},
        "scale": k,
        "per_exit": per_exit,
        "per_layer": per_layer,
        "bias_s": _bias(per_exit),
        "mape": _mape(per_exit),
        "per_layer_bias_s": _bias(per_layer),
        "per_layer_mape": _mape(per_layer),
        "plan_divergence": plan_divergence,
        "summaries": summaries,
    }
