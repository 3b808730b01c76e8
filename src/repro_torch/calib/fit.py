"""Fit the paper's per-layer-type latency regressions from a measured
table, and re-parameterize planners with the result.

Two sample shapes, one model:

* ``layer`` samples (the branchy-AlexNet path) regress each Table-I kind
  directly — exactly :class:`~repro_torch.core.latency_model
  .RegressionLatencyModel.fit`.
* branch-level ``decode``/``head`` samples (the LM path, where a single
  kernel step spans a whole branch) solve one *joint* least squares: the
  row for (exit ``e``, batch ``B``) is the per-kind sum of Table-I design
  vectors over branch ``e``'s layers at batch ``B`` (from
  ``core.graph.lm_graph``), the unknowns the concatenated per-kind thetas.
  Per-layer coefficients thus fall out of branch-level timings — the
  differencing the paper does with per-layer profiling, recovered by
  construction.

:func:`models_from_table` turns a fit into planner-ready ``(f_edge,
f_dev)`` predictors — anchored to a spec's per-tier step times by default
(calibration reshapes the cost surface; the simulated hardware speed stays
the scenario's) — and :func:`elastic_planner_from_table` /
:func:`reparameterize_planner` install them.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.calib.table import CalibrationTable
from repro_torch.core.latency_model import (ProfileRecord,
                                            RegressionLatencyModel,
                                            TABLE_I_FEATURES)

__all__ = ["FittedLatencyModel", "elastic_planner_from_table", "fit_table",
           "models_from_table", "reparameterize_planner"]

#: emulated device:edge asymmetry when a table measures only this host
#: (``core.profiler.DEVICE_SLOWDOWN`` — paper Sec. V-A)
DEVICE_SLOWDOWN = 20.0


@dataclass
class FittedLatencyModel:
    """A serializable per-kind regression: ``theta[kind]`` are the Table-I
    design coefficients (feature order per ``TABLE_I_FEATURES`` + bias).
    ``predict(layer)`` matches ``RegressionLatencyModel`` exactly;
    ``to_regression()`` rehydrates one for call sites that type-check."""
    arch: str
    theta: Dict[str, List[float]] = field(default_factory=dict)
    r2: Dict[str, float] = field(default_factory=dict)
    source: str = "fit"
    meta: Dict = field(default_factory=dict)

    def predict(self, layer) -> float:
        th = self.theta.get(layer.kind)
        if th is None:
            raise KeyError(f"no fitted model for layer kind {layer.kind!r}")
        design = RegressionLatencyModel._design(layer.kind, layer.features)
        return float(max(0.0, design @ np.asarray(th)))

    def to_regression(self) -> RegressionLatencyModel:
        reg = RegressionLatencyModel()
        reg.theta = {k: np.asarray(v, float) for k, v in self.theta.items()}
        reg.residual = dict(self.r2)
        return reg

    # ------------------------------------------------------------ round-trip
    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["theta"] = {k: [float(x) for x in v]
                      for k, v in d["theta"].items()}
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "FittedLatencyModel":
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(
                f"unknown FittedLatencyModel field(s) {sorted(unknown)}: "
                f"expected a subset of {sorted(names)}")
        return cls(**d)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "FittedLatencyModel":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "FittedLatencyModel":
        with open(path) as f:
            return cls.from_json(f.read())


def _lm_graph_for(arch: str, batch: int):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.graph import lm_graph
    return lm_graph(get_smoke_config(arch), batch=batch, seq=1)


def _branch_design(graph, exit_point: int, kinds: List[str]) -> np.ndarray:
    """One joint-regression row: per-kind design sums over the branch."""
    row = []
    for kind in kinds:
        acc = np.zeros(len(TABLE_I_FEATURES[kind]) + 1)
        for layer in graph.branches[exit_point - 1]:
            if layer.kind == kind:
                acc += RegressionLatencyModel._design(kind, layer.features)
        row.append(acc)
    return np.concatenate(row)


def fit_table(table: CalibrationTable, *,
              arch: Optional[str] = None) -> FittedLatencyModel:
    """Fit per-kind regressions from every usable sample in ``table``.

    ``layer`` samples fit directly; ``decode`` + ``head`` samples join the
    branch-level system described in the module docstring (the graph is
    rebuilt at each sample's batch so features scale correctly).  Raises
    ``ValueError`` on a table with nothing to fit."""
    arch = arch or table.arch
    fitted = FittedLatencyModel(arch=arch, source=f"fit({table.source})",
                                meta=dict(table.meta))
    layer_samples = table.by_phase("layer")
    if layer_samples:
        reg = RegressionLatencyModel().fit([
            ProfileRecord(kind=s.kind, features=s.features,
                          latency_s=s.latency_s) for s in layer_samples])
        fitted.theta.update(
            {k: [float(x) for x in v] for k, v in reg.theta.items()})
        fitted.r2.update(reg.residual)
    branch_samples = table.by_phase("decode") + table.by_phase("head")
    if branch_samples and any(s.phase == "decode" for s in branch_samples):
        graphs = {}      # batch -> lm_graph at that batch
        for s in branch_samples:
            if s.batch not in graphs:
                graphs[s.batch] = _lm_graph_for(arch, s.batch)
        kinds = sorted({layer.kind
                        for g in graphs.values()
                        for b in g.branches for layer in b})
        widths = [len(TABLE_I_FEATURES[k]) + 1 for k in kinds]
        rows, y = [], []
        for s in branch_samples:
            g = graphs[s.batch]
            if s.phase == "decode":
                if not 1 <= (s.exit_point or 0) <= g.num_exits:
                    raise ValueError(
                        f"decode sample exit_point={s.exit_point!r} out of "
                        f"range for arch {arch!r} ({g.num_exits} exits)")
                rows.append(_branch_design(g, s.exit_point, kinds))
            else:                           # head: a lone fc layer
                row = np.zeros(sum(widths))
                off = 0
                for k, w in zip(kinds, widths):
                    if k == "fc":
                        row[off:off + w] = RegressionLatencyModel._design(
                            "fc", s.features)
                    off += w
                rows.append(row)
            y.append(s.latency_s)
        X = np.stack(rows)
        yv = np.asarray(y)
        theta, *_ = np.linalg.lstsq(X, yv, rcond=None)
        pred = X @ theta
        ss_res = float(np.sum((yv - pred) ** 2))
        ss_tot = float(np.sum((yv - yv.mean()) ** 2)) or 1e-12
        off = 0
        for k, w in zip(kinds, widths):
            fitted.theta[k] = [float(x) for x in theta[off:off + w]]
            fitted.r2[k] = 1.0 - ss_res / ss_tot
            off += w
    if not fitted.theta:
        raise ValueError(
            f"table for {table.arch!r} has no fittable samples (need "
            "'layer' or 'decode' phases; got "
            f"{sorted({s.phase for s in table.samples})})")
    return fitted


def models_from_table(table: CalibrationTable, spec, *, graph=None,
                      anchor: bool = True) -> Tuple[object, object]:
    """Planner-ready ``(f_edge, f_dev)`` from a measured table.

    ``anchor=True`` rescales the fitted predictor so a full-branch decode
    step costs the spec's ``edge_step_s`` / ``device_step_s`` — the same
    anchoring contract ``sim.build.build_stack`` applies to its rooflines,
    so swapping models changes where cuts land, never the simulated tier
    speeds.  ``anchor=False`` returns raw host seconds for the edge and the
    paper's ~20x Raspberry-Pi slowdown for the device tier."""
    from repro_torch.core.latency_model import ScaledLatencyModel

    fitted = table if isinstance(table, FittedLatencyModel) \
        else fit_table(table)
    reg = fitted.to_regression()
    if graph is None:
        graph = _lm_graph_for(fitted.arch, 1)
    if not anchor:
        return reg, ScaledLatencyModel(reg, DEVICE_SLOWDOWN)
    full = graph.branches[-1]
    step = sum(reg.predict(l) for l in full)
    if step <= 0.0:
        raise ValueError(
            f"fitted model for {fitted.arch!r} predicts a non-positive "
            f"full-branch step ({step!r}): cannot anchor to spec step times")
    return (ScaledLatencyModel(reg, spec.edge_step_s / step),
            ScaledLatencyModel(reg, spec.device_step_s / step))


def reparameterize_planner(planner, table: CalibrationTable, spec, *,
                           anchor: bool = True):
    """Swap a live ``EdgentPlanner``'s latency models for calibrated ones
    (in place; returns the planner for chaining)."""
    f_edge, f_dev = models_from_table(table, spec, graph=planner.graph,
                                      anchor=anchor)
    planner.with_models(f_edge, f_dev)
    return planner


def elastic_planner_from_table(table: CalibrationTable, spec, *,
                               link_bps: float,
                               latency_req_s: Optional[float] = None,
                               ref_chips: int = 1, anchor: bool = True):
    """An ``runtime.elastic.ElasticPlanner`` running on calibrated per-layer
    models — the fleet-autoscaling consumer of a fitted table."""
    from repro_torch.runtime.elastic import ElasticPlanner

    graph = _lm_graph_for(table.arch, 1)
    graph.input_bytes = int(spec.input_kb * 1024)
    if getattr(spec, "result_kb", None) is not None:
        graph.result_bytes = int(spec.result_kb * 1024)
    f_edge, f_dev = models_from_table(table, spec, graph=graph,
                                      anchor=anchor)
    return ElasticPlanner(
        graph=graph,
        latency_req_s=spec.latency_req_s if latency_req_s is None
        else latency_req_s,
        link_bps=link_bps, f_edge=f_edge, f_dev=f_dev, ref_chips=ref_chips)
