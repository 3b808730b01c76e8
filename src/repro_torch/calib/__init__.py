"""Measure -> fit -> validate: the sim-to-real calibration loop
(docs/calibration.md).

The paper's planner quality rests on profiled per-layer latency
regressions (Table I); our fleet simulator normally runs on analytic
roofline models instead.  This package closes that gap on the port's real
layers and kernels in three stages:

* :mod:`repro_torch.calib.measure` — time per-layer / per-exit prefill and
  decode (warmup + a device sync, median-of-k of the host wall) over batch
  and sequence sweeps, on the card unless the caller asks for the CPU,
  emitting a serializable :class:`CalibrationTable`;
* :mod:`repro_torch.calib.fit` — fit the paper-style per-layer-type regressions
  from a table and re-parameterize the planner
  (``core.latency_model.RegressionLatencyModel``) or an
  ``runtime.elastic.ElasticPlanner`` from the fit;
* :mod:`repro_torch.calib.validate` — run one scenario on analytic vs calibrated
  models and report per-layer / per-exit error (signed bias + MAPE) and the
  plan-divergence rate over the scenario's bandwidth range.

``python -m repro_torch.calib {measure,fit,validate}`` drives the loop from the
shell; ``ScenarioSpec.calibration`` points a scenario at a fitted table.
The table's JSON schema is the reference's, so a table saved by either
package loads in the other.
"""
from repro_torch.calib.fit import (FittedLatencyModel,  # noqa: F401
                                   elastic_planner_from_table, fit_table,
                                   models_from_table)
from repro_torch.calib.measure import measure_alexnet, measure_lm  # noqa: F401
from repro_torch.calib.table import CalibrationTable, TimingSample  # noqa: F401
from repro_torch.calib.validate import validate_scenario  # noqa: F401
