"""Edgent planner facade — offline configuration + online tuning in one
object (paper Fig. 5 workflow).

``EdgentPlanner.offline_static``  : profile -> fit regressions -> static cfg
``EdgentPlanner.offline_dynamic`` : sketch states -> build config map
``planner.plan(bandwidth)``       : online tuning (Algorithm 1 or 3)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.core import config_map as CM
from repro_torch.core.graph import InferenceGraph
from repro_torch.core.latency_model import (ProfileRecord, RegressionLatencyModel,
                                      ScaledLatencyModel)
from repro_torch.core.partitioner import (CoInferencePlan, branch_preds,
                                    optimize_multi)
from repro_torch.core.profiler import (DEVICE_SLOWDOWN, profile_all_branches,
                                 profiles_to_records)
from repro_torch.core.runtime_optimizer import (DynamicRuntimeOptimizer,
                                          StaticRuntimeOptimizer)


@dataclass
class EdgentPlanner:
    graph: InferenceGraph
    latency_req_s: float
    f_edge: Optional[object] = None
    f_device: Optional[object] = None
    static_opt: Optional[StaticRuntimeOptimizer] = None
    dynamic_opt: Optional[DynamicRuntimeOptimizer] = None

    # calibration artifacts (None until offline_static runs)
    edge_factor: float = 1.0
    device_factor: float = DEVICE_SLOWDOWN

    # ------------------------------------------------------------ offline
    def offline_static(self, params, input_x, *,
                       device_slowdown: float = DEVICE_SLOWDOWN,
                       calibrate_to: Optional[tuple] = (2.3, 0.010)):
        """Stage 1 of Fig. 6: profile layers once, fit per-type regressions
        for each tier.

        ``calibrate_to=(device_s, edge_s)`` rescales the tier emulation so
        the full main-branch inference matches the paper's measured
        endpoints (Fig. 2: Raspberry-Pi ~2.3 s device-only, ~10 ms edge
        compute) — this host's CPU is far faster than both testbed tiers, so
        absolute speeds are anchored to the publication and the *trends* are
        what we validate."""
        profiles = profile_all_branches(self.graph, params, input_x)
        host_full = sum(p.latency_s for p in profiles
                        if not p.name.startswith("b"))  # main branch only
        if calibrate_to is not None and host_full > 0:
            dev_s, edge_s = calibrate_to
            self.device_factor = dev_s / host_full
            self.edge_factor = edge_s / host_full
        else:
            self.device_factor, self.edge_factor = device_slowdown, 1.0
        edge_records = profiles_to_records(profiles, scale=self.edge_factor)
        dev_records = profiles_to_records(profiles, scale=self.device_factor)
        self.f_edge = RegressionLatencyModel().fit(edge_records)
        self.f_device = RegressionLatencyModel().fit(dev_records)
        self.static_opt = StaticRuntimeOptimizer(
            self.graph, self.f_edge, self.f_device, self.latency_req_s)
        return self

    def with_models(self, f_edge, f_device):
        """Inject predictors directly (e.g. RooflineLatencyModel tiers)."""
        self.f_edge, self.f_device = f_edge, f_device
        self.static_opt = StaticRuntimeOptimizer(
            self.graph, f_edge, f_device, self.latency_req_s)
        return self

    def offline_dynamic(self, traces_bps: Sequence[Sequence[float]],
                        hazard: float = 1 / 50.0):
        """Fig. 7: sketch bandwidth states from historical traces, build the
        configuration map, arm the BOCD-driven optimizer."""
        assert self.f_edge is not None, "run offline_static/with_models first"
        states = CM.sketch_states(traces_bps)
        cmap = CM.build_map(self.graph, self.f_edge, self.f_device,
                            states, self.latency_req_s)
        self.dynamic_opt = DynamicRuntimeOptimizer(cmap, hazard=hazard)
        return self

    # ------------------------------------------------------------ online
    def plan(self, bandwidth_bps: float, *, dynamic: bool = False
             ) -> CoInferencePlan:
        if dynamic:
            assert self.dynamic_opt is not None
            return self.dynamic_opt.plan(bandwidth_bps)
        assert self.static_opt is not None
        return self.static_opt.plan(bandwidth_bps)

    def plan_multi(self, bandwidth_bps: float, edge_speeds: Sequence[float],
                   *, device_load: float = 1.0,
                   edge_bw_bps: Optional[float] = None) -> CoInferencePlan:
        """Joint (exit, k-cut partition) search for one ordered edge set:
        spans sized proportionally to ``edge_speeds``, device compute scaled
        by ``device_load``, edge<->edge hops billed at ``edge_bw_bps``.
        Unlike :meth:`plan`, the result is conditioned on the candidate
        hardware — the caller (``repro_torch.fleet.joint.JointPlanner``) searches
        edge sets on top of this."""
        assert self.f_edge is not None, "run offline_static/with_models first"
        return optimize_multi(self.graph, self.f_edge, self.f_device,
                              bandwidth_bps, self.latency_req_s, edge_speeds,
                              device_load=device_load,
                              edge_bw_bps=edge_bw_bps,
                              preds=self._branch_preds())

    def _branch_preds(self):
        """Memoized :func:`~repro_torch.core.partitioner.branch_preds` for the
        planner's own (graph, models) triple — the fleet's joint plan
        search calls :meth:`plan_multi` on every cache miss."""
        key = (id(self.f_edge), id(self.f_device))
        if getattr(self, "_preds_key", None) != key:
            self._preds_key = key
            self._preds = branch_preds(self.graph, self.f_edge,
                                       self.f_device)
        return self._preds
