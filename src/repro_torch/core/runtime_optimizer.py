"""Runtime optimizers — the online-tuning stage for both environments.

* :class:`StaticRuntimeOptimizer`  — Algorithm 1 on demand: measure
  bandwidth, search (exit, partition) with the regression predictors.
* :class:`DynamicRuntimeOptimizer` — Algorithm 3: feed bandwidth
  measurements to the BOCD state detector; on a state transition, look up
  the nearest state in the configuration map (Algorithm 2 output).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.core import config_map as CM
from repro_torch.core.bocd import BandwidthStateDetector
from repro_torch.core.graph import InferenceGraph
from repro_torch.core.partitioner import CoInferencePlan, optimize_with_fallback


class StaticRuntimeOptimizer:
    def __init__(self, graph: InferenceGraph, f_edge, f_device,
                 latency_req_s: float):
        self.graph, self.f_edge, self.f_device = graph, f_edge, f_device
        self.latency_req_s = latency_req_s

    def plan(self, bandwidth_bps: float) -> CoInferencePlan:
        return optimize_with_fallback(self.graph, self.f_edge, self.f_device,
                                      bandwidth_bps, self.latency_req_s)


class DynamicRuntimeOptimizer:
    """Algorithm 3: C_t = C_{t-1} unless D(B_{1..t}) reports a new state."""

    def __init__(self, cmap: Dict[float, CM.MapEntry], hazard: float = 1 / 50.0):
        self.cmap = cmap
        self.detector = BandwidthStateDetector(hazard=hazard)
        self.state: Optional[float] = None
        self.current: Optional[CM.MapEntry] = None
        self.transitions = 0

    def step(self, bandwidth_bps: float) -> CM.MapEntry:
        state = self.detector.update(bandwidth_bps)
        if self.current is None or self.state is None or \
                abs(state - self.state) > 1e-9:
            entry = CM.lookup(self.cmap, state)
            if self.current is None or entry is not self.current:
                self.transitions += 1
            self.current = entry
            self.state = state
        return self.current

    def plan(self, bandwidth_bps: float) -> CoInferencePlan:
        e = self.step(bandwidth_bps)
        return CoInferencePlan(exit_point=e.exit_point, partition=e.partition,
                               latency_s=e.latency_s, accuracy=e.accuracy,
                               feasible=e.reward > 0)
