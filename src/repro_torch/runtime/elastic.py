"""Elastic scaling: re-plan when tier capacity or mesh size changes.

Two levers, both Edgent-native:
* serving — the planner re-solves (exit, partition) with a re-scaled
  RooflineLatencyModel when chips join/leave a tier;
* training — the data-parallel degree changes; batch is re-sharded and the
  step re-jitted for the surviving mesh (dry-run-validated re-mesh).

The fleet simulator reuses this for autoscaled edges
(:mod:`repro_torch.fleet.elastic`): an :class:`ElasticPlanner` built with the
fleet's *calibrated* latency models (``f_edge``/``f_dev`` + ``ref_chips``)
re-prices queued requests' plans when a scale-down changes an edge's
effective speed-per-slot, at the request's own link bandwidth
(``plan_for(..., link_bps=...)``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.core.latency_model import (RooflineLatencyModel,
                                      ScaledLatencyModel)
from repro_torch.core.partitioner import CoInferencePlan, optimize_with_fallback


@dataclass
class TierSpec:
    chips: int
    efficiency: float = 0.5


@dataclass
class ElasticPlanner:
    """Re-derive co-inference plans as tier sizes change.

    Two calibration modes:
    * default — per-tier :class:`RooflineLatencyModel` built from each
      :class:`TierSpec`'s (chips, efficiency);
    * explicit — ``f_edge``/``f_dev`` are pre-calibrated per-layer latency
      models (e.g. the fleet's rescaled rooflines) priced for ``ref_chips``
      edge slots; tier sizes then *re-scale* them, so halving the chips
      doubles the per-layer time on the identical cost surface the original
      planner optimized over.
    """
    graph: object
    latency_req_s: float
    link_bps: float
    f_edge: object = None
    f_dev: object = None
    ref_chips: int = 1

    def _models(self, edge: TierSpec, device: TierSpec):
        if self.f_edge is not None:
            f_edge = ScaledLatencyModel(
                self.f_edge, self.ref_chips / max(1, edge.chips))
        else:
            f_edge = RooflineLatencyModel(chips=edge.chips,
                                          efficiency=edge.efficiency)
        if self.f_dev is not None:
            f_dev = self.f_dev if device.chips <= 1 else \
                ScaledLatencyModel(self.f_dev, 1.0 / device.chips)
        else:
            f_dev = RooflineLatencyModel(chips=device.chips,
                                         efficiency=device.efficiency)
        return f_edge, f_dev

    def plan_for(self, edge: TierSpec, device: TierSpec, *,
                 link_bps: Optional[float] = None) -> CoInferencePlan:
        f_edge, f_dev = self._models(edge, device)
        return optimize_with_fallback(
            self.graph, f_edge, f_dev,
            self.link_bps if link_bps is None else link_bps,
            self.latency_req_s)

    def shrink_event(self, edge: TierSpec, device: TierSpec,
                     lost_chips: int) -> Tuple[CoInferencePlan, TierSpec]:
        """A failure removed chips from the edge tier: re-plan.  The tier
        never shrinks below one chip (clamped), so a plan always exists."""
        new_edge = TierSpec(max(1, edge.chips - lost_chips), edge.efficiency)
        return self.plan_for(new_edge, device), new_edge


def viable_mesh(total_devices: int, model_parallel: int) -> Tuple[int, int]:
    """Largest (data, model) grid for the surviving device count, keeping the
    model-parallel degree fixed (params resharding-free)."""
    data = max(1, total_devices // model_parallel)
    return data, model_parallel
