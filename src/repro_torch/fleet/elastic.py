"""Fleet elasticity: autoscaling, admission control, and the price model.

Edgent promises *on-demand* acceleration, but a fixed ``capacity=8`` edge
cannot answer capacity-planning questions: saturated cells silently degrade
instead of scaling up or shedding load.  This module makes per-edge capacity
a first-class dynamic quantity:

* :class:`Autoscaler` — a deterministic threshold policy over the streaming
  backlog/utilization gauges the engine already maintains (the same SoA rows
  ``repro_torch.obs.Timeline`` snapshots).  The engine runs it on a dedicated
  ``scale`` event grid; decisions are (edge, target-slots) pairs.  Scale-down
  *drains*: busy slots are never reclaimed — the engine steps provisioned
  capacity down at round boundaries as requests retire (docs/elastic.md).
* :class:`AdmissionControl` — a per-cell reject path at saturated edges:
  ``policy='reject'`` sheds the arrival outright (an explicit ``rejected``
  outcome in :class:`~repro_torch.fleet.metrics.FleetMetrics`), ``policy='local'``
  degrades it to device-only execution.  ``JointPlanner`` additionally masks
  saturated primaries so joint routing steers around full cells before the
  engine-level backstop fires.
* the price model — capacity costs ``usd_per_slot_hour`` while provisioned;
  the engine integrates the piecewise-constant capacity timeline into
  ``FleetMetrics.slot_s`` and ``summary()['cost_usd']``, which is what the
  cost-vs-SLO frontier sweeps trade off (``repro_torch.sim.sweep --frontier``).

Everything here is deterministic and pure with respect to the virtual clock:
the same spec replays the identical scale-event log bit-for-bit, and with no
autoscaler/admission attached the engine's behavior is byte-identical to the
pre-elasticity code paths (golden-pinned by tests/test_elastic.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.fleet.cluster import EdgeNode, FleetTopology

__all__ = ["AdmissionControl", "Autoscaler", "build_elasticity"]


@dataclass
class Autoscaler:
    """Threshold autoscaling over live per-edge gauges.

    Scale **up** by ``step`` slots when an edge's ``backlog_s`` (pending
    seconds of work) exceeds ``up_backlog_s``; scale **down** by ``step``
    when the queue is empty and the running batch fills at most
    ``down_util`` of the provisioned slots.  ``cooldown_s`` rate-limits
    decisions per edge; ``min_slots >= 1`` is enforced because a zero-slot
    edge with queued work would stall the event loop.

    ``planner`` (optional) is a :class:`repro_torch.runtime.elastic.ElasticPlanner`
    calibrated with the fleet's latency models: when a scale-down changes an
    edge's effective speed-per-slot economics, the engine asks it to re-price
    queued requests' (partition, exit) plans (``FleetEngine._replan_shrunk``).
    """
    min_slots: int = 1
    max_slots: int = 16
    decide_dt: float = 1.0           # scale-event grid period (virtual s)
    up_backlog_s: float = 1.0        # pending-work trigger for scale-up
    down_util: float = 0.25          # batch-fill ceiling for scale-down
    step: int = 1                    # slots added/removed per decision
    cooldown_s: float = 0.0          # per-edge minimum gap between decisions
    usd_per_slot_hour: float = 1.0   # the price model ($ per slot-hour)
    planner: object = None           # optional ElasticPlanner (shrink replan)
    _last: Dict[int, float] = field(default_factory=dict, repr=False)

    def __post_init__(self):
        if self.min_slots < 1:
            raise ValueError(
                f"min_slots must be >= 1 (a zero-slot edge with queued work "
                f"stalls the event loop), got {self.min_slots}")
        if self.max_slots < self.min_slots:
            raise ValueError(
                f"max_slots ({self.max_slots}) must be >= min_slots "
                f"({self.min_slots})")
        if self.decide_dt <= 0:
            raise ValueError(f"decide_dt must be positive, got "
                             f"{self.decide_dt}")
        if self.step < 1:
            raise ValueError(f"step must be >= 1, got {self.step}")

    def reset(self) -> None:
        """Engine calls this per run: decisions must not leak across runs
        (the same determinism contract routers follow)."""
        self._last.clear()

    def decide(self, now: float,
               topo: FleetTopology) -> List[Tuple[int, int]]:
        """(eid, target-slots) for every edge whose gauges cross a threshold
        this tick.  Deterministic: edges are scanned in id order and the
        decision is a pure function of (now, live edge state)."""
        out: List[Tuple[int, int]] = []
        for e in topo.edges:
            last = self._last.get(e.eid)
            if last is not None and now - last < self.cooldown_s:
                continue
            cap = e.capacity
            if e.backlog_s() > self.up_backlog_s and cap < self.max_slots:
                self._last[e.eid] = now
                out.append((e.eid, min(self.max_slots, cap + self.step)))
            elif cap > self.min_slots \
                    and len(e.queue) - e.q_dead == 0 \
                    and len(e.active) <= self.down_util * cap:
                self._last[e.eid] = now
                out.append((e.eid, max(self.min_slots, cap - self.step)))
        return out


@dataclass
class AdmissionControl:
    """Per-cell admission control: an edge is *saturated* once its bound
    requests (queued + in the batch) reach ``capacity + max_queue``.

    ``policy='reject'`` sheds saturated arrivals outright (counted as
    ``rejected`` in FleetMetrics — never silently dropped);
    ``policy='local'`` degrades them to device-only execution (the request
    still completes, on its own hardware).  The saturation test reads the
    engine-maintained SoA backlog mirror, so the joint planner can mask a
    whole fleet row at once (:meth:`saturated_row`)."""

    POLICIES = ("reject", "local")

    policy: str = "reject"
    max_queue: int = 0

    def __post_init__(self):
        if self.policy not in self.POLICIES:
            raise ValueError(
                f"unknown admission policy {self.policy!r}: expected one "
                f"of {', '.join(self.POLICIES)}")
        if self.max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {self.max_queue}")

    def saturated(self, edge: EdgeNode) -> bool:
        return edge.backlog() >= edge.capacity + self.max_queue

    def saturated_row(self, topo: FleetTopology) -> np.ndarray:
        """Boolean saturation per edge, elementwise identical to
        :meth:`saturated` over ``topo.edges`` (the JointPlanner mask)."""
        return topo.backlog_n_row() >= topo.edge_capacity + self.max_queue


def build_elasticity(autoscale, admission, *, graph=None, planner=None,
                     latency_req_s: float = 0.5, ref_chips: int = 8):
    """Spec -> live policy objects, shared by ``repro_torch.sim.build`` and
    ``repro_torch.sim.shard``.  ``autoscale`` / ``admission`` are the plain-data
    :class:`~repro_torch.sim.spec.AutoscaleSpec` / ``AdmissionSpec`` (duck-typed —
    anything with the same attributes works); either may be ``None``.

    When the autoscale spec asks for shrink re-planning and the caller
    provides the model stack, the autoscaler gets an
    :class:`~repro_torch.runtime.elastic.ElasticPlanner` built from the fleet's
    *calibrated* latency models (``ref_chips`` = the slots those models
    price one edge at), so shrunk-edge plans re-price on the same cost
    surface the Edgent planner used."""
    adm = None
    if admission is not None:
        adm = AdmissionControl(policy=admission.policy,
                               max_queue=admission.max_queue)
    sca = None
    if autoscale is not None:
        ep = None
        if getattr(autoscale, "replan_on_shrink", False) \
                and graph is not None and planner is not None:
            from repro_torch.runtime.elastic import ElasticPlanner
            ep = ElasticPlanner(graph=graph, latency_req_s=latency_req_s,
                                link_bps=1.0, f_edge=planner.f_edge,
                                f_dev=planner.f_device, ref_chips=ref_chips)
        sca = Autoscaler(
            min_slots=autoscale.min_slots, max_slots=autoscale.max_slots,
            decide_dt=autoscale.decide_dt,
            up_backlog_s=autoscale.up_backlog_s,
            down_util=autoscale.down_util, step=autoscale.step,
            cooldown_s=autoscale.cooldown_s,
            usd_per_slot_hour=autoscale.usd_per_slot_hour, planner=ep)
    return sca, adm
