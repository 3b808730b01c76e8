"""Pluggable device->edge routing policies.

The router answers one question per arrival: which edge should co-serve this
device's request?  Policies range from oblivious (round-robin) to
queue-aware (join-shortest-queue) to bandwidth/latency-aware — the latter
consults the device's Edgent plan at its *current* bandwidth plus each
edge's speed and backlog, i.e. partition decisions inform placement (the
joint view of arXiv:2310.12937).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.fleet.cluster import DeviceNode, EdgeNode, FleetTopology
from repro_torch.fleet.joint import JointDecision, JointPlanner


class Router:
    name = "base"

    def route(self, req, device: DeviceNode, topo: FleetTopology,
              now: float) -> EdgeNode:
        raise NotImplementedError

    def decide(self, req, device: DeviceNode, topo: FleetTopology,
               now: float) -> Optional[JointDecision]:
        """Joint routing hook: a router that plans (edge set, partition,
        exit) jointly returns a full decision; placement-only routers return
        None and the engine falls back to :meth:`route`."""
        return None

    def reset(self):
        """Called by ``FleetEngine.run`` before each simulation so a stateful
        policy cannot leak decisions across runs (determinism contract)."""


class RoundRobinRouter(Router):
    """Oblivious: cycle through the edges in id order."""
    name = "round-robin"

    def __init__(self):
        self._next = 0

    def reset(self):
        self._next = 0

    def route(self, req, device, topo, now) -> EdgeNode:
        edge = topo.edges[self._next % topo.num_edges]
        self._next += 1
        return edge


class JoinShortestQueueRouter(Router):
    """Pick the edge with the fewest queued + in-flight requests
    (deterministic tie-break on edge id)."""
    name = "jsq"

    def route(self, req, device, topo, now) -> EdgeNode:
        # engine-maintained SoA row; np.argmin takes the first minimum,
        # which is the lowest eid — same tie-break as the scalar
        # min((backlog, eid)) scan over edge objects
        return topo.edges[int(np.argmin(topo.backlog_n_row()))]


class BandwidthAwareRouter(Router):
    """Latency-aware: estimated completion = edge backlog + the Edgent
    planner's predicted co-inference latency at the device's current
    bandwidth on that edge's hardware (``edge.speed``).  Requires a
    :class:`~repro_torch.serving.engine.CoInferenceStepper` for plan lookups (its
    plan cache is shared with the fleet engine).

    Scoring is vectorized over the edges: the per-edge step time at the
    plan's exit is a pure function of (quantized bandwidth, plan, device
    slowdown) and is cached as one array; per arrival only the backlog
    vector is fresh.  ``argmin`` takes the first minimum, which is the
    lowest eid — the same ``(est, eid)`` tie-break as the scalar loop."""
    name = "bandwidth-aware"

    def __init__(self, stepper):
        self.stepper = stepper
        self._steps = {}

    def reset(self):
        # step-vector entries are pure values — they survive resets; the
        # dict is bounded by (qbw x plan x slowdown) like the step cache
        pass

    def route(self, req, device, topo, now) -> EdgeNode:
        from repro_torch.serving.engine import quantize_bw
        bw = device.link.bw_at(now)
        plan = self.stepper.plan(bw)
        # keyed on the immutable inputs (incl. the edge-speed tuple, which
        # also pins the edge order), never on object identity — a router
        # instance may outlive the topology it first served
        key = (quantize_bw(bw), plan.partition, plan.exit_point,
               device.slowdown, topo.speed_key)
        steps = self._steps.get(key)
        if steps is None:
            steps = self._steps[key] = np.array([
                self.stepper.per_exit_times_cached(
                    plan.partition, bw, edge_load=e.speed,
                    device_load=device.slowdown)[plan.exit_point - 1]
                for e in topo.edges])
        blg = topo.backlog_s_row()          # vectorized EdgeNode.backlog_s
        est = blg + steps * req.max_new_tokens
        return topo.edges[int(est.argmin())]


class NearestEdgeRouter(Router):
    """Mobility-aware placement: route to the geographically nearest edge
    (the one the device's radio sees the strongest signal from).  Requires a
    :class:`~repro_torch.fleet.mobility.MobilityModel`; pair it with a
    :class:`~repro_torch.fleet.mobility.HandoverController` on the engine to keep
    that binding fresh as devices move (docs/handover.md)."""
    name = "nearest"

    def __init__(self, mobility):
        self.mobility = mobility

    def route(self, req, device, topo, now) -> EdgeNode:
        return topo.edge(self.mobility.nearest(device.did, now))


class JointRouter(Router):
    """Joint (edge-set, partition, exit) routing: delegates the full search
    to :class:`~repro_torch.fleet.joint.JointPlanner` and returns an edge *set* —
    the primary hosts the queue slot, the rest serve cooperative spans."""
    name = "joint"

    def __init__(self, planner: JointPlanner):
        self.planner = planner

    def decide(self, req, device, topo, now) -> JointDecision:
        return self.planner.decide(req, device, topo, now)

    def route(self, req, device, topo, now) -> EdgeNode:
        dec = self.decide(req, device, topo, now)
        assert dec.assign.eids, \
            "device-only decision has no edge — callers must use decide()"
        return topo.edge(dec.assign.eids[0])


# alias -> canonical policy name; the single source of truth for which
# router strings `FleetEngine(router=...)`, `RouterSpec`, and the CLI accept
ROUTER_ALIASES = {
    "rr": "round-robin", "round-robin": "round-robin",
    "jsq": "jsq", "join-shortest-queue": "jsq",
    "bw": "bandwidth-aware", "bandwidth": "bandwidth-aware",
    "bandwidth-aware": "bandwidth-aware",
    "nearest": "nearest", "nearest-edge": "nearest",
    "joint": "joint", "coop": "joint", "joint-coop": "joint",
}


def make_router(name: str, stepper=None, topo=None,
                max_coop: int = 3, prefill_div: int = 8,
                mobility=None, admission=None) -> Router:
    """Router registry (docs/fleet.md has the policy table): resolves the
    policy names accepted by ``FleetEngine(router=...)``,
    ``repro_torch.sim.RouterSpec``, and the benchmarks' ``--router`` flags.
    Unknown names and missing dependencies raise ``ValueError``.

    ``admission`` (a :class:`~repro_torch.fleet.elastic.AdmissionControl`) is
    consulted only by joint routing: the planner masks saturated primaries
    so the search steers around full cells; placement-only routers rely on
    the engine's admission backstop instead."""
    canon = ROUTER_ALIASES.get(name)
    if canon is None:
        raise ValueError(f"unknown router {name!r}: expected one of "
                         f"{sorted(ROUTER_ALIASES)}")
    if canon == "round-robin":
        return RoundRobinRouter()
    if canon == "jsq":
        return JoinShortestQueueRouter()
    if canon == "bandwidth-aware":
        if stepper is None:
            raise ValueError("bandwidth-aware routing needs a "
                             "CoInferenceStepper (FleetEngine passes its "
                             "own when given the name)")
        return BandwidthAwareRouter(stepper)
    if canon == "nearest":
        if mobility is None:
            raise ValueError(
                "nearest-edge routing needs a MobilityModel: build the "
                "fleet with make_mobile_fleet or a repro_torch.sim mobile "
                "topology and pass FleetEngine(mobility=...)")
        return NearestEdgeRouter(mobility)
    # joint
    if stepper is None or topo is None:
        raise ValueError("joint routing needs a stepper and the fleet "
                         "topology (FleetEngine passes both when given "
                         "the name)")
    if getattr(stepper, "dynamic", False):
        raise ValueError(
            "joint routing is static-environment only: the plan cache it "
            "fans out over assumes dynamic=False")
    # mobility (when the fleet has one) lets decide() price every candidate
    # primary at that edge's observed bandwidth instead of the device's
    # best-signal link — without it, joint routing systematically
    # over-admits far edges under mobility (docs/fleet.md)
    return JointRouter(JointPlanner(stepper, topo, max_coop=max_coop,
                                    prefill_div=prefill_div,
                                    mobility=mobility, admission=admission))
