"""Named-scenario registry (mirrors ``fleet.router.make_router``).

Scenarios register a *factory* returning a fresh :class:`ScenarioSpec`, so
callers can mutate what they get (``dataclasses.replace`` or in place)
without corrupting the preset.  Built-ins:

* ``smoke-lm``       — 40-device static fleet, diurnal arrivals, bandwidth-
  aware routing: the ``benchmarks/fleet_scale.py --smoke`` static cell.
* ``coop``           — the same fleet under joint (edge-set, partition,
  exit) planning: the ``--coop --smoke`` comparison cell.
* ``smoke-mobility`` — 40 mobile devices random-waypoint over a 4-edge
  geography, streaming tenants, nearest-edge routing, BOCD handover: the
  ``--mobility --smoke`` cell.
* ``elastic-smoke``   — the smoke-lm fleet shrunk to 4 base slots per edge
  with threshold autoscaling and a reject-at-saturation admission gate: the
  CI elasticity cell (docs/elastic.md).
* ``elastic-diurnal`` — a longer-horizon diurnal workload against elastic
  edges: the base spec the cost-vs-SLO frontier sweeps perturb
  (``repro_torch.sim.sweep --frontier``).
"""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.fleet.workload import TenantClass
from repro_torch.sim.spec import (AdmissionSpec, AutoscaleSpec, MobilitySpec,
                            PlannerSpec, RouterSpec, ScenarioSpec,
                            TopologySpec, WorkloadSpec)

__all__ = ["get_scenario", "list_scenarios", "register_scenario",
           "STREAMING_TENANTS"]

_REGISTRY: Dict[str, Callable[[], ScenarioSpec]] = {}


def register_scenario(name: str, factory: Callable[[], ScenarioSpec], *,
                      overwrite: bool = False):
    """Register ``factory`` under ``name``.  The factory must return a fresh
    spec per call (a zero-arg lambda around a ScenarioSpec literal)."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"scenario {name!r} is already registered "
                         "(pass overwrite=True to replace it)")
    _REGISTRY[name] = factory


def get_scenario(name: str) -> ScenarioSpec:
    """Resolve a registered scenario name to a fresh, caller-owned spec."""
    factory = _REGISTRY.get(name)
    if factory is None:
        raise ValueError(f"unknown scenario {name!r}: expected one of "
                         f"{sorted(_REGISTRY)} (register_scenario adds more)")
    return factory()


def list_scenarios() -> List[ScenarioSpec]:
    """Fresh specs for every registered scenario, sorted by name (the CLI's
    ``--list`` view)."""
    return [_REGISTRY[name]() for name in sorted(_REGISTRY)]


# ---------------------------------------------------------------- built-ins

# long-lived streaming requests: decode spans many handover sampling
# intervals, so mobility policies genuinely fire mid-request
STREAMING_TENANTS = (
    TenantClass("interactive", slo_s=1.0, max_new_tokens=32, weight=0.5),
    TenantClass("standard", slo_s=3.0, max_new_tokens=64, weight=0.35),
    TenantClass("batch", slo_s=8.0, max_new_tokens=128, weight=0.15),
)


def _smoke_lm(router: str, name: str, description: str) -> ScenarioSpec:
    return ScenarioSpec(
        name=name, description=description, seed=2,
        topology=TopologySpec(num_devices=40, num_edges=4, edge_capacity=8,
                              lo_mbps=0.1, hi_mbps=6.0,
                              max_edge_slowdown=4.0),
        workload=WorkloadSpec(rate_per_device_hz=1.2, horizon_s=30.0,
                              arrival="diurnal", device_skew=1.0),
        router=RouterSpec(name=router))


register_scenario("smoke-lm", lambda: _smoke_lm(
    "bandwidth-aware", "smoke-lm",
    "40-device static fleet, diurnal arrivals, bandwidth-aware routing "
    "(the fleet_scale --smoke static cell)"))

register_scenario("coop", lambda: _smoke_lm(
    "joint", "coop",
    "smoke-lm under joint (edge-set, partition, exit) planning "
    "(the fleet_scale --coop --smoke cell)"))

register_scenario("smoke-mobility", lambda: ScenarioSpec(
    name="smoke-mobility",
    description="40 mobile devices over a 4-edge geography, streaming "
                "tenants, nearest-edge routing, BOCD handover "
                "(the fleet_scale --mobility --smoke cell)",
    seed=3,
    planner=PlannerSpec(result_kb=4.0),
    topology=TopologySpec(kind="mobile", num_devices=40, num_edges=4,
                          speed=0.25, horizon_s=60.0, floor_mbps=0.1,
                          noise_sigma=0.08),
    workload=WorkloadSpec(rate_per_device_hz=0.2, horizon_s=25.0,
                          device_skew=0.5, tenants=STREAMING_TENANTS),
    router=RouterSpec(name="nearest"),
    mobility=MobilitySpec(policy="bocd")))


def _elastic(name: str, description: str, *, horizon_s: float,
             max_slots: int, peak_factor: float) -> ScenarioSpec:
    # capacity-bound by construction: streaming tenants (decode up to 128
    # tokens, so one slot is held for whole seconds) against a 2-slot base
    # — the diurnal peak genuinely forces the autoscaler's hand, and the
    # admission gate fires whenever provisioned capacity lags the ramp
    return ScenarioSpec(
        name=name, description=description, seed=2,
        topology=TopologySpec(num_devices=40, num_edges=4, edge_capacity=2,
                              lo_mbps=0.1, hi_mbps=6.0,
                              max_edge_slowdown=4.0),
        workload=WorkloadSpec(rate_per_device_hz=2.0, horizon_s=horizon_s,
                              arrival="diurnal", device_skew=1.0,
                              peak_factor=peak_factor,
                              tenants=STREAMING_TENANTS),
        router=RouterSpec(name="bandwidth-aware"),
        autoscale=AutoscaleSpec(min_slots=1, max_slots=max_slots,
                                decide_dt=0.5, up_backlog_s=0.5,
                                down_util=0.25, cooldown_s=1.0),
        admission=AdmissionSpec(policy="reject", max_queue=2))


register_scenario("elastic-smoke", lambda: _elastic(
    "elastic-smoke",
    "smoke-lm fleet on 4-slot elastic edges: threshold autoscaling plus a "
    "reject-at-saturation admission gate (the CI elasticity cell)",
    horizon_s=30.0, max_slots=8, peak_factor=2.0))

register_scenario("elastic-diurnal", lambda: _elastic(
    "elastic-diurnal",
    "longer diurnal workload against elastic edges — the base spec the "
    "cost-vs-SLO frontier sweeps perturb (repro_torch.sim.sweep --frontier)",
    horizon_s=60.0, max_slots=12, peak_factor=3.0))
