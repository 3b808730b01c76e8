"""Deprecated tuple-returning scenario helpers (use ``repro_torch.sim``).

These were the canonical fleet-experiment entry points before the
declarative scenario API (docs/api.md): ``smoke_lm_scenario`` returned a
3- or 5-tuple depending on ``with_model``, ``smoke_mobility_scenario`` a
6-tuple — exactly the flag-dependent arity ``repro_torch.sim.Scenario`` replaces
with named fields.  Both remain as thin shims over the spec builders so
external callers keep working: they reproduce the legacy tuples bit-for-bit
and emit a ``DeprecationWarning`` (pinned in tests/test_sim.py).

Migration (see docs/api.md for the full table)::

    cfg, graph, planner = smoke_lm_scenario()          # before
    sc = build_stack(PlannerSpec())                    # after: named fields
    sc.cfg, sc.graph, sc.planner

    _, g, p, topo, mob, ctrl = smoke_mobility_scenario(40, 4, ...)  # before
    sc = Simulation(get_scenario("smoke-mobility")).build()         # after
    sc.graph, sc.planner, sc.topo, sc.mobility, sc.handover, sc.engine
"""
from __future__ import annotations

import warnings


def smoke_lm_scenario(arch: str = "llama3.2-1b", *,
                      latency_req_s: float = 0.5,
                      input_kb: float = 24.0,
                      device_step_s: float = 0.06,
                      edge_step_s: float = 0.004,
                      with_model: bool = False):
    """Deprecated: build ``(cfg, graph, planner[, model, params])`` as a
    positional tuple.  Use ``repro_torch.sim.build_stack(PlannerSpec(...))`` —
    it returns the same objects as named ``Scenario`` fields with no
    flag-dependent arity."""
    warnings.warn(
        "smoke_lm_scenario() is deprecated: use repro_torch.sim "
        "(build_stack(PlannerSpec(...)) for the model stack, or "
        "Simulation(get_scenario('smoke-lm')) for a full experiment); "
        "the tuple return will be removed", DeprecationWarning,
        stacklevel=2)
    from repro_torch.sim.build import build_stack
    from repro_torch.sim.spec import PlannerSpec
    sc = build_stack(
        PlannerSpec(arch=arch, latency_req_s=latency_req_s,
                    input_kb=input_kb, device_step_s=device_step_s,
                    edge_step_s=edge_step_s),
        with_model=with_model)
    if not with_model:
        return sc.cfg, sc.graph, sc.planner
    return sc.cfg, sc.graph, sc.planner, sc.model, sc.params


def smoke_mobility_scenario(num_devices: int, num_edges: int = 4, *,
                            seed: int = 0, speed: float = 0.1,
                            policy: str = "bocd", horizon_s: float = 60.0,
                            arch: str = "llama3.2-1b",
                            latency_req_s: float = 0.5,
                            result_kb: float = 4.0,
                            sample_dt: float = 0.5, hazard: float = 1 / 20.0,
                            **mobile_kwargs):
    """Deprecated: build the mobile smoke stack as the positional tuple
    ``(cfg, graph, planner, topo, mobility, controller)`` (``controller``
    is ``None`` for ``policy='none'``).  Use a ``repro_torch.sim`` ScenarioSpec
    with ``TopologySpec(kind='mobile')`` + ``MobilitySpec`` instead —
    ``Simulation(spec).build()`` returns the same objects by name, plus the
    wired ``FleetEngine``."""
    warnings.warn(
        "smoke_mobility_scenario() is deprecated: use repro_torch.sim "
        "(Simulation(get_scenario('smoke-mobility')), or a ScenarioSpec "
        "with TopologySpec(kind='mobile') + MobilitySpec); the tuple "
        "return will be removed", DeprecationWarning, stacklevel=2)
    from repro_torch.fleet.mobility import HandoverController
    from repro_torch.sim.build import build_stack, build_topology
    from repro_torch.sim.spec import PlannerSpec, TopologySpec
    sc = build_stack(PlannerSpec(arch=arch, latency_req_s=latency_req_s,
                                 result_kb=result_kb))
    topo, mobility = build_topology(
        TopologySpec(kind="mobile", num_devices=num_devices,
                     num_edges=num_edges, speed=speed, horizon_s=horizon_s,
                     **mobile_kwargs), seed)
    controller = None if policy == "none" else HandoverController(
        mobility, policy=policy, sample_dt=sample_dt, hazard=hazard)
    return sc.cfg, sc.graph, sc.planner, topo, mobility, controller
