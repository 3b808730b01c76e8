"""Build and run fleet simulations from declarative specs.

The live-object half of ``repro_torch.sim``: :func:`build_stack` turns a
:class:`~repro_torch.sim.spec.PlannerSpec` into the (config, graph, planner[,
model, params]) stack, :class:`Simulation` owns the full wiring — topology,
mobility, handover controller, workload, and ``FleetEngine`` — that the
benchmarks, examples, and fleet test suites previously duplicated by hand.

    spec = get_scenario("smoke-lm")            # or build a ScenarioSpec
    metrics = Simulation(spec).run()           # -> FleetMetrics

``Simulation.build()`` returns the intermediate :class:`Scenario` (every
constructed object by name) for callers that need to drive the engine
directly — e.g. the invariant tests re-run one engine over a subsampled
workload.

Entry points that execute the model run on the card unless the caller asks
for the CPU: ``Simulation(spec, device="cuda")`` and
``build_stack(..., device="cuda")``; a timing-only spec builds no model
and needs no device.  ``calibration`` swaps the planner's roofline models
for regressions fitted from a measured table (``repro_torch.calib``).
Spec options whose machinery the port does not have yet
(``engine.trace``, ``engine.timeline`` and ``topology.shards > 1``) raise
:class:`NotImplementedError` naming the ``ROADMAP.md`` step that brings
them; none is ignored.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import torch

from repro_torch import config as _hw

from repro_torch.fleet.cluster import FleetTopology, make_fleet
from repro_torch.fleet.engine import FleetEngine
from repro_torch.fleet.metrics import FleetMetrics
from repro_torch.fleet.mobility import (HandoverController, MobilityModel,
                                  make_mobile_fleet)
from repro_torch.fleet.workload import FleetRequest, make_workload
from repro_torch.sim.spec import (PlannerSpec, ScenarioSpec, TopologySpec,
                                  WorkloadSpec)

__all__ = ["Scenario", "Simulation", "build_planner", "build_stack",
           "build_topology", "build_workload"]

#: the roofline constants the planner's tier models are built on (the
#: card's, ``repro_torch.config``).  They set which layers are compute- or
#: memory-bound, and so the per-layer split of the rescaled step times:
#: the reference's goldens need the reference's constants, which its tests
#: put here.
PEAK_FLOPS = _hw.PEAK_FLOPS_BF16
HBM_BW = _hw.HBM_BW

#: the ROADMAP.md open item 1 step that brings each option the port refuses
_LATER = {
    "engine.trace": "step 2 (obs/trace.py)",
    "engine.timeline": "step 2 (obs/timeline.py)",
    "topology.shards > 1": "step 1 (sim/shard.py)",
}


def _not_ported(option: str):
    return NotImplementedError(
        f"{option} is not ported yet: ROADMAP.md open item 1, {_LATER[option]}")


def _refuse_unported(spec: ScenarioSpec) -> None:
    if spec.topology.shards > 1:
        raise _not_ported("topology.shards > 1")
    if spec.engine.trace is not None:
        raise _not_ported("engine.trace")
    if spec.engine.timeline is not None:
        raise _not_ported("engine.timeline")


@dataclass
class Scenario:
    """Everything a built spec produced, by name — the replacement for the
    old positional tuples (``smoke_lm_scenario``'s arity changed with its
    flags; this never does).  ``build_stack`` fills the model-stack fields;
    ``Simulation.build`` additionally fills the fleet fields."""
    spec: Optional[ScenarioSpec]
    cfg: object
    graph: object
    planner: object
    model: object = None
    params: object = None
    topo: Optional[FleetTopology] = None
    mobility: Optional[MobilityModel] = None
    handover: Optional[HandoverController] = None
    workload: Optional[List[FleetRequest]] = None
    engine: Optional[FleetEngine] = None


def build_stack(spec: PlannerSpec, *, with_model: bool = False,
                with_params: Optional[bool] = None,
                scenario_spec: Optional[ScenarioSpec] = None,
                device="cuda") -> Scenario:
    """Build the smoke-scale LM stack a spec's planner describes: config,
    ``InferenceGraph`` (input/result payloads applied), and an
    ``EdgentPlanner`` whose roofline predictors (on :data:`PEAK_FLOPS`
    and :data:`HBM_BW`) are rescaled to the spec's per-tier step times.
    ``with_model=True`` additionally constructs the executable model;
    ``with_params`` (default: follows ``with_model``) controls whether its
    parameters are initialized on ``device`` — the expensive half (fp32
    params, seed 0 of a ``torch.Generator`` — part of the scenario
    contract, not the seed tree).  Prompt-sampling-only scenarios need
    neither: the vocab comes from ``cfg``, so they build with both off,
    skip model construction entirely and need no device.

    With ``scenario_spec.calibration`` set, the planner's latency models are
    replaced by regressions fitted from the named measured
    :class:`~repro_torch.calib.CalibrationTable` (``repro_torch.calib.fit``
    — see docs/calibration.md)."""
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config(spec.arch)
    graph, planner = build_planner(cfg, spec)
    if scenario_spec is not None and scenario_spec.calibration is not None \
            and scenario_spec.calibration.table:
        from repro_torch.calib.fit import models_from_table
        from repro_torch.calib.table import CalibrationTable
        table = CalibrationTable.load(scenario_spec.calibration.table)
        f_edge, f_dev = models_from_table(
            table, spec, graph=graph,
            anchor=scenario_spec.calibration.anchor)
        planner.with_models(f_edge, f_dev)
    model = params = None
    if with_params is None:
        with_params = with_model
    if with_model:
        from repro_torch.models import Model
        model = Model(cfg)
        if with_params:
            params = model.init_params(dtype=torch.float32, device=device)
    return Scenario(spec=scenario_spec, cfg=cfg, graph=graph,
                    planner=planner, model=model, params=params)


def build_planner(cfg, spec: PlannerSpec):
    """The ``(graph, planner)`` of :func:`build_stack` for any config
    ``cfg`` (a full-size one too): ``cfg``'s ``InferenceGraph`` with the
    spec's payloads, and an ``EdgentPlanner`` whose roofline predictors
    are rescaled so that the full model's step takes the spec's per-tier
    step time."""
    from repro_torch.core import EdgentPlanner, lm_graph
    from repro_torch.core.latency_model import (RooflineLatencyModel,
                                                ScaledLatencyModel)

    graph = lm_graph(cfg, batch=1, seq=1)
    graph.input_bytes = int(spec.input_kb * 1024)
    if spec.result_kb is not None:
        # streaming per-token downlink: decode rounds exercise the wireless
        # link every token, so a degrading serving link hurts in-flight work
        graph.result_bytes = int(spec.result_kb * 1024)
    hw = dict(peak_flops=PEAK_FLOPS, hbm_bw=HBM_BW, efficiency=0.4)
    edge = RooflineLatencyModel(chips=8, **hw)
    dev = RooflineLatencyModel(chips=1, **hw)
    full = graph.branches[-1]
    k_edge = spec.edge_step_s / sum(edge.predict(l) for l in full)
    k_dev = spec.device_step_s / sum(dev.predict(l) for l in full)
    planner = EdgentPlanner(graph, latency_req_s=spec.latency_req_s)
    planner.with_models(ScaledLatencyModel(edge, k_edge),
                        ScaledLatencyModel(dev, k_dev))
    return graph, planner


def build_topology(spec: TopologySpec, seed: int
                   ) -> Tuple[FleetTopology, Optional[MobilityModel]]:
    """Sample the fleet a topology spec describes (``(topo, None)`` for
    static fleets, ``(topo, mobility)`` for mobile ones)."""
    if spec.kind == "static":
        topo = make_fleet(
            spec.num_devices, spec.num_edges, seed=seed, trace=spec.trace,
            edge_capacity=spec.edge_capacity, hetero_edges=spec.hetero_edges,
            max_edge_slowdown=spec.max_edge_slowdown,
            device_slowdown_range=spec.device_slowdown_range,
            lo_mbps=spec.lo_mbps, hi_mbps=spec.hi_mbps,
            trace_len=spec.trace_len, edge_bw_mbps=spec.edge_bw_mbps)
        return topo, None
    return make_mobile_fleet(
        spec.num_devices, spec.num_edges, seed=seed, speed=spec.speed,
        horizon_s=spec.horizon_s, area=spec.area,
        edge_capacity=spec.edge_capacity, hetero_edges=spec.hetero_edges,
        max_edge_slowdown=spec.max_edge_slowdown,
        device_slowdown_range=spec.device_slowdown_range,
        peak_mbps=spec.peak_mbps, floor_mbps=spec.floor_mbps,
        d_ref=spec.d_ref, path_exp=spec.path_exp,
        noise_sigma=spec.noise_sigma, noise_dt=spec.noise_dt,
        edge_bw_mbps=spec.edge_bw_mbps)


def build_workload(spec: WorkloadSpec, topo: FleetTopology, seed: int,
                   vocab: int) -> List[FleetRequest]:
    """Sample the requests a workload spec describes over ``topo``'s
    devices, with prompts drawn from ``vocab`` tokens (none when 0)."""
    return make_workload(
        topo.num_devices, rate_hz=spec.resolve_rate_hz(topo.num_devices),
        horizon_s=spec.horizon_s, seed=seed, arrival=spec.arrival,
        tenants=spec.tenants, device_skew=spec.device_skew,
        peak_factor=spec.peak_factor, period_s=spec.period_s,
        prompt_len=spec.prompt_len, vocab_size=vocab)


class Simulation:
    """Declarative façade over the fleet stack: ``Simulation(spec).run()``.

    Accepts a :class:`~repro_torch.sim.spec.ScenarioSpec` or a registered scenario
    name (``repro_torch.sim.registry``).  ``build()`` constructs every live object
    exactly once (idempotent; returns the cached :class:`Scenario`);
    ``run()`` executes the workload and returns
    :class:`~repro_torch.fleet.metrics.FleetMetrics`.  All randomness flows from
    ``spec.seeds()``, so the same spec — including one rebuilt from JSON —
    reproduces bit-identical metrics.  A real-decode spec runs its model on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, spec: Union[ScenarioSpec, str], device="cuda"):
        if isinstance(spec, str):
            from repro_torch.sim.registry import get_scenario
            spec = get_scenario(spec)
        self.spec = spec
        self.device = device
        self.scenario: Optional[Scenario] = None
        self.build_s: Optional[float] = None  # wall time of build(); feeds
        #                                       SimProfiler.build_s

    def build(self) -> Scenario:
        if self.scenario is not None:
            return self.scenario
        _refuse_unported(self.spec)
        import time
        t_build0 = time.perf_counter()
        spec = self.spec
        seeds = spec.seeds()
        sc = build_stack(spec.planner, with_model=spec.engine.real_decode,
                         scenario_spec=spec, device=self.device)
        topo, mobility = build_topology(spec.topology, seeds.topology)
        handover = None
        if spec.mobility is not None and spec.mobility.policy != "none":
            if mobility is None:
                raise ValueError(
                    f"spec {spec.name!r} sets a handover policy "
                    f"({spec.mobility.policy!r}) but its topology is "
                    "static: mobility policies need "
                    "TopologySpec(kind='mobile')")
            m = spec.mobility
            handover = HandoverController(
                mobility, policy=m.policy, sample_dt=m.sample_dt,
                hazard=m.hazard, hysteresis=m.hysteresis,
                min_gap_s=m.min_gap_s)
        vocab = sc.cfg.vocab_size \
            if (spec.workload.sample_prompts or spec.engine.real_decode) else 0
        workload = build_workload(spec.workload, topo, seeds.workload, vocab)
        dtype = None
        if spec.engine.dtype is not None:
            dtype = getattr(torch, spec.engine.dtype, None)
            if not isinstance(dtype, torch.dtype):
                raise ValueError(
                    f"unknown engine dtype {spec.engine.dtype!r}: expected "
                    "a torch dtype name such as 'float32' or 'bfloat16'")
        autoscaler = admission = None
        if spec.autoscale is not None or spec.admission is not None:
            from repro_torch.fleet.elastic import build_elasticity
            autoscaler, admission = build_elasticity(
                spec.autoscale, spec.admission, graph=sc.graph,
                planner=sc.planner, latency_req_s=spec.planner.latency_req_s,
                ref_chips=spec.topology.edge_capacity)
        engine = FleetEngine(
            topo, sc.graph, sc.planner, router=spec.router.name,
            model=sc.model, params=sc.params, dynamic=spec.engine.dynamic,
            dtype=dtype, demote_on_deadline=spec.engine.demote_on_deadline,
            prefill_div=spec.engine.prefill_div, mobility=mobility,
            handover=handover, replan_max_coop=spec.engine.replan_max_coop,
            max_coop=spec.router.max_coop,
            retain_records=spec.engine.retain_records,
            autoscaler=autoscaler, admission=admission,
            batch_decode=spec.engine.batch_decode,
            shard_decode=spec.engine.shard_decode,
            arena_decode=spec.engine.arena_decode,
            arena_bucket=spec.engine.arena_bucket)
        sc.topo, sc.mobility, sc.handover = topo, mobility, handover
        sc.workload, sc.engine = workload, engine
        self.build_s = time.perf_counter() - t_build0
        self.scenario = sc
        return sc

    def run(self) -> FleetMetrics:
        sc = self.build()
        return sc.engine.run(sc.workload)
