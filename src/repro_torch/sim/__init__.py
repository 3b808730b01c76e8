"""Declarative scenario/experiment API over the fleet simulator
(docs/api.md).

One :class:`ScenarioSpec` — a plain-data tree of topology / workload /
planner / router / engine / mobility specs — fully determines a fleet
simulation; :class:`Simulation` builds and runs it; the registry names the
canonical presets; ``python -m repro_torch.sim`` drives it all from the
shell (``--device cpu`` off the card):

    from repro_torch.sim import Simulation, get_scenario
    metrics = Simulation(get_scenario("smoke-lm")).run()

Specs round-trip through JSON (``to_json``/``from_json``), every random
draw derives from the single root seed (``ScenarioSpec.seeds()``), and the
same spec always reproduces bit-identical :class:`~repro_torch.fleet.metrics
.FleetMetrics` — sweeps are spec edits, not rewired setup code.
"""
from repro_torch.sim.build import (Scenario, Simulation, build_stack,  # noqa: F401
                             build_topology)
from repro_torch.sim.registry import (STREAMING_TENANTS, get_scenario,  # noqa: F401
                                list_scenarios, register_scenario)
from repro_torch.sim.spec import (AdmissionSpec, AutoscaleSpec,  # noqa: F401
                            CalibrationSpec, DerivedSeeds, EngineSpec,
                            MobilitySpec, PlannerSpec, RouterSpec,
                            ScenarioSpec, TopologySpec, WorkloadSpec,
                            apply_overrides)
from repro_torch.sim.sweep import (grid_cells, pareto_frontier,  # noqa: F401
                                   random_cells, run_sweep)
