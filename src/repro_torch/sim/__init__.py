"""Declarative scenario/experiment API over the fleet simulator
(docs/api.md).

One :class:`ScenarioSpec` — a plain-data tree of topology / workload /
planner / router / engine / mobility specs — fully determines a fleet
simulation; :class:`Simulation` builds and runs it; the registry names the
canonical presets:

    from repro_torch.sim import Simulation, get_scenario
    metrics = Simulation(get_scenario("smoke-lm")).run()

Specs round-trip through JSON (``to_json``/``from_json``), every random
draw derives from the single root seed (``ScenarioSpec.seeds()``), and the
same spec always reproduces bit-identical :class:`~repro_torch.fleet.metrics
.FleetMetrics` — sweeps are spec edits, not rewired setup code.

The sweep driver, sharded runs and the command line (``sweep.py``,
``shard.py``, ``cli.py``, ``__main__.py``) wait for a later slice
(``ROADMAP.md``).
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
