"""Fleet-scale event-driven serving simulator (docs/fleet.md).

Many devices x many edges on a virtual clock: bandwidth-aware routing,
continuous batching per edge, and per-pair Edgent planning reused fleet-wide
through a shared ``CoInferenceStepper``.  Cooperative multi-edge spans and
joint (edge-set, partition, exit) planning live in ``fleet.coop`` /
``fleet.joint`` (docs/coop.md); device mobility and BOCD-driven mid-request
handover live in ``fleet.mobility`` (docs/handover.md).

Experiments are declared one layer up: ``repro_torch.sim`` (docs/api.md) wires
topology + workload + planner + router + engine from a serializable
``ScenarioSpec``.  The ``smoke_*_scenario`` tuple helpers re-exported here
are deprecated shims over that API.
"""
from repro_torch.fleet.cluster import (DeviceNode, EdgeNode, FleetTopology,  # noqa: F401
                                 TraceLink, make_fleet)
from repro_torch.fleet.coop import (CoopAssignment, assign_spans,  # noqa: F401
                              hop_schedule, span_seconds)
from repro_torch.fleet.engine import FleetEngine  # noqa: F401
from repro_torch.fleet.events import Event, EventQueue  # noqa: F401
from repro_torch.fleet.joint import JointDecision, JointPlanner  # noqa: F401
from repro_torch.fleet.metrics import FleetMetrics, RequestRecord  # noqa: F401
from repro_torch.fleet.mobility import (HandoverController, MobileLink,  # noqa: F401
                                  MobilityModel, Trajectory, edge_grid,
                                  make_mobile_fleet, migration_bytes,
                                  random_trajectory)
from repro_torch.fleet.scenario import (smoke_lm_scenario,  # noqa: F401
                                  smoke_mobility_scenario)
from repro_torch.fleet.router import (BandwidthAwareRouter,  # noqa: F401
                                JoinShortestQueueRouter, JointRouter,
                                NearestEdgeRouter, RoundRobinRouter, Router,
                                make_router)
from repro_torch.fleet.workload import (DEFAULT_TENANTS, FleetRequest,  # noqa: F401
                                  TenantClass, diurnal_arrivals,
                                  make_workload, poisson_arrivals)
