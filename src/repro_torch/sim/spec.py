"""Declarative scenario specs: the plain-data half of ``repro_torch.sim``.

A :class:`ScenarioSpec` is a small tree of dataclasses — topology, workload,
planner, router, engine, and (optionally) mobility — that fully determines
one fleet simulation.  Specs are plain data: they hold numbers, strings, and
tenant tuples, never live objects, so they round-trip through
``to_dict()`` / ``from_dict()`` / JSON (``to_json()`` / ``from_json()``) and
a parameter sweep is just a spec edit (``dataclasses.replace`` or the CLI's
``--set key=value``).  Building live objects from a spec is ``repro_torch.sim
.build``'s job; named presets live in ``repro_torch.sim.registry``.

Seeding is centralized: every stochastic input derives from the single
``ScenarioSpec.seed`` through :meth:`ScenarioSpec.seeds` (topology/
trajectory sampling uses ``seed``, the arrival process ``seed + 1``),
replacing the ad-hoc ``seed`` / ``seed+1`` / hardcoded-constant drift the
old hand-wired call sites had.  Same spec, same metrics — bit-identical
(asserted by tests/test_sim.py and the invariant suite).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.fleet.mobility import HandoverController
from repro_torch.fleet.router import ROUTER_ALIASES
from repro_torch.fleet.workload import DEFAULT_TENANTS, TenantClass

__all__ = [
    "AdmissionSpec", "AutoscaleSpec", "CalibrationSpec", "DerivedSeeds",
    "EngineSpec", "MobilitySpec", "PlannerSpec", "RouterSpec",
    "ScenarioSpec", "TopologySpec", "WorkloadSpec", "apply_overrides",
]


@dataclass(frozen=True)
class DerivedSeeds:
    """Per-subsystem seeds derived from one root seed (`ScenarioSpec.seeds`).

    ``topology`` drives every sample taken at fleet-construction time:
    bandwidth traces, device slowdowns, and — for mobile fleets —
    trajectories and the bandwidth-noise grid.  ``workload`` drives the
    arrival process, tenant draws, and prompt tokens."""
    topology: int
    workload: int


def _check_fields(cls, d: Dict):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(
            f"unknown {cls.__name__} field(s) {sorted(unknown)}: "
            f"expected a subset of {sorted(names)}")


def _jsonify(x):
    """Tuples -> lists, recursively: ``to_dict`` output is JSON-canonical,
    so ``spec.to_dict() == json.loads(json.dumps(spec.to_dict()))`` and
    dict/JSON round-trips compare equal (``__post_init__`` re-tuples on the
    way back in)."""
    if isinstance(x, (list, tuple)):
        return [_jsonify(v) for v in x]
    if isinstance(x, dict):
        return {k: _jsonify(v) for k, v in x.items()}
    return x


class _Spec:
    """Shared plain-data behavior: dict round-trip with strict field
    checking.  Subclasses override the hooks for non-scalar fields."""

    def to_dict(self) -> Dict:
        return _jsonify(dataclasses.asdict(self))

    @classmethod
    def from_dict(cls, d: Dict) -> "_Spec":
        _check_fields(cls, d)
        return cls(**d)


@dataclass
class TopologySpec(_Spec):
    """Where requests run: N devices x M edges, static traces or a mobile
    geography.  ``kind='static'`` builds via ``fleet.cluster.make_fleet``
    (the trace/``*_mbps`` fields apply); ``kind='mobile'`` via
    ``fleet.mobility.make_mobile_fleet`` (the speed/area/path-loss fields
    apply).  Field defaults mirror those builders exactly."""
    kind: str = "static"                 # "static" | "mobile"
    num_devices: int = 40
    num_edges: int = 4
    # geography sharding (repro_torch.sim.shard, docs/performance.md): > 1 splits
    # the fleet into `shards` disjoint tiles (num_devices/num_edges must
    # divide evenly), each an independent geography simulated by its own
    # event loop — in parallel worker processes or sequentially in one —
    # and merged into fleet-global metrics on virtual-time keys.  The spec
    # *defines* the tiling, so sharded and unsharded executions of the same
    # spec are bit-identical.
    shards: int = 1
    edge_capacity: int = 8
    hetero_edges: bool = True
    max_edge_slowdown: float = 3.0
    device_slowdown_range: Tuple[float, float] = (0.8, 2.5)
    edge_bw_mbps: float = 400.0          # edge<->edge backbone
    # --- static fleets (kind="static") ---
    trace: str = "oboe"                  # "oboe" | "lte"
    lo_mbps: float = 0.3
    hi_mbps: float = 6.0
    trace_len: int = 600
    # --- mobile fleets (kind="mobile") ---
    speed: float = 0.1                   # area units / s (jittered per device)
    horizon_s: float = 60.0              # trajectory + noise-grid horizon
    area: float = 1.0
    peak_mbps: float = 6.0
    floor_mbps: float = 0.05
    d_ref: float = 0.25
    path_exp: float = 3.0
    noise_sigma: float = 0.1
    noise_dt: float = 0.5

    def __post_init__(self):
        if self.kind not in ("static", "mobile"):
            raise ValueError(f"unknown topology kind {self.kind!r}: "
                             "expected 'static' or 'mobile'")
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.shards > 1 and (self.num_devices % self.shards
                                or self.num_edges % self.shards):
            raise ValueError(
                f"shards={self.shards} must divide num_devices="
                f"{self.num_devices} and num_edges={self.num_edges} evenly")
        self.device_slowdown_range = tuple(self.device_slowdown_range)


@dataclass
class WorkloadSpec(_Spec):
    """The request stream: arrival process, device skew, tenant mix.
    Exactly one of ``rate_hz`` (fleet-wide) or ``rate_per_device_hz``
    (scales with ``TopologySpec.num_devices``) must be set."""
    rate_hz: Optional[float] = None
    rate_per_device_hz: Optional[float] = None
    horizon_s: float = 30.0
    arrival: str = "poisson"             # "poisson" | "diurnal"
    device_skew: float = 0.0
    peak_factor: float = 4.0             # diurnal peak/base ratio
    period_s: Optional[float] = None     # diurnal period (None = horizon)
    prompt_len: int = 8
    tenants: Tuple[TenantClass, ...] = DEFAULT_TENANTS
    sample_prompts: bool = False         # draw real token prompts (needs the
    #                                      model config's vocab; implied by
    #                                      EngineSpec.real_decode)

    def __post_init__(self):
        self.tenants = tuple(
            TenantClass(**t) if isinstance(t, dict) else t
            for t in self.tenants)

    def resolve_rate_hz(self, num_devices: int) -> float:
        if (self.rate_hz is None) == (self.rate_per_device_hz is None):
            raise ValueError(
                "WorkloadSpec needs exactly one of rate_hz / "
                f"rate_per_device_hz, got rate_hz={self.rate_hz!r} "
                f"rate_per_device_hz={self.rate_per_device_hz!r}")
        if self.rate_hz is not None:
            return self.rate_hz
        return self.rate_per_device_hz * num_devices


@dataclass
class MobilitySpec(_Spec):
    """When in-flight work re-plans as devices move: the handover policy and
    its trigger parameters (``fleet.mobility.HandoverController``).
    Requires ``TopologySpec(kind='mobile')``; ``policy='none'`` keeps the
    mobile fleet but never migrates (the baseline in the benchmarks)."""
    policy: str = "none"                 # "none" | "oracle" | "bocd"
    sample_dt: float = 0.5               # bandwidth sampling grid (virtual s)
    hazard: float = 1 / 20.0             # BOCD change-point hazard
    hysteresis: float = 0.05             # oracle nearer-edge margin
    min_gap_s: float = 1.0               # per-device refire rate limit

    def __post_init__(self):
        if self.policy not in HandoverController.POLICIES:
            raise ValueError(
                f"unknown handover policy {self.policy!r}: expected one of "
                f"{', '.join(HandoverController.POLICIES)}")


@dataclass
class AutoscaleSpec(_Spec):
    """Elastic per-edge capacity (``fleet.elastic.Autoscaler``, docs/
    elastic.md): a threshold policy run on the engine's ``scale`` event
    grid every ``decide_dt`` virtual seconds.  Capacity starts at
    ``TopologySpec.edge_capacity``, scales up by ``step`` slots when an
    edge's backlog exceeds ``up_backlog_s`` seconds, and drains down by
    ``step`` when its queue is empty and the batch fills at most
    ``down_util`` of the provisioned slots, always within
    [``min_slots``, ``max_slots``].  Provisioned slots cost
    ``usd_per_slot_hour`` — the ``cost_usd`` axis of the frontier sweeps.
    ``replan_on_shrink`` re-prices queued requests' plans through
    ``runtime.elastic.ElasticPlanner`` after a scale-down."""
    min_slots: int = 1
    max_slots: int = 16
    decide_dt: float = 1.0
    up_backlog_s: float = 1.0
    down_util: float = 0.25
    step: int = 1
    cooldown_s: float = 0.0
    usd_per_slot_hour: float = 1.0
    replan_on_shrink: bool = True

    def __post_init__(self):
        # mirrors fleet.elastic.Autoscaler validation so a bad spec fails
        # at parse time, not mid-build
        if self.min_slots < 1:
            raise ValueError(f"min_slots must be >= 1, got {self.min_slots}")
        if self.max_slots < self.min_slots:
            raise ValueError(
                f"max_slots ({self.max_slots}) must be >= min_slots "
                f"({self.min_slots})")
        if self.decide_dt <= 0:
            raise ValueError(
                f"decide_dt must be positive, got {self.decide_dt}")
        if self.step < 1:
            raise ValueError(f"step must be >= 1, got {self.step}")


@dataclass
class AdmissionSpec(_Spec):
    """Per-cell admission control (``fleet.elastic.AdmissionControl``): an
    edge is saturated once queued + batched requests reach
    ``capacity + max_queue``; saturated arrivals are shed — rejected
    outright (``policy='reject'``, counted in ``summary()['rejected']``) or
    degraded to device-only execution (``policy='local'``)."""
    policy: str = "reject"               # "reject" | "local"
    max_queue: int = 0

    def __post_init__(self):
        if self.policy not in ("reject", "local"):
            raise ValueError(
                f"unknown admission policy {self.policy!r}: expected "
                "'reject' or 'local'")
        if self.max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {self.max_queue}")


@dataclass
class PlannerSpec(_Spec):
    """The model stack the Edgent planner optimizes over: a smoke-scale LM
    graph with roofline predictors rescaled so one device-only decode step
    costs ``device_step_s`` and one edge step ``edge_step_s`` (the paper's
    Fig. 2 tier asymmetry at per-token granularity).  ``input_kb`` is the
    offloaded prompt payload (multimodal-style image features);
    ``result_kb``, when set, adds a per-token downlink so streaming
    requests stay bandwidth-bound for their whole decode (the mobility
    scenarios rely on this)."""
    arch: str = "llama3.2-1b"
    latency_req_s: float = 0.5
    input_kb: float = 24.0
    device_step_s: float = 0.06
    edge_step_s: float = 0.004
    result_kb: Optional[float] = None


@dataclass
class RouterSpec(_Spec):
    """Which edge (or edge set) serves each arrival: a name from the
    ``fleet.router.make_router`` registry plus the joint-planner fan-out
    bound (``max_coop``, only consulted by ``router='joint'``)."""
    name: str = "round-robin"
    max_coop: int = 3

    def __post_init__(self):
        if self.name not in ROUTER_ALIASES:
            raise ValueError(
                f"unknown router {self.name!r}: expected one of "
                f"{sorted(ROUTER_ALIASES)}")


@dataclass
class EngineSpec(_Spec):
    """FleetEngine knobs: timing-only simulation by default;
    ``real_decode=True`` also runs the actual model (B=1 caches, per-exit
    decode variants) — ``dtype`` then names the torch dtype of the
    parameters' computation and the caches (``'float32'``,
    ``'bfloat16'``).  ``retain_records=False`` keeps
    FleetMetrics to its running aggregates (identical summaries, no
    per-request record/handover-log retention) — the 10k-device / sweep
    setting (docs/performance.md).

    Observability (docs/observability.md): ``trace`` writes a
    Chrome/Perfetto trace-event JSON of every request's lifecycle spans to
    that path after the run; ``timeline`` writes the columnar per-edge
    gauge timeline as JSONL, sampled every ``timeline_dt`` virtual
    seconds.  Both are read-only observers — summaries stay bit-identical
    with them on or off.  The port has no tracer or timeline yet: a spec
    that sets either is refused by ``Simulation.build``."""
    real_decode: bool = False
    dtype: Optional[str] = None
    dynamic: bool = False
    demote_on_deadline: bool = True
    prefill_div: int = 8
    replan_max_coop: int = 1
    retain_records: bool = True
    trace: Optional[str] = None
    timeline: Optional[str] = None
    timeline_dt: float = 0.5
    # real-decode execution strategy: batch_decode runs each round's
    # co-located requests as batched groups (one call per exit x
    # cache-geometry group); shard_decode would split groups over a device
    # mesh, which the port does not have yet.  Virtual timing is identical
    # either way — these are host-throughput knobs only.
    batch_decode: bool = True
    shard_decode: bool = False
    # slot-resident decode arena: arena_decode keeps each edge's decode
    # state resident in a persistent batch-slots cache and decodes a round
    # in at most one masked call per model exit — no per-token
    # restacking, no pad-by-replication.  arena_bucket sets
    # the arena-length policy ('pow2' rounds the shared cache length up to
    # a power of two, 'exact' keeps the workload maximum).  Virtual
    # timing is identical either way; off (the default) keeps runs
    # byte-identical to pre-arena goldens.
    arena_decode: bool = False
    arena_bucket: str = "pow2"

    def __post_init__(self):
        if self.arena_bucket not in ("pow2", "exact"):
            raise ValueError(
                f"unknown arena_bucket {self.arena_bucket!r}: expected "
                "'pow2' or 'exact'")


@dataclass
class CalibrationSpec(_Spec):
    """Run the scenario's planner on *measured* per-layer latency models
    instead of the analytic rooflines (docs/calibration.md).

    ``table`` names a :class:`repro_torch.calib.CalibrationTable` JSON produced by
    ``python -m repro_torch.calib measure``; at build time ``repro_torch.calib.fit``
    fits the paper-style per-layer-type regressions from it and swaps them
    into the planner.  ``anchor=True`` (default) rescales the fitted models
    so a full-branch decode step still costs the spec's
    ``edge_step_s`` / ``device_step_s`` — calibration then changes the
    *shape* of the cost surface (where cuts and exits land), not the
    simulated hardware speed; ``anchor=False`` uses raw measured seconds."""
    table: Optional[str] = None
    anchor: bool = True


@dataclass
class ScenarioSpec(_Spec):
    """One complete, serializable experiment: every knob of a fleet
    simulation in plain data.  ``Simulation(spec).run()`` executes it;
    ``spec.to_json()`` / ``ScenarioSpec.from_json()`` round-trip it
    losslessly (bit-identical metrics — tests/test_sim.py)."""
    name: str = "custom"
    description: str = ""
    seed: int = 0
    planner: PlannerSpec = field(default_factory=PlannerSpec)
    topology: TopologySpec = field(default_factory=TopologySpec)
    workload: WorkloadSpec = field(default_factory=WorkloadSpec)
    router: RouterSpec = field(default_factory=RouterSpec)
    engine: EngineSpec = field(default_factory=EngineSpec)
    mobility: Optional[MobilitySpec] = None
    # elasticity (docs/elastic.md): both default to None — the spec-level
    # off switch that keeps summaries bit-identical to pre-elastic runs
    autoscale: Optional[AutoscaleSpec] = None
    admission: Optional[AdmissionSpec] = None
    # calibration (docs/calibration.md): None runs the analytic latency
    # models — the pre-calibration behavior, byte-identical summaries
    calibration: Optional[CalibrationSpec] = None

    _NESTED = {"planner": PlannerSpec, "topology": TopologySpec,
               "workload": WorkloadSpec, "router": RouterSpec,
               "engine": EngineSpec, "mobility": MobilitySpec,
               "autoscale": AutoscaleSpec, "admission": AdmissionSpec,
               "calibration": CalibrationSpec}

    def seeds(self) -> DerivedSeeds:
        """The one place per-subsystem seeds come from (see module
        docstring): fleet sampling at ``seed``, arrivals at ``seed + 1``."""
        return DerivedSeeds(topology=self.seed, workload=self.seed + 1)

    @classmethod
    def from_dict(cls, d: Dict) -> "ScenarioSpec":
        _check_fields(cls, d)
        kw = dict(d)
        for key, sub_cls in cls._NESTED.items():
            if isinstance(kw.get(key), dict):
                kw[key] = sub_cls.from_dict(kw[key])
        return cls(**kw)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ScenarioSpec":
        return cls.from_dict(json.loads(s))


# `_NESTED` must not look like a dataclass field (no annotation above) —
# assert that so a future edit cannot silently turn it into one.
assert "_NESTED" not in {f.name for f in dataclasses.fields(ScenarioSpec)}


def apply_overrides(spec: ScenarioSpec,
                    assignments: Dict[str, object]) -> ScenarioSpec:
    """Return a new spec with dotted-path overrides applied, e.g.
    ``{"topology.num_devices": 100, "router.name": "joint"}`` — the engine
    behind the CLI's ``--set``.  Overriding into an unset optional section
    (``mobility``, ``autoscale``, ``admission``) materializes that
    section's default spec first, so ``--set autoscale.max_slots=8`` both
    enables autoscaling and tunes it.  Unknown paths raise ``ValueError``
    (the same strict check as ``from_dict``)."""
    d = spec.to_dict()
    for path, value in assignments.items():
        parts = path.split(".")
        cur = d
        for i, p in enumerate(parts[:-1]):
            if p not in cur:
                raise ValueError(f"unknown spec path {path!r} "
                                 f"(no field {p!r})")
            if cur[p] is None and p in ScenarioSpec._NESTED:
                cur[p] = ScenarioSpec._NESTED[p]().to_dict()
            if not isinstance(cur[p], dict):
                raise ValueError(f"spec path {path!r} descends into "
                                 f"non-spec field {p!r}")
            cur = cur[p]
        leaf = parts[-1]
        if leaf not in cur:
            raise ValueError(f"unknown spec path {path!r} "
                             f"(no field {leaf!r})")
        cur[leaf] = value
    return ScenarioSpec.from_dict(d)
