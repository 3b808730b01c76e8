"""Heterogeneous fleet topology: N device nodes x M edge nodes.

Each :class:`DeviceNode` carries its own bandwidth trace (an independent
draw from ``repro_torch.data.bandwidth``) and a compute-slowdown factor; each
:class:`EdgeNode` is a capacity-limited continuous-batching server with a
speed factor (>1 = slower hardware), so a fleet can mix one beefy edge with
several weak ones — the regime where routing policy matters.

Hot per-node state (``tokens_owed``, the backlog EMA, ``coop_inflight``,
``busy_until_s``) is stored struct-of-arrays on :class:`FleetTopology` so
routers and replan candidate scans read whole vectorized rows instead of
looping node objects (docs/performance.md).  Node attributes remain the
API — they are properties that index into the owning topology's arrays —
so engine code mutates scalars while routers read rows, with one storage
location for both.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.data.bandwidth import belgium_lte_like, oboe_like_traces


@dataclass
class TraceLink:
    """Time-indexed bandwidth trace (bytes/s), one per device.

    Unlike ``serving.tiers.Link`` (stepped once per decode iteration of a
    single engine), fleet links are read at *virtual timestamps* so that
    concurrent edges observe a consistent bandwidth history."""
    trace_bps: np.ndarray
    dt_s: float = 1.0

    def __post_init__(self):
        # hot path: plain-list indexing returns Python floats directly,
        # skipping per-call ndarray scalar boxing (same float64 values)
        self._trace = np.asarray(self.trace_bps, dtype=float).tolist()

    def bw_at(self, t_s: float) -> float:
        i = min(max(int(t_s / self.dt_s), 0), len(self._trace) - 1)
        return self._trace[i]


class _SoA:
    """Array bundle backing the hot node state of one fleet.  Owned by the
    :class:`FleetTopology` that bound it; nodes keep ``(_soa, _idx)`` and
    delegate their hot attributes here."""

    __slots__ = ("tokens_owed", "ema_round_s", "coop_inflight", "backlog_n",
                 "dev_busy_until_s", "capacity", "edge_cap_div")

    def __init__(self, num_edges: int, num_devices: int,
                 capacities: np.ndarray):
        self.tokens_owed = np.zeros(num_edges, np.int64)
        self.ema_round_s = np.zeros(num_edges)
        self.coop_inflight = np.zeros(num_edges, np.int64)
        # engine-maintained mirror of EdgeNode.backlog() (requests queued +
        # in the batch, tombstones excluded); lets JSQ routing argmin an
        # integer row instead of walking edge objects
        self.backlog_n = np.zeros(num_edges, np.int64)
        self.dev_busy_until_s = np.zeros(num_devices)
        # *live* provisioned decode slots per edge: static unless an
        # Autoscaler (fleet.elastic) drives `scale` events through the
        # engine, which mutate this via the EdgeNode.capacity setter
        self.capacity = np.asarray(capacities, np.int64).copy()
        # float64 of max(capacity, 1): integer-valued, so dividing by it is
        # bit-identical to the scalar ``/ max(e.capacity, 1)``; kept in
        # lock-step with `capacity` by the setter
        self.edge_cap_div = np.maximum(capacities, 1).astype(float)


@dataclass
class DeviceNode:
    """One end-user device: a bandwidth link (``TraceLink`` for static
    fleets, ``fleet.mobility.MobileLink`` under mobility) plus a compute
    slowdown; executes device-side partitions serially."""
    did: int
    link: object                 # TraceLink | MobileLink (duck-typed bw_at)
    slowdown: float = 1.0        # device-tier compute multiplier (>=1 = slower)

    def __post_init__(self):
        self._soa: Optional[_SoA] = None
        self._idx = -1
        self._busy = 0.0

    # --- runtime state (owned by FleetEngine; SoA-backed once bound) ---
    @property
    def busy_until_s(self) -> float:
        """Device-local execution is serial: one request at a time, later
        ones queue behind this timestamp."""
        s = self._soa
        return float(s.dev_busy_until_s[self._idx]) if s is not None \
            else self._busy

    @busy_until_s.setter
    def busy_until_s(self, v: float) -> None:
        s = self._soa
        if s is not None:
            s.dev_busy_until_s[self._idx] = v
        else:
            self._busy = v

    def local_backlog_s(self, now: float) -> float:
        return max(0.0, self.busy_until_s - now)


@dataclass
class EdgeNode:
    eid: int
    capacity: int = 8            # concurrent decode slots (continuous-batch width)
    speed: float = 1.0           # edge-tier compute multiplier (>=1 = slower)
    # --- runtime state (owned by FleetEngine) ---
    queue: list = field(default_factory=list)   # EDF heap: [deadline, seq, req]
    #                              entries; req slot None = tombstoned by a
    #                              replan (lazy deletion, see FleetEngine)
    q_dead: int = 0              # tombstoned entries still sitting in `queue`
    active: list = field(default_factory=list)  # requests in the running batch
    round_inflight: bool = False
    busy_s: float = 0.0
    completed: int = 0

    def __post_init__(self):
        self._soa: Optional[_SoA] = None
        self._idx = -1
        self._ema = 0.0
        self._coop = 0
        self._tokens = 0

    # --- SoA-backed hot state (vectorized row reads via FleetTopology) ---
    @property
    def ema_round_s(self) -> float:
        s = self._soa
        return float(s.ema_round_s[self._idx]) if s is not None else self._ema

    @ema_round_s.setter
    def ema_round_s(self, v: float) -> None:
        s = self._soa
        if s is not None:
            s.ema_round_s[self._idx] = v
        else:
            self._ema = v

    @property
    def coop_inflight(self) -> int:
        """*Planned* cooperative span memberships for requests slotted at
        other edges; per-round demotion may temporarily shrink the spans
        actually executed (see coop_busy_s in FleetMetrics for realized
        compute)."""
        s = self._soa
        return int(s.coop_inflight[self._idx]) if s is not None else self._coop

    @coop_inflight.setter
    def coop_inflight(self, v: int) -> None:
        s = self._soa
        if s is not None:
            s.coop_inflight[self._idx] = v
        else:
            self._coop = v

    @property
    def tokens_owed(self) -> int:
        """Decode tokens still owed to queued+active requests (FleetEngine:
        +max_new_tokens on enqueue, -1 per request per round)."""
        s = self._soa
        return int(s.tokens_owed[self._idx]) if s is not None else self._tokens

    @tokens_owed.setter
    def tokens_owed(self, v: int) -> None:
        s = self._soa
        if s is not None:
            s.tokens_owed[self._idx] = v
        else:
            self._tokens = v

    def backlog(self) -> int:
        """Requests currently bound to this edge (queued + in the batch);
        tombstoned queue entries are already gone logically."""
        return len(self.queue) - self.q_dead + len(self.active)

    def backlog_s(self) -> float:
        """Pending-work estimate (seconds) for latency-aware routing: tokens
        still owed to queued + active requests, amortized over the batch
        width at the recent round time.  Counting *tokens* rather than
        requests matters — a queued arrival waits for slots that free at
        whole-request granularity, so per-request counting underestimates
        the wait by the mean decode length.  ``tokens_owed`` is maintained
        incrementally because this sits on the per-arrival routing hot path
        (every edge per arrival, times every candidate set under joint
        planning); routers read the whole fleet at once via
        :meth:`FleetTopology.backlog_s_row`."""
        per_round = self.ema_round_s if self.ema_round_s > 0 else 1e-3
        return per_round * self.tokens_owed / max(self.capacity, 1)


def _edge_capacity_get(self) -> int:
    s = getattr(self, "_soa", None)
    return int(s.capacity[self._idx]) if s is not None else self._cap


def _edge_capacity_set(self, v: int) -> None:
    # Runs once from the generated dataclass __init__ (before _soa exists:
    # getattr fallback) and thereafter from the engine's `scale` events.
    # edge_cap_div tracks max(capacity, 1) so the vectorized backlog row
    # stays bit-identical to the scalar backlog_s().
    s = getattr(self, "_soa", None)
    if s is not None:
        s.capacity[self._idx] = v
        s.edge_cap_div[self._idx] = float(max(v, 1))
    else:
        self._cap = int(v)


# Attached after class creation so the dataclass keeps `capacity: int = 8`
# in its __init__ signature while reads/writes route into the SoA column
# once the topology binds the node (same pattern as the in-class hot-state
# properties; those can live in the body because they have no field).
EdgeNode.capacity = property(_edge_capacity_get, _edge_capacity_set)


@dataclass
class FleetTopology:
    devices: List[DeviceNode]
    edges: List[EdgeNode]
    # edge<->edge backbone bandwidth (bytes/s): edges sit on a wired LAN/MAN,
    # orders of magnitude above the device wireless links, which is what
    # makes CoEdge-style multi-edge spans viable at all.
    edge_bw_bps: float = 50e6

    def __post_init__(self):
        edges, devices = self.edges, self.devices
        # id-contiguity contract: node ids are ``id0 + list index``, so the
        # SoA row of edge ``eid`` is ``eid - eid0``.  Holds for every
        # builder (make_fleet, make_mobile_fleet, shard tiles).
        self.eid0 = edges[0].eid if edges else 0
        self.did0 = devices[0].did if devices else 0
        for i, e in enumerate(edges):
            if e.eid != self.eid0 + i:
                raise ValueError("edge ids must be contiguous from eid0")
        for i, d in enumerate(devices):
            if d.did != self.did0 + i:
                raise ValueError("device ids must be contiguous from did0")
        self.edge_speed = np.array([e.speed for e in edges])
        # hashable speed tuple for plan/step cache keys (routers key on the
        # immutable inputs, never on topology object identity)
        self.speed_key = tuple(self.edge_speed.tolist())
        caps = np.array([e.capacity for e in edges], np.int64)
        soa = _SoA(len(edges), len(devices), caps)
        for i, e in enumerate(edges):
            soa.tokens_owed[i] = e.tokens_owed
            soa.ema_round_s[i] = e.ema_round_s
            soa.coop_inflight[i] = e.coop_inflight
            e._soa, e._idx = soa, i
        for i, d in enumerate(devices):
            soa.dev_busy_until_s[i] = d.busy_until_s
            d._soa, d._idx = soa, i
        self._soa = soa
        # live view of provisioned slots (scale events mutate it in place)
        # plus the provisioned-at-build snapshot the engine resets from at
        # the start of each autoscaled run
        self.edge_capacity = soa.capacity
        self.base_capacity = caps

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    @property
    def num_edges(self) -> int:
        return len(self.edges)

    def edge(self, eid: int) -> EdgeNode:
        return self.edges[eid - self.eid0]

    def device(self, did: int) -> DeviceNode:
        return self.devices[did - self.did0]

    # --- vectorized rows (one entry per edge, in eid order) ---
    def backlog_s_row(self) -> np.ndarray:
        """All edges' :meth:`EdgeNode.backlog_s` in one vector expression —
        elementwise identical to the scalar method (same op order per
        entry)."""
        s = self._soa
        per_round = np.where(s.ema_round_s > 0.0, s.ema_round_s, 1e-3)
        return per_round * s.tokens_owed / s.edge_cap_div

    def backlog_n_row(self) -> np.ndarray:
        """Engine-maintained request-count backlog per edge (mirror of
        :meth:`EdgeNode.backlog`; see FleetEngine's enqueue/dequeue)."""
        return self._soa.backlog_n

    def tokens_owed_row(self) -> np.ndarray:
        return self._soa.tokens_owed

    def coop_inflight_row(self) -> np.ndarray:
        return self._soa.coop_inflight


def make_fleet(num_devices: int, num_edges: int, *, seed: int = 0,
               trace: str = "oboe", edge_capacity: int = 8,
               hetero_edges: bool = True, max_edge_slowdown: float = 3.0,
               device_slowdown_range=(0.8, 2.5),
               lo_mbps: float = 0.3, hi_mbps: float = 6.0,
               trace_len: int = 600,
               edge_bw_mbps: float = 400.0,
               eid0: int = 0, did0: int = 0) -> FleetTopology:
    """Sample a reproducible heterogeneous topology.

    ``trace='oboe'`` gives each device an independent piecewise-stationary
    trace (Sec. V-C statistics); ``trace='lte'`` cycles the five Belgium-LTE
    mobility modes across devices.  ``eid0``/``did0`` offset node ids for
    shard tiles (repro_torch.sim.shard) without perturbing any sampling."""
    rng = np.random.default_rng(seed)
    if trace == "oboe":
        traces = oboe_like_traces(seed=seed, num=num_devices, chunks=trace_len,
                                  lo_mbps=lo_mbps, hi_mbps=hi_mbps)
    elif trace == "lte":
        modes = ["foot", "bicycle", "bus", "train", "car"]
        traces = [belgium_lte_like(seed=seed + i, length=trace_len,
                                   transport=modes[i % len(modes)],
                                   hi_mbps=hi_mbps)
                  for i in range(num_devices)]
    else:
        raise ValueError(f"unknown trace kind: {trace!r}")
    lo, hi = device_slowdown_range
    # one batched draw == the former per-device scalar draws, bit-identical
    # (np.random.Generator.uniform fills the output sequentially)
    slowdowns = rng.uniform(lo, hi, num_devices).tolist()
    devices = [DeviceNode(did0 + i, TraceLink(np.asarray(traces[i])),
                          slowdown=slowdowns[i])
               for i in range(num_devices)]
    speeds = np.linspace(1.0, max_edge_slowdown, num_edges) if hetero_edges \
        else np.ones(num_edges)
    speeds = speeds.tolist()
    edges = [EdgeNode(eid0 + j, capacity=edge_capacity, speed=speeds[j])
             for j in range(num_edges)]
    return FleetTopology(devices, edges, edge_bw_bps=edge_bw_mbps * 125e3)
