"""Fleet-level observability: streaming aggregates + optional records.

Everything is computed from plain floats recorded during the event loop, so
two runs with the same seed produce bit-identical summaries (the determinism
contract the tests assert).

:meth:`FleetMetrics.summary` is a pure function of *running aggregates*
maintained by :meth:`record` — named :class:`~repro_torch.obs.registry
.MetricsRegistry` instruments (counters, counter families, and two
sample-retaining histograms: latency and queue delay, whose exact
percentiles and ``np.mean`` pairwise sum need the raw samples, ~16 bytes
per request) plus the public per-edge dicts.
The per-request :class:`RequestRecord` objects and the ``handover_log`` are
*retention*, not inputs: with ``retain_records=False`` (the 10k-device /
sweep setting) neither is kept and memory stays O(edges) + the two float
buffers, while summaries are bit-identical to the retained run — a property
pinned by tests/test_fleet_perf.py (hypothesis: streaming aggregates ==
record-replay computation).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.obs.registry import Counter, CounterFamily, MetricsRegistry


@dataclass
class RequestRecord:
    rid: int
    tenant: str
    device: int
    edge: int                      # primary edge (-1 = device-only)
    arrival_s: float
    finish_s: float
    latency_s: float
    queue_delay_s: float
    met_slo: bool
    exit_point: int
    partition: int
    edges: tuple = ()              # full cooperative edge set (len > 1 = coop)
    handovers: int = 0             # mid-request migrations this request took
    migrated_bytes: int = 0        # state bytes it shipped across handovers


@dataclass
class FleetMetrics:
    num_edges: int
    # False drops per-request RequestRecord retention and the handover log
    # (running aggregates only; summary() is unchanged either way)
    retain_records: bool = True
    records: List[RequestRecord] = field(default_factory=list)
    edge_busy_s: Dict[int, float] = field(default_factory=dict)
    horizon_s: float = 0.0
    # edge<->edge backbone traffic from cooperative spans: (src, dst) -> bytes
    transfer_bytes: Dict[tuple, int] = field(default_factory=dict)
    transfer_events: int = 0
    # compute a secondary edge contributes to other edges' requests — kept
    # apart from edge_busy_s (slot occupancy) so utilization is not
    # double-billed: the primary's round already spans the full chain
    coop_busy_s: Dict[int, float] = field(default_factory=dict)
    # mobility handovers (docs/handover.md): every mid-request migration is
    # logged as (completion time, src edge, dst edge, state bytes); the bytes
    # are *also* billed as ordinary backbone transfer events, so migrated
    # traffic is conserved against transfer_bytes (invariant-tested)
    handover_log: List[tuple] = field(default_factory=list)
    # ---- shard-merge keys (repro_torch.sim.shard, docs/performance.md): the
    # virtual time each sample/log entry was *appended* at.  A sharded run
    # produces one FleetMetrics per tile; merging the per-tile streams by
    # (append time, tile index) with a stable sort reproduces the exact
    # append order of the equivalent single-process run, which is what the
    # order-sensitive aggregates (np.mean pairwise sums, handover_log) need
    # for bit-identical summaries.
    finish_keys: List[float] = field(default_factory=list)
    handover_at: List[float] = field(default_factory=list)
    # ---- elasticity (fleet.elastic, docs/elastic.md).  ``elastic`` is set
    # by the engine when an autoscaler or admission policy is attached; the
    # elastic summary keys (rejected / cost / scale counts) are emitted only
    # then, so summaries of non-elastic runs stay bit-identical to the
    # pre-elasticity schema (golden-pinned by tests/test_elastic.py).
    elastic: bool = False
    usd_per_slot_hour: float = 0.0
    # integral of provisioned capacity per edge (slot-seconds): summed from
    # the piecewise-constant capacity timeline at every change point
    slot_s: Dict[int, float] = field(default_factory=dict)
    # scale-event log: (virtual time, eid, old slots, new slots) — retained
    # like handover_log; ``scale_at`` carries the shard-merge keys
    capacity_log: List[tuple] = field(default_factory=list)
    scale_at: List[float] = field(default_factory=list)

    def __post_init__(self):
        # ---- running aggregates (the only inputs summary() reads), all
        # registered repro_torch.obs instruments: the counters/histograms are the
        # same plain ints and float lists the pre-registry fields held, so
        # summary() arithmetic is unchanged bitwise — but they now share
        # one named, snapshottable registry instead of ad-hoc privates
        r = self.registry = MetricsRegistry()
        self._lat = r.histogram("latency_s")    # percentiles need samples
        self._qd = r.histogram("queue_delay_s")
        self._n = r.counter("requests")
        self._met = r.counter("requests_met_slo")
        self._coop = r.counter("coop_requests")
        self._moved_n = r.counter("moved_requests")      # >= 1 handover ...
        self._moved_met = r.counter("moved_requests_met_slo")  # ... met SLO
        self._exits = r.family("exit_histogram")
        self._parts = r.family("partition_histogram")
        self._tenant_n = r.family("tenant_requests")
        self._tenant_met = r.family("tenant_requests_met_slo")
        self._handovers = r.counter("handovers")
        self._migrated = r.counter("migrated_bytes")
        # elasticity instruments are registered unconditionally (zero-cost
        # when idle) so merged() folds them through the same registry loop;
        # summary() only *emits* them when self.elastic
        self._rejected = r.counter("rejected")
        self._scales = r.counter("scale_events")
        # last capacity change point per edge: (virtual time, slots)
        self._cap_mark: Dict[int, tuple] = {}

    def record(self, rec: RequestRecord):
        """Fold one completed request into the running aggregates (and
        retain the record itself when ``retain_records``)."""
        self._n.inc()
        self._lat.observe(rec.latency_s)
        self._qd.observe(rec.queue_delay_s)
        if rec.met_slo:
            self._met.inc()
        if len(rec.edges) > 1:
            self._coop.inc()
        if rec.handovers > 0:
            self._moved_n.inc()
            if rec.met_slo:
                self._moved_met.inc()
        self._exits.inc(rec.exit_point)
        self._parts.inc(rec.partition)
        self._tenant_n.inc(rec.tenant)
        if rec.met_slo:
            self._tenant_met.inc(rec.tenant)
        self.horizon_s = max(self.horizon_s, rec.finish_s)
        self.finish_keys.append(rec.finish_s)
        if self.retain_records:
            self.records.append(rec)

    def add_busy(self, eid: int, dt_s: float):
        """Bill one round's slot-occupancy time to an edge."""
        self.edge_busy_s[eid] = self.edge_busy_s.get(eid, 0.0) + dt_s

    def add_transfer(self, src: int, dst: int, nbytes: int):
        """Aggregate one edge->edge backbone hand-off (coop span hop or
        handover state snapshot)."""
        key = (src, dst)
        self.transfer_bytes[key] = self.transfer_bytes.get(key, 0) + nbytes
        self.transfer_events += 1

    def add_coop_busy(self, eid: int, dt_s: float):
        """Track span compute a secondary edge served for another edge."""
        self.coop_busy_s[eid] = self.coop_busy_s.get(eid, 0.0) + dt_s

    def add_handover(self, src: int, dst: int, nbytes: int, t_s: float,
                     at_s: float = None):
        """Log one mid-request migration completing at virtual time t_s.
        ``at_s`` is the virtual time the migration was *decided* (the append
        time) — the shard-merge key; defaults to ``t_s``."""
        self._handovers.inc()
        self._migrated.inc(nbytes)
        if self.retain_records:
            self.handover_log.append((round(t_s, 9), src, dst, nbytes))
            self.handover_at.append(t_s if at_s is None else at_s)

    # ---------------------------------------------------------- elasticity
    def reject(self):
        """Count one shed arrival (admission policy 'reject'): an explicit
        outcome, never a silent drop — conservation is
        ``completed + rejected + in_flight == issued``."""
        self._rejected.inc()

    def mark_capacity(self, eid: int, cap: int, t_s: float):
        """Open the capacity timeline of an edge (engine: once per run at
        t=0 with the provisioned-at-build slot count)."""
        self._cap_mark[eid] = (t_s, cap)
        self.slot_s.setdefault(eid, 0.0)

    def on_scale(self, eid: int, old: int, new: int, t_s: float):
        """One capacity change point: bill the closed piecewise-constant
        segment into ``slot_s`` and log the event.  Segments are billed
        per edge in event order, so the integral is exactly reconstructable
        from ``capacity_log`` (tests/test_elastic.py pins float equality)."""
        t0, cap = self._cap_mark[eid]
        self.slot_s[eid] += cap * (t_s - t0)
        self._cap_mark[eid] = (t_s, new)
        self._scales.inc()
        if self.retain_records:
            self.capacity_log.append((round(t_s, 9), eid, old, new))
            self.scale_at.append(t_s)

    def finalize_capacity(self):
        """Close every edge's capacity timeline at the run horizon (engine:
        once after the event loop drains).  Idempotent per run end."""
        for eid in sorted(self._cap_mark):
            t0, cap = self._cap_mark[eid]
            end = max(self.horizon_s, t0)
            self.slot_s[eid] += cap * (end - t0)
            self._cap_mark[eid] = (end, cap)

    @property
    def rejected_count(self) -> int:
        return self._rejected.value

    # ------------------------------------------------------------ sharding
    @classmethod
    def merged(cls, parts: List["FleetMetrics"],
               num_edges: int) -> "FleetMetrics":
        """Fold per-tile metrics from a sharded run (repro_torch.sim.shard) into
        the metrics the equivalent single-process run would have produced,
        bit-identically.

        Tiles are disjoint (block-diagonal reachability), so per-edge float
        aggregates never collide across parts and integer counters sum
        exactly.  The order-sensitive pieces — the latency / queue-delay
        sample buffers (``np.mean`` is a pairwise sum over the append
        order) and ``handover_log`` — are rebuilt by a *stable* merge of
        the per-tile append streams keyed on (append virtual time, tile
        index): the union event loop pops cross-tile events in time order,
        and grid-aligned ties (the sampling sweep) process devices in
        ascending id = tile order, which is exactly this key."""
        out = cls(num_edges=num_edges,
                  retain_records=all(p.retain_records for p in parts))
        rows = []
        for pi, p in enumerate(parts):
            rows.extend((k, pi, j) for j, k in enumerate(p.finish_keys))
        rows.sort(key=lambda r: (r[0], r[1]))   # stable: within-tile order
        for _, pi, j in rows:
            p = parts[pi]
            out._lat.observe(p._lat.samples[j])
            out._qd.observe(p._qd.samples[j])
            out.finish_keys.append(p.finish_keys[j])
            if out.retain_records:
                out.records.append(p.records[j])
        hrows = []
        for pi, p in enumerate(parts):
            hrows.extend((k, pi, j) for j, k in enumerate(p.handover_at))
        hrows.sort(key=lambda r: (r[0], r[1]))
        for k, pi, j in hrows:
            out.handover_log.append(parts[pi].handover_log[j])
            out.handover_at.append(k)
        # elasticity: tile-disjoint per-edge slot integrals insert plainly;
        # the scale-event log merges on its append keys like handover_log
        out.elastic = any(p.elastic for p in parts)
        out.usd_per_slot_hour = max(
            (p.usd_per_slot_hour for p in parts), default=0.0)
        srows = []
        for pi, p in enumerate(parts):
            srows.extend((k, pi, j) for j, k in enumerate(p.scale_at))
        srows.sort(key=lambda r: (r[0], r[1]))
        for k, pi, j in srows:
            out.capacity_log.append(parts[pi].capacity_log[j])
            out.scale_at.append(k)
        for p in parts:
            for eid, v in p.slot_s.items():
                out.slot_s[eid] = out.slot_s.get(eid, 0.0) + v
        for p in parts:
            out.horizon_s = max(out.horizon_s, p.horizon_s)
            out.transfer_events += p.transfer_events
            # per-edge / per-pair keys are tile-disjoint: plain insertion,
            # no cross-part float accumulation can occur
            for eid, v in p.edge_busy_s.items():
                out.edge_busy_s[eid] = out.edge_busy_s.get(eid, 0.0) + v
            for eid, v in p.coop_busy_s.items():
                out.coop_busy_s[eid] = out.coop_busy_s.get(eid, 0.0) + v
            for key, v in p.transfer_bytes.items():
                out.transfer_bytes[key] = out.transfer_bytes.get(key, 0) + v
            for name, inst in p.registry._instruments.items():
                if isinstance(inst, Counter):
                    out.registry.counter(name).value += inst.value
                elif isinstance(inst, CounterFamily):
                    fam = out.registry.family(name)
                    for label, v in inst.items():
                        fam.inc(label, v)
        return out

    @property
    def handover_count(self) -> int:
        return self._handovers.value

    @property
    def migrated_bytes_total(self) -> int:
        return self._migrated.value

    # ------------------------------------------------------------ summaries
    def summary(self) -> Dict:
        """Aggregate into one flat dict.  Pure function of the streaming
        aggregates — same seed, same summary, bitwise, with or without
        record retention (the determinism contract the tests and benchmarks
        assert).

        Schema-complete at every request count: with zero completed requests
        the same keys come back with zero/empty values and ``None`` for the
        undefined statistics (percentiles, mean queue delay, handover SLO),
        so consumers indexing e.g. ``p95_latency_s`` on an empty sweep cell
        never KeyError.  Non-request aggregates (handovers, backbone bytes,
        cooperative busy time, edge utilization) still report whatever was
        actually observed."""
        n = self._n.value
        horizon = max(self.horizon_s, 1e-9)
        util = {eid: round(self.edge_busy_s.get(eid, 0.0) / horizon, 6)
                for eid in range(self.num_edges)}
        out = {
            "requests": n,
            "coop_requests": self._coop.value,
            "handovers": self._handovers.value,
            "migrated_mb": round(self._migrated.value / 1e6, 6),
            # SLO attainment restricted to requests that migrated at least
            # once — how well handed-over requests still land their deadline
            "handover_slo": (self._moved_met.value / self._moved_n.value
                             if self._moved_n.value else None),
            "backbone_mb": round(sum(self.transfer_bytes.values()) / 1e6, 6),
            "coop_busy_s": {eid: round(v, 6)
                            for eid, v in sorted(self.coop_busy_s.items())},
            "slo_attainment": self._met.value / n if n else 0.0,
            "p50_latency_s": self._lat.percentile(50),
            "p95_latency_s": self._lat.percentile(95),
            "p99_latency_s": self._lat.percentile(99),
            "mean_queue_delay_s": self._qd.mean(),
            "makespan_s": float(self.horizon_s),
            "edge_utilization": util,
            "slo_by_tenant": {t: self._tenant_met.get(t, 0) / c
                              for t, c in sorted(self._tenant_n.items())},
            "exit_histogram": self._exits.as_dict(),
            "partition_histogram": self._parts.as_dict(),
        }
        if self.elastic:
            # schema-complete at every request count — including the
            # all-rejected run: n == 0 keeps percentiles/means at None
            # above (the zero-request convention) while the reject path
            # still reports exactly what happened.  Emitted only for
            # elastic runs so non-elastic summaries keep the pre-elastic
            # key set bit-identically.
            rej = self._rejected.value
            issued = n + rej
            slot_hours = sum(
                v for _, v in sorted(self.slot_s.items())) / 3600.0
            out["rejected"] = rej
            out["reject_rate"] = rej / issued if issued else 0.0
            out["scale_events"] = self._scales.value
            out["slot_hours"] = slot_hours
            out["cost_usd"] = self.usd_per_slot_hour * slot_hours
        return out
