"""Event-driven fleet engine: continuous batching per edge over a
device x edge topology.

Per arrival the router picks an edge; the edge holds an EDF queue and a
running batch of up to ``capacity`` requests.  Decode proceeds in *rounds*
(one token per active request per round): at each round boundary new
requests are admitted into the running batch and finished ones retire —
iteration-level continuous batching.  Round timing reuses the per-pair
Edgent stack through :class:`~repro_torch.serving.engine.CoInferenceStepper`
(plan at the device's current bandwidth, per-exit step times, ``pick_exit``
deadline demotion); the round lasts as long as its slowest member, i.e. the
straggler defines the batch step.

With ``model=None`` the engine is a pure virtual-time simulator (used by
``benchmarks/fleet_scale.py`` at hundreds of devices).  With a real model +
params it also runs the actual decode path per request (B=1 caches, the
per-exit decode callables shared fleet-wide via the stepper), on the
device that holds the params: the port's kernels on the card, their plain
versions on the CPU.

With ``mobility=`` + ``handover=`` the engine additionally models **device
motion and mid-request migration** (docs/handover.md): per-round bandwidth
is billed to the request's *serving* edge from the position->bandwidth law,
periodic ``sample`` events feed each device's handover policy (BOCD change
points or the geometry oracle), and a fired policy re-plans the device's
in-flight requests via :meth:`~repro_torch.fleet.joint.JointPlanner.replan` —
snapshotting the edge-resident state at the current cut, billing the
transfer over the backbone, and re-binding the request to its new primary
without dropping or double-counting it.
"""
from __future__ import annotations

import heapq
import time
from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch.core.graph import InferenceGraph
from repro_torch.core.planner import EdgentPlanner
from repro_torch.fleet.cluster import EdgeNode, FleetTopology
from repro_torch.fleet.coop import (effective_assignment, hop_schedule,
                              span_seconds)
from repro_torch.fleet.events import EventQueue
from repro_torch.fleet.joint import JointDecision, JointPlanner
from repro_torch.fleet.metrics import FleetMetrics, RequestRecord
from repro_torch.fleet.mobility import (HandoverController, MobilityModel,
                                  migration_bytes)
from repro_torch.fleet.router import Router, RoundRobinRouter, make_router
from repro_torch.fleet.workload import FleetRequest
from repro_torch.serving.engine import CoInferenceStepper


class FleetEngine:
    """Event-driven fleet simulator: see the module docstring for the model
    and docs/fleet.md for the architecture.  ``run(workload)`` is the only
    public entry point; everything else is event handlers."""

    def __init__(self, topo: FleetTopology, graph: InferenceGraph,
                 planner: EdgentPlanner, *,
                 router: Union[Router, str, None] = None,
                 model=None, params=None, dynamic: bool = False,
                 dtype=None, demote_on_deadline: bool = True,
                 prefill_div: int = 8,
                 mobility: Optional[MobilityModel] = None,
                 handover: Union[HandoverController, str, None] = None,
                 replan_max_coop: int = 1, max_coop: int = 3,
                 retain_records: bool = True,
                 compact_ratio: Optional[float] = 0.5,
                 autoscaler=None, admission=None,
                 tracer=None, timeline=None, profiler=None,
                 batch_decode: bool = True, shard_decode: bool = False,
                 arena_decode: bool = False, arena_bucket: str = "pow2"):
        self.topo = topo
        # elasticity (fleet.elastic, docs/elastic.md): an Autoscaler drives
        # `scale` events that resize per-edge capacity (scale-down drains —
        # busy slots are never reclaimed); an AdmissionControl sheds
        # arrivals at saturated edges (reject or device-only fallback).
        # Both None (the default) leaves every code path byte-identical to
        # the pre-elasticity engine (golden-pinned).
        self.autoscaler = autoscaler
        self.admission = admission
        self._cap_target = {}          # eid -> pending drain target
        # EDF-heap tombstone compaction threshold (None disables); see
        # _maybe_compact.  Summaries are bit-identical either way.
        self.compact_ratio = compact_ratio
        self.compactions = 0
        # observability (repro_torch.obs, docs/observability.md) — all optional,
        # all read-only with respect to simulation state, so summaries are
        # bit-identical with observers attached or not (tests/test_obs.py):
        #   tracer   — repro_torch.obs.trace.Tracer, fed at every lifecycle edge
        #   timeline — repro_torch.obs.timeline.Timeline, sampled on the sweep
        #              grid (or dedicated "obs" events for static fleets)
        #   profiler — repro_torch.obs.profile.SimProfiler, wall time per event
        self.tracer = tracer
        self.timeline = timeline
        self.profiler = profiler
        self.model, self.params = model, params
        self.dtype = dtype
        # real-decode execution strategy: with batch_decode a round's
        # co-located requests decode as batched groups — one call per
        # (exit, cache-geometry) group — instead of one call per request;
        # shard_decode would split a group over a device mesh, which the
        # port does not have yet (the plain batched call runs).  Tokens
        # agree with the serial path up to the reduction order of a batched
        # GEMM (tests/test_torch_fleet.py); virtual timing never depends on
        # these flags.
        self.batch_decode = batch_decode
        self.shard_decode = shard_decode
        # slot-resident decode arena: with arena_decode each edge holds a
        # persistent batch-slots cache — requests are copied in at
        # admission, stay resident across rounds, and a round is at most
        # one masked call per model exit (no per-token restacking, no
        # pad-by-replication).  Tokens agree with the serial path as the
        # batched path's do (tests/test_torch_arena.py); virtual timing
        # never depends on the flag.
        self.arena_decode = arena_decode
        self.arena_bucket = arena_bucket
        self._arenas = {}              # eid -> DecodeArena (reset per run)
        self._arena_len_hint = 1
        self.demote = demote_on_deadline
        self.prefill_div = prefill_div
        # retain_records=False keeps FleetMetrics to its running aggregates
        # (summaries unchanged, memory ~O(edges) instead of per-request
        # record objects) — the 10k-device setting
        self.retain_records = retain_records
        # one stepper for the whole fleet: the plan cache and the decode
        # variants are shared across every device and edge
        self.stepper = CoInferenceStepper(model, graph, planner,
                                          dynamic=dynamic)
        self.mobility = mobility
        if isinstance(handover, str):
            if handover not in HandoverController.POLICIES:
                raise ValueError(
                    f"unknown handover policy {handover!r}: expected one "
                    f"of {', '.join(HandoverController.POLICIES)} (see "
                    "repro_torch.fleet.mobility.HandoverController)")
            if mobility is None:
                raise ValueError(
                    f"handover={handover!r} needs a mobility model: pass "
                    "mobility= alongside the policy name (from "
                    "make_mobile_fleet, or build the engine via a "
                    "repro_torch.sim mobile topology)")
            handover = HandoverController(mobility, policy=handover)
        self.handover = handover
        # mid-request replanning searches (edge set, partition, exit) with
        # nearest-first candidate ordering; max_coop=1 keeps migrated
        # requests single-edge by default (coop re-binding is opt-in)
        self.replanner = JointPlanner(
            self.stepper, topo, max_coop=replan_max_coop,
            prefill_div=prefill_div, mobility=mobility) \
            if mobility is not None else None
        if router is None:
            router = RoundRobinRouter()
        elif isinstance(router, str):
            # make_router validates the name against the registry and
            # raises ValueError (with the known names) on a bad one
            router = make_router(router, stepper=self.stepper, topo=topo,
                                 max_coop=max_coop, prefill_div=prefill_div,
                                 mobility=mobility, admission=admission)
        self.router = router
        # hop/span timelines are memoized on the *stepper* (fleet-wide: all
        # engines sharing the stepper share the entries), keyed on exit,
        # assignment, and this topology's backbone bandwidth
        self._hop_cache = self.stepper.hop_cache
        # run() resets these; initialized here so _enqueue/_dequeue work on
        # an engine driven directly (tests exercise queue mechanics bare)
        self.events_processed = 0
        self.event_counts = {}
        self.enqueued = self.tombstoned = 0

    # ---------------------------------------------------------------- run
    def run(self, workload: List[FleetRequest]) -> FleetMetrics:
        """Simulate one workload to completion and return its metrics.

        Deterministic: the same topology + workload + seed replays the
        identical event schedule (bit-identical summaries).  Engines and
        workload lists are reusable — all runtime state is reset here."""
        evq = EventQueue()
        metrics = FleetMetrics(num_edges=self.topo.num_edges,
                               retain_records=self.retain_records)
        self._qseq = 0
        self._pending = len(workload)      # requests not yet completed
        self._dev_inflight = {d.did: [] for d in self.topo.devices}
        self._qentry = {}                  # req -> its live edge-queue entry
        self.router.reset()                # stateful policies must not leak
        #                                    decisions across runs
        if self.handover is not None:
            self.handover.reset()
        for edge in self.topo.edges:       # reset runtime state for reruns
            edge.queue, edge.active = [], []
            edge.q_dead = 0
            edge.round_inflight = False
            edge.busy_s = edge.ema_round_s = 0.0
            edge.completed = 0
            edge.coop_inflight = 0
            edge.tokens_owed = 0
        self.topo._soa.backlog_n[:] = 0
        self.compactions = 0
        for dev in self.topo.devices:
            dev.busy_until_s = 0.0
        elastic = self.autoscaler is not None or self.admission is not None
        if elastic:
            metrics.elastic = True
            self._cap_target = {}
            if self.autoscaler is not None:
                # rerunnable engines: capacity restarts from the
                # provisioned-at-build snapshot, not wherever the previous
                # run's autoscaler left it
                soa = self.topo._soa
                soa.capacity[:] = self.topo.base_capacity
                soa.edge_cap_div[:] = np.maximum(
                    self.topo.base_capacity, 1).astype(float)
                self.autoscaler.reset()
                metrics.usd_per_slot_hour = self.autoscaler.usd_per_slot_hour
                if workload:
                    evq.push(self.autoscaler.decide_dt, "scale", None)
            # the price model integrates *live* capacity from t=0, so the
            # timeline opens for every edge even if it never changes
            for edge in self.topo.edges:
                metrics.mark_capacity(edge.eid, edge.capacity, 0.0)
        self._arenas = {}                  # arena residency is per-run state
        if self.arena_decode and self.model is not None:
            # pre-size the arena length from the workload so steady-state
            # geometry (and the decode-variant population) is fixed from
            # the first round: the longest cache any request will need
            self._arena_len_hint = max(
                (r.prompt_len + r.max_new_tokens + 1 for r in workload),
                default=1)
        for req in workload:               # same: a workload list is reusable
            req.edge, req.admitted_s = -1, None
            req.assign = None
            req.tokens_done, req.prefill_pending = 0, True
            req.plan, req.exit_point = None, 0
            req.cache, req.next_tok, req.tokens = None, None, []
            req.replan_pending = req.migrating = False
            req.handovers, req.migrated_bytes = 0, 0
            req.coop_counted = False
            evq.push(req.arrival_s, "arrival", req)
        sweeping = self.handover is not None and self.handover.policy != "none"
        if sweeping:
            # one fleet-wide sampling sweep per slot: the sweep observes
            # every device in ascending id order — the exact pop order the
            # per-device events it batches had under the EventQueue's FIFO
            # tie-break (see repro_torch.fleet.events)
            evq.push(self.handover.sample_dt, "sample", None)
        if self.tracer is not None:
            self.tracer.reset()            # reused engines: one run per file
            self.tracer.annotate_fleet(self.topo)
        if self.timeline is not None:
            self.timeline.reset()
            if not sweeping and workload:
                # no sampling grid to piggyback on: schedule a dedicated
                # snapshot grid.  "obs" events never mutate state, and the
                # EventQueue's FIFO tie-break keeps the relative order of
                # all other events unchanged — summaries stay bit-identical
                # with the timeline attached (tests/test_obs.py)
                evq.push(self.timeline.dt, "obs", None)
        prof = self.profiler
        if prof is not None:
            prof.reset()
        self.events_processed = 0          # sweeps count once per device
        self.event_counts = {}             # heap pops by event kind
        self.enqueued = self.tombstoned = 0
        while evq:
            ev = evq.pop()
            self.events_processed += 1
            kind = ev.kind
            self.event_counts[kind] = self.event_counts.get(kind, 0) + 1
            if prof is not None:
                t0 = time.perf_counter()
            if kind == "arrival":
                self._on_arrival(ev.payload, evq, metrics)
            elif kind == "round":
                self._on_round_done(ev.payload, evq, metrics)
            elif kind == "local_done":
                self._on_local_done(ev.payload, evq, metrics)
            elif kind == "transfer":
                src, dst, nbytes = ev.payload
                metrics.add_transfer(src, dst, nbytes)
            elif kind == "sample":
                self._on_sample_sweep(evq, metrics)
            elif kind == "handover":
                self._on_handover(ev.payload, evq, metrics)
            elif kind == "scale":
                self._on_scale(evq, metrics)
            elif kind == "obs":
                self._on_obs(evq)
            if prof is not None:
                prof.add(kind, time.perf_counter() - t0, len(evq))
        if elastic:
            metrics.finalize_capacity()
        if self.tracer is not None and self.model is not None:
            # decode-efficiency panel data for `repro_torch.obs report`: a trace
            # metadata record (no timestamp — it is not a span), read-only
            # with respect to the simulation like every tracer write.
            # Stepper counters are cumulative over its lifetime.
            st = self.stepper.cache_stats()
            self.tracer.decode_stats({"decode": st["decode"],
                                      "arena": st["arena"],
                                      "jit": st["jit"]})
        return metrics

    # ------------------------------------------------------------ bandwidth
    def _bw(self, device, eid: int, now: float) -> float:
        """Wireless bandwidth the device sees *to a specific edge*: under
        mobility this is the position-dependent per-pair rate (a request
        keeps paying its serving edge's link, which degrades as the device
        walks away); otherwise the device's single trace."""
        if self.mobility is not None and eid >= 0:
            return self.mobility.bw(device.did, eid, now)
        return device.link.bw_at(now)

    # ---------------------------------------------------------------- events
    def _on_arrival(self, req: FleetRequest, evq: EventQueue,
                    metrics: FleetMetrics):
        device = self.topo.device(req.device)
        bw = device.link.bw_at(evq.now)
        tr = self.tracer
        if tr is not None:
            # request-scoped async span: survives queue moves and handovers
            tr.async_begin("request", req.rid, evq.now, tr.PID_DEVICES,
                           req.device, args={"tenant": req.tenant,
                                             "device": req.device})
        decision = self.router.decide(req, device, self.topo, evq.now)
        if decision is not None:
            # joint routing: (edge set, partition, exit) chosen together;
            # the primary edge hosts the queue slot and decode rounds
            req.plan, req.assign = decision.plan, decision.assign
            if decision.local:
                self._run_local(req, device, bw, evq)
                return
            edge = self.topo.edge(decision.primary)
        else:
            req.plan = self.stepper.plan(bw)
            if req.plan.partition == 0:
                # Edgent chose device-only: the request never touches an edge
                self._run_local(req, device, bw, evq)
                return
            edge = self.router.route(req, device, self.topo, evq.now)
            if self.mobility is not None:
                # mobility-aware pricing: the router shopped with the *best*
                # signal (MobileLink.bw_at = nearest edge); once placement
                # is fixed, the plan must price the link the request will
                # actually pay — the serving edge's.  For the nearest-edge
                # router the two bandwidths are identical and this is a
                # no-op; for placement policies that pick another edge the
                # old code silently kept the best-signal plan.  (The joint
                # decision branch above already prices each candidate at
                # its own primary's bandwidth — JointPlanner._decide_mobile.)
                bw_serve = self._bw(device, edge.eid, evq.now)
                if bw_serve != bw:
                    req.plan = self.stepper.plan(bw_serve)
                    if req.plan.partition == 0:
                        self._run_local(req, device, bw_serve, evq)
                        return
        if self.admission is not None and self.admission.saturated(edge):
            # per-cell admission control: the placed edge is full.  (Joint
            # routing already masks saturated primaries — this is the
            # engine-level backstop for placement-only routers.)
            self._admission_deny(req, device, bw, evq, metrics)
            return
        req.edge = edge.eid
        if tr is not None:
            tr.instant("plan", evq.now, tr.PID_DEVICES, req.device, args={
                "rid": req.rid, "partition": req.plan.partition,
                "exit": req.plan.exit_point, "edge": edge.eid,
                "coop": list(req.assign.eids) if req.assign is not None
                else [edge.eid]})
            tr.async_begin("queue", req.rid, evq.now, tr.PID_DEVICES,
                           req.device, args={"edge": edge.eid})
        self._enqueue(edge, req)
        edge.tokens_owed += req.max_new_tokens
        self._dev_inflight[req.device].append(req)
        if not edge.round_inflight:
            self._begin_round(edge, evq, metrics)

    def _enqueue(self, edge: EdgeNode, req: FleetRequest):
        """EDF-queue a request at an edge.  Entries are mutable lists so a
        mid-request replan can *tombstone* them in O(1) (slot 2 set to None)
        instead of rebuilding + re-heapifying the whole queue; admission
        skips dead entries as they surface (lazy deletion)."""
        entry = [req.deadline_s, self._qseq, req]
        self._qentry[req] = entry
        heapq.heappush(edge.queue, entry)
        self._qseq += 1
        self.enqueued += 1
        self._blg_add(edge, 1)

    def _dequeue(self, edge: EdgeNode, req: FleetRequest):
        """Remove a queued request in O(1): tombstone its heap entry."""
        entry = self._qentry.pop(req)
        entry[2] = None
        edge.q_dead += 1
        self.tombstoned += 1
        self._blg_add(edge, -1)
        self._maybe_compact(edge)

    @staticmethod
    def _blg_add(edge: EdgeNode, delta: int):
        """Maintain the SoA mirror of ``EdgeNode.backlog()`` (queued +
        active, tombstones excluded) at its net-change sites: enqueue (+1),
        tombstone (-1), completion (-1), migration off the batch (-1).
        Queue->batch admission is net zero.  Bare edges (no topology) have
        no row to maintain."""
        s = edge._soa
        if s is not None:
            s.backlog_n[edge._idx] += delta

    def _maybe_compact(self, edge: EdgeNode):
        """Rebuild an edge's EDF heap once tombstones exceed
        ``compact_ratio`` of its entries.  Lazy O(1) deletion alone lets
        dead entries accumulate without bound over a long mobility run
        (every push pays log of the *inflated* heap); dropping them and
        re-heapifying is O(live) and amortized O(1) per tombstone.  Pop
        order is untouched — the heap is a total order on (deadline, seq),
        and admission skips tombstones either way — so summaries and the
        handover log are bit-identical with compaction on or off
        (tests/test_fleet_perf.py pins this)."""
        ratio = self.compact_ratio
        if ratio is None:
            return
        q_dead = edge.q_dead
        if q_dead and q_dead >= ratio * len(edge.queue):
            edge.queue = [en for en in edge.queue if en[2] is not None]
            heapq.heapify(edge.queue)
            edge.q_dead = 0
            self.compactions += 1

    def _run_local(self, req: FleetRequest, device, bw: float,
                   evq: EventQueue):
        # the device decodes one request at a time: later arrivals queue
        # behind its in-flight local work (no free concurrency on-device)
        now = evq.now
        start = max(now, device.busy_until_s)
        req.admitted_s = start
        per_exit = self.stepper.per_exit_times_cached(
            0, bw, device_load=device.slowdown)
        # prefill is billed at the plan exit regardless of demotion, so it
        # must come out of the budget the exit choice sees
        prefill = per_exit[req.plan.exit_point - 1] * \
            max(1, req.prompt_len // self.prefill_div)
        req.exit_point = self.stepper.choose_exit(
            req.deadline_s - start - prefill, per_exit, req.max_new_tokens,
            req.plan.exit_point) if self.demote else req.plan.exit_point
        total = per_exit[req.exit_point - 1] * req.max_new_tokens + prefill
        tr = self.tracer
        if tr is not None:
            did = device.did
            tr.instant("plan", now, tr.PID_DEVICES, did, args={
                "rid": req.rid, "partition": 0,
                "exit": req.plan.exit_point})
            if start > now:
                tr.complete("queue", now, start, tr.PID_DEVICES, did,
                            args={"rid": req.rid})
            if prefill > 0.0:
                tr.complete("prefill", start, start + prefill,
                            tr.PID_DEVICES, did, args={"rid": req.rid})
            tr.complete("decode", start + prefill, start + total,
                        tr.PID_DEVICES, did,
                        args={"rid": req.rid, "exit": req.exit_point,
                              "tokens": req.max_new_tokens})
        if self.model is not None:
            self._prefill_real(req)
            while req.tokens_done < req.max_new_tokens:
                self._decode_real(req)
                req.tokens_done += 1
            req.cache = req.next_tok = None
        device.busy_until_s = start + total
        evq.push(start + total, "local_done", req)

    def _on_local_done(self, req: FleetRequest, evq: EventQueue,
                       metrics: FleetMetrics):
        now = evq.now
        self._pending -= 1
        tr = self.tracer
        if tr is not None:
            met = now <= req.deadline_s
            tr.instant("complete", now, tr.PID_DEVICES, req.device,
                       args={"rid": req.rid, "met_slo": met,
                             "exit": req.exit_point})
            tr.async_end("request", req.rid, now, tr.PID_DEVICES,
                         req.device, args={"met_slo": met})
        metrics.record(RequestRecord(
            rid=req.rid, tenant=req.tenant, device=req.device, edge=-1,
            arrival_s=req.arrival_s, finish_s=now,
            latency_s=max(0.0, now - req.arrival_s),
            queue_delay_s=max(0.0, (req.admitted_s or 0.0) - req.arrival_s),
            met_slo=now <= req.deadline_s, exit_point=req.exit_point,
            partition=0, handovers=req.handovers,
            migrated_bytes=req.migrated_bytes))

    def _on_round_done(self, edge: EdgeNode, evq: EventQueue,
                       metrics: FleetMetrics):
        now = evq.now
        still_active = []
        for req in edge.active:
            req.tokens_done += 1
            edge.tokens_owed -= 1
            if req.tokens_done >= req.max_new_tokens:
                edge.completed += 1
                self._blg_add(edge, -1)
                self._pending -= 1
                self._untrack(req)
                if self.tracer is not None:
                    tr = self.tracer
                    met = now <= req.deadline_s
                    tr.instant("complete", now, edge.eid, 0,
                               args={"rid": req.rid, "met_slo": met,
                                     "exit": req.exit_point})
                    tr.async_end("request", req.rid, now, tr.PID_DEVICES,
                                 req.device, args={"met_slo": met})
                metrics.record(RequestRecord(
                    rid=req.rid, tenant=req.tenant, device=req.device,
                    edge=edge.eid, arrival_s=req.arrival_s, finish_s=now,
                    latency_s=max(0.0, now - req.arrival_s),
                    queue_delay_s=max(0.0, (now if req.admitted_s is None
                                            else req.admitted_s)
                                      - req.arrival_s),
                    met_slo=now <= req.deadline_s,
                    exit_point=req.exit_point,
                    partition=req.plan.partition,
                    edges=(req.assign.eids if req.assign is not None
                           else (edge.eid,)),
                    handovers=req.handovers,
                    migrated_bytes=req.migrated_bytes))
                self._release_coop(req)
                req.cache = req.next_tok = None      # free decode state
                if self.arena_decode and self.model is not None:
                    ar = self._arenas.get(edge.eid)
                    if ar is not None and ar.has(req.rid):
                        ar.evict(req.rid)            # free the slot row
            elif req.replan_pending:
                # the handover policy fired mid-round; the migration (or
                # in-place replan) executes at this round boundary, where the
                # edge-resident state is at a well-defined cut
                req.replan_pending = False
                self._replan_active(req, edge, now, evq, metrics,
                                    still_active)
            else:
                still_active.append(req)
        edge.active = still_active
        edge.round_inflight = False
        if self.autoscaler is not None:
            # scale-down drain: reclaim provisioned slots as requests retire
            # (capacity never drops below the running batch)
            tgt = self._cap_target.get(edge.eid)
            if tgt is not None:
                cap = max(tgt, len(edge.active))
                if cap < edge.capacity:
                    self._set_capacity(edge, cap, now, metrics)
                if cap == tgt:
                    del self._cap_target[edge.eid]
        self._begin_round(edge, evq, metrics)

    # ---------------------------------------------------------------- rounds
    def _begin_round(self, edge: EdgeNode, evq: EventQueue,
                     metrics: FleetMetrics):
        now = evq.now
        # admit in EDF order up to the batch width (continuous batching:
        # this happens at every round boundary, not at batch completion).
        # While a scale-down is draining, admission is capped at the drain
        # *target*, not the still-provisioned width — otherwise sustained
        # load would refill reclaimed slots and the drain never completes.
        limit = edge.capacity
        if self.autoscaler is not None:
            limit = min(limit, self._cap_target.get(edge.eid, limit))
        while edge.queue and len(edge.active) < limit:
            req = heapq.heappop(edge.queue)[2]
            if req is None:                # tombstoned by a replan
                edge.q_dead -= 1
                continue
            del self._qentry[req]
            if self.tracer is not None:
                self.tracer.async_end("queue", req.rid, now,
                                      self.tracer.PID_DEVICES, req.device)
            if req.admitted_s is None:
                req.admitted_s = now
            if req.assign is not None and not req.coop_counted:
                # (re-)acquire cooperative span slots; a migrated request
                # re-acquires at its new edge set here
                for eid in req.assign.eids[1:]:
                    self.topo.edge(eid).coop_inflight += 1
                req.coop_counted = True
            if self.model is not None:
                if self.arena_decode:
                    # slot-resident path: prefill (or a migrated request's
                    # shipped cache) scatters into the edge arena once here;
                    # the request stays resident until completion/extract
                    ar = self._arena(edge)
                    if not ar.has(req.rid):
                        if req.cache is None:
                            self._prefill_real(req)
                        ar.admit(req.rid, req.cache)
                        req.cache = None   # state lives in the arena now
                elif req.cache is None:
                    # migrated requests keep their shipped cache —
                    # re-prefilling would clobber the decode state the
                    # handover paid to move
                    self._prefill_real(req)
            edge.active.append(req)
        if not edge.active:
            return
        tr = self.tracer
        round_dt = 0.0
        decode_batch = []          # this round's real-decode group
        for slot, req in enumerate(edge.active):
            device = self.topo.device(req.device)
            bw = self._bw(device, edge.eid, now)
            if req.plan is None:
                req.plan = self.stepper.plan(bw)
            if req.assign is not None:
                # cooperative chain: spans at each member's speed + backbone
                # hops (k=1 degenerates to the single-edge numbers exactly)
                per_exit = self.stepper.per_exit_times_coop_cached(
                    req.plan.partition, req.assign.speeds, bw,
                    device_load=device.slowdown,
                    edge_bw_bps=self.topo.edge_bw_bps, include_input=False)
            else:
                per_exit = self.stepper.per_exit_times_cached(
                    req.plan.partition, bw, edge_load=edge.speed,
                    device_load=device.slowdown, include_input=False)
            tokens_left = req.max_new_tokens - req.tokens_done
            # input payload ships once, then prompt_len/8 prefill steps —
            # billed at the plan exit, so the first round's exit choice must
            # budget for it.  (t_up + t_pf is the identical float expression
            # the single-line form computed; the split names the uplink and
            # prefill sub-spans for the tracer.)
            if req.prefill_pending:
                t_up = self.stepper.input_time(req.plan.partition, bw)
                t_pf = per_exit[req.plan.exit_point - 1] * \
                    max(1, req.prompt_len // self.prefill_div)
                prefill = t_up + t_pf
            else:
                t_up = t_pf = prefill = 0.0
            if self.demote:
                req.exit_point = self.stepper.choose_exit(
                    req.deadline_s - now - prefill, per_exit, tokens_left,
                    req.plan.exit_point)
            else:
                req.exit_point = req.plan.exit_point
            t_step = per_exit[req.exit_point - 1] + prefill
            req.prefill_pending = False
            if tr is not None:
                # slot tracks are 1-based (tid 0 is the rounds track)
                tid = slot + 1
                if t_up > 0.0:
                    tr.complete("uplink", now, now + t_up, edge.eid, tid,
                                args={"rid": req.rid})
                if t_pf > 0.0:
                    tr.complete("prefill", now + t_up, now + prefill,
                                edge.eid, tid, args={"rid": req.rid})
                tr.complete("decode", now + prefill, now + t_step,
                            edge.eid, tid,
                            args={"rid": req.rid, "exit": req.exit_point,
                                  "token": req.tokens_done})
            if req.assign is not None and req.assign.k > 1:
                self._emit_hops(req, now, evq, metrics)
            if self.model is not None:
                # token values are produced after the slot loop: the whole
                # round decodes as one batched group (exit choices above are
                # already fixed, so collecting first changes nothing)
                decode_batch.append(req)
            round_dt = max(round_dt, t_step)
        if decode_batch:
            if self.arena_decode:
                self._decode_real_arena(edge, decode_batch)
            else:
                self._decode_real_batch(decode_batch)
        edge.busy_s += round_dt
        metrics.add_busy(edge.eid, round_dt)
        edge.ema_round_s = round_dt if edge.ema_round_s == 0.0 else \
            0.8 * edge.ema_round_s + 0.2 * round_dt
        edge.round_inflight = True
        if tr is not None:
            eid = edge.eid
            tr.complete("round", now, now + round_dt, eid, 0,
                        args={"batch": len(edge.active)})
            tr.counter("backlog_s", now, eid,
                       {"backlog_s": edge.backlog_s()})
            tr.counter("slots", now, eid,
                       {"active": len(edge.active),
                        "queued": len(edge.queue) - edge.q_dead})
            tr.counter("tokens_owed", now, eid,
                       {"tokens_owed": edge.tokens_owed})
            tr.counter("coop_inflight", now, eid,
                       {"coop_inflight": edge.coop_inflight})
        evq.push(now + round_dt, "round", edge)

    # ---------------------------------------------------------------- coop
    def _emit_hops(self, req: FleetRequest, now: float, evq: EventQueue,
                   metrics: FleetMetrics):
        """One decode round of a cooperative request hops across its edge
        set: schedule the inter-edge hand-offs as ``transfer`` events at
        their in-round completion offsets and track each secondary edge's
        span compute as cooperative busy time (the primary's full round —
        which spans the whole chain — is billed by the caller)."""
        key = (req.exit_point, req.assign, self.topo.edge_bw_bps)
        hit = self._hop_cache.get(key)
        if hit is None:
            self.stepper.hop_misses += 1
            f_edge = self.stepper.planner.f_edge
            # a demoted exit's branch can be shorter than the planned
            # partition — hop/busy accounting must follow the clamped spans
            # the latency model actually bills for this exit
            eff = effective_assignment(self.stepper.graph, req.exit_point,
                                       req.assign)
            hit = self._hop_cache[key] = (
                eff,
                hop_schedule(self.stepper.graph, req.exit_point, eff,
                             f_edge, self.topo.edge_bw_bps),
                span_seconds(self.stepper.graph, req.exit_point, eff,
                             f_edge))
        else:
            self.stepper.hop_hits += 1
        eff, hops, spans = hit
        for dt, src, dst, nbytes in hops:
            evq.push(now + dt, "transfer", (src, dst, nbytes))
        if self.tracer is not None:
            tr, bb = self.tracer, self.topo.edge_bw_bps
            for dt, src, dst, nbytes in hops:
                # the wire time of the hop, ending at its completion offset
                tr.complete("transfer", now + dt - nbytes / bb, now + dt,
                            tr.PID_NET, src,
                            args={"rid": req.rid, "src": src, "dst": dst,
                                  "bytes": nbytes})
        # secondary compute is tracked apart from busy_s: the primary's
        # round_dt already covers the full chain, so adding spans to
        # edge_busy_s would double-bill utilization
        for eid, span_s in zip(eff.eids[1:], spans[1:]):
            metrics.add_coop_busy(eid, span_s)

    # ---------------------------------------------------------------- elastic
    def _set_capacity(self, edge: EdgeNode, new: int, now: float,
                      metrics: FleetMetrics):
        """Resize one edge's provisioned slot count: bill the closed
        capacity segment into the price model and log the change."""
        old = edge.capacity
        if new == old:
            return
        metrics.on_scale(edge.eid, old, new, now)
        edge.capacity = new
        if self.tracer is not None:
            self.tracer.counter("capacity", now, edge.eid,
                                {"capacity": new})

    def _on_scale(self, evq: EventQueue, metrics: FleetMetrics):
        """One tick of the autoscaling grid: apply this slot's (edge,
        target) decisions.  Scale-up takes effect immediately (and kicks a
        round if work was waiting on slots); scale-down provisions down to
        ``max(target, running batch)`` now and drains the rest at round
        boundaries (see _on_round_done) — busy slots are never reclaimed.
        The grid self-terminates with the workload, like sample/obs."""
        now = evq.now
        for eid, target in self.autoscaler.decide(now, self.topo):
            edge = self.topo.edge(eid)
            cur = edge.capacity
            self._cap_target.pop(eid, None)   # a fresh decision supersedes
            if target == cur:
                continue
            provision = max(target, len(edge.active))
            if target < provision:
                self._cap_target[eid] = target
            self._set_capacity(edge, provision, now, metrics)
            if target < cur:
                self._replan_shrunk(edge, target, now, evq, metrics)
            elif provision > cur and not edge.round_inflight \
                    and len(edge.queue) - edge.q_dead > 0:
                self._begin_round(edge, evq, metrics)
        if self._pending > 0:
            evq.push(now + self.autoscaler.decide_dt, "scale", None)

    def _replan_shrunk(self, edge: EdgeNode, target: int, now: float,
                       evq: EventQueue, metrics: FleetMetrics):
        """A scale-down changed the edge's effective speed-per-slot: re-price
        the (partition, exit) plans of its queued, un-prefilled, single-edge
        requests through the autoscaler's
        :class:`~repro_torch.runtime.elastic.ElasticPlanner` (calibrated on the
        fleet's latency models) at each request's own bandwidth.  A plan
        that collapses to partition 0 pushes the request back to its device
        — the elastic analogue of the mobility queue-replan fallback.
        Cooperative requests keep their plans (their span assignment is
        bound to the partition) and prefilled ones hold edge state."""
        planner = getattr(self.autoscaler, "planner", None)
        if planner is None:
            return
        from repro_torch.runtime.elastic import TierSpec
        for entry in list(edge.queue):
            req = entry[2]
            if req is None or not req.prefill_pending or req.migrating \
                    or req.assign is not None:
                continue
            device = self.topo.device(req.device)
            bw = self._bw(device, edge.eid, now)
            plan = planner.plan_for(TierSpec(chips=target), TierSpec(chips=1),
                                    link_bps=bw)
            if plan.partition == 0:
                self._dequeue(edge, req)
                if self.tracer is not None:
                    self.tracer.async_end("queue", req.rid, now,
                                          self.tracer.PID_DEVICES,
                                          req.device)
                edge.tokens_owed -= req.max_new_tokens - req.tokens_done
                req.plan, req.assign, req.edge = plan, None, -1
                self._untrack(req)
                self._run_local(req, device, device.link.bw_at(now), evq)
            else:
                req.plan = plan

    def _admission_deny(self, req: FleetRequest, device, bw: float,
                        evq: EventQueue, metrics: FleetMetrics):
        """Shed one arrival at a saturated edge.  ``policy='local'``
        degrades to device-only execution (the request still completes);
        ``policy='reject'`` counts an explicit rejected outcome — the
        request leaves the system, conserving
        ``completed + rejected + in_flight == issued``."""
        now = evq.now
        if self.admission.policy == "local":
            req.plan = self.stepper.plan_multi(
                bw, (), device_load=device.slowdown)
            req.assign = None
            self._run_local(req, device, bw, evq)
            return
        self._pending -= 1
        metrics.reject()
        if self.tracer is not None:
            tr = self.tracer
            tr.instant("reject", now, tr.PID_DEVICES, req.device,
                       args={"rid": req.rid, "tenant": req.tenant})
            tr.async_end("request", req.rid, now, tr.PID_DEVICES,
                         req.device, args={"rejected": True})

    # ---------------------------------------------------------------- handover
    def _untrack(self, req: FleetRequest):
        reqs = self._dev_inflight.get(req.device)
        if reqs is not None and req in reqs:
            reqs.remove(req)

    def _release_coop(self, req: FleetRequest):
        if req.coop_counted:
            for eid in req.assign.eids[1:]:
                self.topo.edge(eid).coop_inflight -= 1
            req.coop_counted = False

    def _apply_decision(self, req: FleetRequest, dec: JointDecision, *,
                        acquire: bool):
        """Swap the request's (plan, assign) for a replan decision.  Span
        accounting moves with it: old cooperative slots are released, and the
        new ones are acquired immediately when the request stays active
        (``acquire=True``) or lazily at re-admission otherwise."""
        self._release_coop(req)
        req.plan = dec.plan
        req.assign = dec.assign if dec.assign.k > 0 else None
        if acquire and req.assign is not None:
            for eid in req.assign.eids[1:]:
                self.topo.edge(eid).coop_inflight += 1
            req.coop_counted = True

    def _on_sample_sweep(self, evq: EventQueue, metrics: FleetMetrics):
        """One tick of the fleet-wide bandwidth sampling grid: the full
        device-edge geometry for this slot is computed as two numpy
        matrices (batched path-loss — bit-identical to the scalar law per
        entry), then each device's handover policy consumes its row in
        ascending device order and, when it fires, the device's in-flight
        requests re-plan immediately — the same per-device sequencing the
        old one-event-per-device grid produced.  The grid self-terminates
        once every request completed."""
        now = evq.now
        # a pre-built controller can be passed without mobility= (the engine
        # then never bills per-pair rates but the sampling grid still runs)
        mob = self.mobility if self.mobility is not None \
            else self.handover.mobility
        dist = mob.distances_at(now)
        bw = mob.bw_matrix(now)
        servings: list = [()] * self.topo.num_devices
        did0 = self.topo.did0
        for did, reqs in self._dev_inflight.items():
            if reqs:
                servings[did - did0] = tuple(sorted(
                    {r.edge for r in reqs
                     if r.edge >= 0 and not r.migrating}))
        fired = self.handover.observe_sweep(now, servings, dist, bw)
        if self.replanner is not None:
            for did in fired:
                self._replan_device(did, evq, metrics)
        if self.timeline is not None:
            # piggyback the telemetry snapshot on the sweep this grid
            # already runs: per-edge gauges post-replan, plus the device
            # signals the sweep just computed (best-signal bandwidth and
            # the BOCD run-length MAP when the bocd policy is active)
            bank = self.handover.bank
            self.timeline.snapshot(
                now, self.topo, bw_row=bw.max(axis=1),
                run_len=bank.map_run if bank is not None else None)
        self.events_processed += self.topo.num_devices - 1
        if self._pending > 0:
            evq.push(now + self.handover.sample_dt, "sample", None)

    def _on_obs(self, evq: EventQueue):
        """Dedicated timeline snapshot tick for fleets with no sampling
        sweep to piggyback on (static topologies / policy "none").  Pure
        observation: reads edge gauges, schedules only its own successor,
        and self-terminates with the workload."""
        now = evq.now
        self.timeline.snapshot(now, self.topo)
        if self._pending > 0:
            evq.push(now + self.timeline.dt, "obs", None)

    def _replan_device(self, did: int, evq: EventQueue,
                       metrics: FleetMetrics):
        device = self.topo.device(did)
        for req in list(self._dev_inflight.get(did, ())):
            if req.migrating or req.edge < 0:
                continue                       # mid-transfer: nothing to do
            edge = self.topo.edge(req.edge)
            if req in edge.active:
                # mid-decode: defer to the round boundary so the in-flight
                # round's billing stays intact and the state cut is exact
                req.replan_pending = True
            else:
                self._replan_queued(req, device, edge, evq, metrics)

    def _move_cost(self, req: FleetRequest) -> int:
        """State bytes resident at the request's current edge span: zero
        before prefill (nothing materialized yet), otherwise the KV/recurrent
        snapshot at the planned cut for the tokens processed so far."""
        if req.prefill_pending:
            return 0
        return migration_bytes(self.stepper.graph, req.plan.exit_point,
                               req.plan.partition,
                               req.prompt_len + req.tokens_done)

    def _replan_active(self, req: FleetRequest, edge: EdgeNode, now: float,
                       evq: EventQueue, metrics: FleetMetrics,
                       still_active: list):
        nbytes = self._move_cost(req)
        dec = self.replanner.replan(
            req, self.topo.device(req.device), self.topo, now,
            allow_local=False, move_cost_s=nbytes / self.topo.edge_bw_bps)
        if dec is None or dec.local or dec.primary == edge.eid:
            if dec is not None and not dec.local:
                # same primary, fresh (partition, exit) for the new
                # bandwidth state — an in-place replan, no state moves
                self._apply_decision(req, dec, acquire=True)
            still_active.append(req)
            return
        edge.tokens_owed -= req.max_new_tokens - req.tokens_done
        self._blg_add(edge, -1)        # leaves the batch without completing
        if self.arena_decode and self.model is not None:
            # gather the slot row back out (sliced to the request's own
            # length — bitwise what the serial path would ship) so the
            # handover snapshot carries real state; the destination edge's
            # arena re-admits it on arrival
            ar = self._arenas.get(edge.eid)
            if ar is not None and ar.has(req.rid):
                req.cache = ar.extract(req.rid)
        self._ship(req, edge.eid, dec, nbytes, now, evq, metrics)

    def _replan_queued(self, req: FleetRequest, device, edge: EdgeNode,
                       evq: EventQueue, metrics: FleetMetrics):
        """Re-plan a request still waiting in an edge queue.  Un-prefilled
        requests carry no edge state, so they may also fall back to
        device-only execution (offload admission control under mobility)."""
        now = evq.now
        nbytes = self._move_cost(req)
        dec = self.replanner.replan(
            req, device, self.topo, now, allow_local=req.prefill_pending,
            move_cost_s=nbytes / self.topo.edge_bw_bps)
        if dec is None or (not dec.local and dec.primary == req.edge):
            if dec is not None:
                self._apply_decision(req, dec, acquire=False)
            return
        self._dequeue(edge, req)
        if self.tracer is not None:
            self.tracer.async_end("queue", req.rid, now,
                                  self.tracer.PID_DEVICES, req.device)
        edge.tokens_owed -= req.max_new_tokens - req.tokens_done
        if dec.local:
            self._apply_decision(req, dec, acquire=False)
            req.edge = -1
            self._untrack(req)
            self._run_local(req, device, device.link.bw_at(now), evq)
            return
        self._ship(req, edge.eid, dec, nbytes, now, evq, metrics)

    def _ship(self, req: FleetRequest, src_eid: int, dec: JointDecision,
              nbytes: int, now: float, evq: EventQueue,
              metrics: FleetMetrics):
        """Migrate a request to a new primary edge: apply the replan, bill
        the state snapshot over the backbone (one ``transfer`` event at the
        arrival timestamp), and schedule the ``handover`` event that re-binds
        the request once the state has landed."""
        self._apply_decision(req, dec, acquire=False)
        dst = dec.primary
        dt = nbytes / self.topo.edge_bw_bps
        req.migrating = True
        req.handovers += 1
        req.migrated_bytes += nbytes
        req.edge = dst
        if self.tracer is not None:
            tr = self.tracer
            args = {"rid": req.rid, "src": src_eid, "dst": dst,
                    "bytes": nbytes}
            tr.async_begin("handover", req.rid, now, tr.PID_DEVICES,
                           req.device, args=args)
            # the state snapshot on the backbone wire is a transfer span
            # like any coop hop; the handover *stage* (snapshot -> resume)
            # is the async pair above
            tr.complete("transfer", now, now + dt, tr.PID_NET, src_eid,
                        args=args)
        metrics.add_handover(src_eid, dst, nbytes, now + dt, at_s=now)
        if nbytes > 0:
            evq.push(now + dt, "transfer", (src_eid, dst, nbytes))
        evq.push(now + dt, "handover", req)

    def _on_handover(self, req: FleetRequest, evq: EventQueue,
                     metrics: FleetMetrics):
        """The state snapshot landed: resume the request at its new primary.
        The request keeps its deadline, token progress, and decode cache —
        exactly-once completion is preserved (tests/test_fleet_invariants)."""
        edge = self.topo.edge(req.edge)
        req.migrating = False
        if self.tracer is not None:
            tr = self.tracer
            tr.async_end("handover", req.rid, evq.now, tr.PID_DEVICES,
                         req.device)
            tr.async_begin("queue", req.rid, evq.now, tr.PID_DEVICES,
                           req.device, args={"edge": edge.eid})
        self._enqueue(edge, req)
        edge.tokens_owed += req.max_new_tokens - req.tokens_done
        if not edge.round_inflight:
            self._begin_round(edge, evq, metrics)

    # ---------------------------------------------------------------- real decode
    def _device(self):
        return self.params["embed"].device

    def _dtype(self):
        return self.dtype if self.dtype is not None else torch.float32

    def _argmax(self, h):
        """Greedy tokens [B] int32 of normed hidden ``h`` [B, 1, D]: the
        argmax of the model-dtype logits at the last position, the first
        index among equal maxima, as the reference's epilogue."""
        logits = self.model.logits(self.params, h)
        return torch.argmax(logits[:, -1, :], -1).to(torch.int32)

    def _prefill_real(self, req: FleetRequest):
        assert req.prompt is not None, \
            "real-decode fleet needs prompts (make_workload(vocab_size=...))"
        dev = self._device()
        toks = torch.from_numpy(np.asarray(req.prompt[None, :], np.int32)).to(dev)
        cache = self.model.init_cache(
            1, req.prompt_len + req.max_new_tokens + 1, dtype=self._dtype(),
            device=dev)
        h, cache = self.stepper.prefill_fn()(self.params, toks, cache)
        req.next_tok = self._argmax(h)[:, None]
        req.cache = cache

    def _decode_real(self, req: FleetRequest):
        fn = self.stepper.decode_fn(req.exit_point)
        pos = req.prompt_len + req.tokens_done
        h, req.cache = fn(self.params, req.cache, req.next_tok, pos)
        self.stepper.serial_tokens += 1
        req.next_tok = self._argmax(h)[:, None]
        req.tokens.append(int(req.next_tok[0, 0]))

    def _decode_real_batch(self, reqs: List[FleetRequest]):
        """One decode round's token step for every active request at an
        edge: the stepper groups congruent requests into batched calls
        (``CoInferenceStepper.decode_step_batch``), then the logits/argmax
        epilogue runs per request as the serial path's does."""
        if not self.batch_decode or len(reqs) == 1:
            for req in reqs:
                self._decode_real(req)
            return
        items = [(req.exit_point, req.cache, req.next_tok,
                  req.prompt_len + req.tokens_done) for req in reqs]
        outs = self.stepper.decode_step_batch(self.params, items,
                                              sharded=self.shard_decode)
        for req, (h, cache) in zip(reqs, outs):
            req.cache = cache
            req.next_tok = self._argmax(h)[:, None]
            req.tokens.append(int(req.next_tok[0, 0]))

    def _arena(self, edge: EdgeNode):
        """The edge's decode arena, created lazily at first admission:
        slots sized to the edge's capacity, length to the workload's
        longest cache (both grow on demand — see serving.arena)."""
        ar = self._arenas.get(edge.eid)
        if ar is None:
            from repro_torch.serving.arena import DecodeArena
            ar = DecodeArena(self.model, slots=max(1, edge.capacity),
                             length=self._arena_len_hint, dtype=self._dtype(),
                             bucket=self.arena_bucket, stepper=self.stepper,
                             device=self._device())
            self._arenas[edge.eid] = ar
        return ar

    def _decode_real_arena(self, edge: EdgeNode,
                           reqs: List[FleetRequest]):
        """One decode round's token step through the edge's slot-resident
        arena: at most one masked call per model exit
        (``CoInferenceStepper.decode_step_arena``) with no per-round cache
        restacking, then one batched logits/argmax per exit group — the
        head is row-independent, so each request's token is the one the
        per-request epilogue would pick from its row."""
        ar = self._arenas[edge.eid]
        items = [(req.exit_point, ar.slot(req.rid), req.next_tok,
                  req.prompt_len + req.tokens_done) for req in reqs]
        next_toks = {}
        for rows, h_all in self.stepper.decode_step_arena(
                self.params, ar, items):
            toks = self._argmax(h_all)
            for _, slot, _, _ in rows:
                next_toks[slot] = toks[slot:slot + 1][:, None]
        for req in reqs:
            req.next_tok = next_toks[ar.slot(req.rid)]
            req.tokens.append(int(req.next_tok[0, 0]))
