"""Joint (edge-set, partition, exit) planning (arXiv:2310.12937).

``BandwidthAwareRouter`` optimizes sequentially: Algorithm 1 fixes (exit,
partition) for a *speed-1* edge, then placement shops that fixed plan around.
``JointPlanner`` searches the product space instead: for every candidate
edge set it runs the k-cut Algorithm-1 search *conditioned on that set's
speeds and this device's slowdown* (``CoInferenceStepper.plan_multi``, cached
on quantized bandwidth x edge-speed tuple x device slowdown), prices in
queueing at the primary and contention at the secondaries, and picks the
cheapest estimated completion.  Single-edge sets are always in the candidate
pool, so the joint decision degrades gracefully to bandwidth-aware routing
when cooperation does not pay.

Candidate sets are speed-ordered prefixes around each primary (every edge as
primary, partnered with the fastest other edges up to ``max_coop``), which
bounds the search to O(M * max_coop) sets per arrival — and the per-set
plans are shared fleet-wide through the stepper's plan cache.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.partitioner import CoInferencePlan
from repro_torch.serving.engine import quantize_bw
from repro_torch.fleet.cluster import DeviceNode, EdgeNode, FleetTopology
from repro_torch.fleet.coop import CoopAssignment, assign_spans


@dataclass
class JointDecision:
    plan: CoInferencePlan
    assign: CoopAssignment        # empty (k=0) for device-only plans
    est_s: float                  # estimated completion at the plan's exit
    est_min_s: float = 0.0        # estimated completion demoted to exit 1

    @property
    def local(self) -> bool:
        return self.plan.partition == 0

    @property
    def primary(self) -> int:
        return self.assign.eids[0]


class JointPlanner:
    """Joint (edge-set, partition, exit) search per arrival — and, with a
    :class:`~repro_torch.fleet.mobility.MobilityModel` attached, per mid-request
    handover via :meth:`replan` (nearest-edge candidate ordering, per-primary
    bandwidths, and an explicit migration surcharge)."""

    def __init__(self, stepper, topo: FleetTopology, *, max_coop: int = 3,
                 prefill_div: int = 8, mobility=None, admission=None):
        self.stepper = stepper
        self.topo = topo
        self.max_coop = max(1, max_coop)
        self.prefill_div = prefill_div
        self.mobility = mobility
        # admission control (fleet.elastic.AdmissionControl, optional):
        # candidates whose *primary* is saturated are priced at +inf in
        # every decide path, so the search steers to less-loaded cells or
        # the device-only fallback before the engine's backstop rejects.
        # None (the default) skips the mask entirely — decisions are
        # bit-identical to the pre-admission planner.  replan() is left
        # unmasked: an in-flight request already holds its slot, and the
        # backlog terms it prices already penalize full cells.
        self.admission = admission
        self._sets = self._candidate_sets(topo)
        self._ordered_sets_cache = {}
        # decide() hot path: per (quantized bw, device slowdown) the plans,
        # assignments, and per-exit step times of every candidate set are
        # fixed — precompute them once as flat arrays and score arrivals
        # with elementwise numpy (see _score_tables)
        self._score_cache = {}
        # hit/miss counters for cache_stats() (repro_torch.obs self-profiling)
        self.score_hits = self.score_misses = 0
        self.ordered_hits = self.ordered_misses = 0

    # ------------------------------------------------------------ candidates
    def _candidate_sets(self, topo: FleetTopology) -> List[Tuple[EdgeNode, ...]]:
        """Every edge as primary, extended by the fastest remaining edges
        (speed ascending = fastest first, tie-break on eid), one prefix per
        cooperative width 1..max_coop.  Deduplicated, deterministic order."""
        # the empty set is always a candidate: its plan degenerates to
        # device-only, so congested edges push arrivals back onto their own
        # device (offload admission control)
        out: List[Tuple[EdgeNode, ...]] = [()]
        seen = set()
        for primary in topo.edges:
            partners = sorted((e for e in topo.edges if e.eid != primary.eid),
                              key=lambda e: (e.speed, e.eid))
            for k in range(1, min(self.max_coop, len(partners) + 1) + 1):
                cand = (primary,) + tuple(partners[:k - 1])
                key = tuple(e.eid for e in cand)
                if key not in seen:
                    seen.add(key)
                    out.append(cand)
        return out

    def _ordered_sets(self, order: Tuple[int, ...]
                      ) -> List[Tuple[EdgeNode, ...]]:
        """Candidate sets built from an explicit *preference order* over edge
        ids (mobility: nearest-first): each prefix position is a primary,
        partnered with the next edges in order up to ``max_coop``.  Cached
        per order tuple — the order changes slowly (device motion), not per
        arrival."""
        hit = self._ordered_sets_cache.get(order)
        if hit is not None:
            self.ordered_hits += 1
            return hit
        self.ordered_misses += 1
        edges = {e.eid: e for e in self.topo.edges}
        out: List[Tuple[EdgeNode, ...]] = [()]
        seen = set()
        for primary in order:
            if self.max_coop == 1:
                # singleton candidates only: skip the O(M) partner scan per
                # primary (the default replan fan-out at fleet scale)
                out.append((edges[primary],))
                continue
            partners = [e for e in order if e != primary]
            for k in range(1, min(self.max_coop, len(partners) + 1) + 1):
                key = (primary,) + tuple(partners[:k - 1])
                if key not in seen:
                    seen.add(key)
                    out.append(tuple(edges[e] for e in key))
        self._ordered_sets_cache[order] = out
        return out

    def cache_stats(self) -> dict:
        """Hit/miss/size per memo (score tables, ordered candidate sets) —
        surfaced by ``repro_torch.obs.SimProfiler.report`` under
        ``replanner_caches`` when the engine's replanner is a JointPlanner."""
        def block(hits: int, misses: int, entries: int) -> dict:
            total = hits + misses
            return {"hits": hits, "misses": misses, "entries": entries,
                    "hit_rate": round(hits / total, 6) if total else None}
        return {
            "score": block(self.score_hits, self.score_misses,
                           len(self._score_cache)),
            "ordered_sets": block(self.ordered_hits, self.ordered_misses,
                                  len(self._ordered_sets_cache)),
        }

    # ------------------------------------------------------------ decision
    def _score_tables(self, bw: float, device: DeviceNode,
                      topo: FleetTopology) -> dict:
        """Per-(quantized bandwidth, device slowdown) candidate tensors:
        plan, assignment, and per-exit step times of every kept candidate
        set, flattened into arrays so :meth:`decide` scores one arrival with
        a handful of elementwise numpy ops.  Built once per key by replaying
        the scalar candidate loop (which also warms the shared plan cache
        exactly as the scalar path would)."""
        key = (quantize_bw(bw), device.slowdown)
        hit = self._score_cache.get(key)
        if hit is not None:
            self.score_hits += 1
            return hit
        self.score_misses += 1
        plans, assigns, accs, t_exit, t_min = [], [], [], [], []
        is_local, primaries, sec = [], [], []
        for cand in self._sets:
            speeds = tuple(e.speed for e in cand)
            plan = self.stepper.plan_multi(
                bw, speeds, device_load=device.slowdown,
                edge_bw_bps=topo.edge_bw_bps)
            if (plan.partition == 0) != (len(cand) == 0):
                continue               # collapsed duplicate of device-only
            if plan.partition == 0:
                assign = CoopAssignment((), (), ())
                per_exit = self.stepper.per_exit_times_cached(
                    0, bw, device_load=device.slowdown)
                is_local.append(True)
                primaries.append(0)
                sec.append([])
            else:
                assign = assign_spans(plan.partition, cand)
                per_exit = self.stepper.per_exit_times_coop_cached(
                    plan.partition, assign.speeds, bw,
                    device_load=device.slowdown,
                    edge_bw_bps=topo.edge_bw_bps, include_input=False)
                is_local.append(False)
                # SoA row indices (eid - eid0): global only when the
                # planner serves the whole fleet, tile-local under sharding
                primaries.append(assign.eids[0] - topo.eid0)
                sec.append([(eid - topo.eid0, frac) for eid, frac in
                            zip(assign.eids[1:],
                                assign.span_fractions()[1:])])
            plans.append(plan)
            assigns.append(assign)
            accs.append(plan.accuracy)
            t_exit.append(per_exit[plan.exit_point - 1])
            t_min.append(per_exit[0])
        c = len(plans)
        s_max = max((len(s) for s in sec), default=0)
        sec_idx = np.zeros((c, s_max), dtype=int)
        sec_frac = np.zeros((c, s_max))
        for i, pairs in enumerate(sec):
            for j, (eid, frac) in enumerate(pairs):
                sec_idx[i, j], sec_frac[i, j] = eid, frac
        order = sorted(range(c), key=lambda i: assigns[i].eids)
        rank = np.empty(c, dtype=int)
        rank[order] = np.arange(c)
        hit = {
            "plans": plans, "assigns": assigns,
            "acc": np.array(accs), "t_exit": np.array(t_exit),
            "t_min": np.array(t_min), "local": np.array(is_local),
            "primary": np.array(primaries, dtype=int),
            "sec_idx": sec_idx, "sec_frac": sec_frac, "rank": rank,
        }
        self._score_cache[key] = hit
        return hit

    def decide(self, req, device: DeviceNode, topo: FleetTopology,
               now: float) -> JointDecision:
        """Algorithm-1 semantics lifted to the fleet: among candidates whose
        *estimated completion* (plan latency + current queueing) meets the
        request's deadline, take the most accurate exit (tie-break cheaper
        estimate, then lower edge ids); if none fits, minimize the estimate
        — the fleet analogue of ``optimize_with_fallback``.

        Scoring is vectorized over the candidate tensors of
        :meth:`_score_tables`; every arithmetic step applies the same float
        ops in the same order as :meth:`decide_scalar`, so the two paths
        pick bit-identical decisions (property-pinned by
        tests/test_fleet_perf.py).

        With a mobility model attached, candidates are instead priced at
        the bandwidth the device would see *to each candidate's primary*
        (as :meth:`replan` always has) — the device's own link reports the
        best-signal edge, and pricing a far primary's uplink at that rate
        systematically over-admits far edges (docs/fleet.md)."""
        if self.mobility is not None:
            return self._decide_mobile(req, device, topo, now)
        bw = device.link.bw_at(now)
        tab = self._score_tables(bw, device, topo)
        blg = topo.backlog_s_row()     # vectorized EdgeNode.backlog_s row
        input_t = self.stepper.graph.input_bytes / bw
        base = np.where(tab["local"], device.local_backlog_s(now),
                        blg[tab["primary"]] + input_t)
        # secondary backlog surcharges, span order (padded columns add 0.0)
        for j in range(tab["sec_idx"].shape[1]):
            base = base + blg[tab["sec_idx"][:, j]] * tab["sec_frac"][:, j]
        prefill_steps = max(1, req.prompt_len // self.prefill_div)
        est = base + tab["t_exit"] * prefill_steps + \
            tab["t_exit"] * req.max_new_tokens
        est_min = base + tab["t_exit"] * prefill_steps + \
            tab["t_min"] * req.max_new_tokens
        if self.admission is not None:
            # saturated primaries are unroutable: +inf drops them from the
            # feasible set and the fallback argmin alike (the device-only
            # candidate always keeps a finite estimate)
            sat = self.admission.saturated_row(topo)
            mask = ~tab["local"] & sat[tab["primary"]]
            est = np.where(mask, np.inf, est)
            est_min = np.where(mask, np.inf, est_min)
        feasible = np.flatnonzero(est <= req.deadline_s - now)
        if len(feasible):
            # max accuracy, then min estimate, then lowest eids (rank):
            # float equality grouping mirrors the tuple-key min()
            acc = tab["acc"][feasible]
            sub = feasible[acc == acc.max()]
            sub = sub[est[sub] == est[sub].min()]
            i = int(sub[tab["rank"][sub].argmin()])
        else:
            sub = np.flatnonzero(est_min == est_min.min())
            i = int(sub[tab["rank"][sub].argmin()])
        return JointDecision(plan=tab["plans"][i], assign=tab["assigns"][i],
                             est_s=float(est[i]),
                             est_min_s=float(est_min[i]))

    def _decide_mobile(self, req, device: DeviceNode, topo: FleetTopology,
                       now: float) -> JointDecision:
        """Per-primary pricing for :meth:`decide` under mobility: one
        geometry row per arrival, each candidate set priced at the
        bandwidth to *its own* primary (the device-only candidate at the
        nearest edge's rate, which is what ``device.link.bw_at`` reports).
        Selection semantics are identical to the static path."""
        did = device.did
        drow = self.mobility.distance_row(did, now)
        brow = self.mobility.bw_row(did, now)
        nearest_i = int(np.argmin(drow))
        blg = topo.backlog_s_row()
        prefill_steps = max(1, req.prompt_len // self.prefill_div)
        cands: List[JointDecision] = []
        for cand in self._sets:
            i0 = (cand[0].eid - topo.eid0) if cand else nearest_i
            bw = float(brow[i0])
            speeds = tuple(e.speed for e in cand)
            plan = self.stepper.plan_multi(
                bw, speeds, device_load=device.slowdown,
                edge_bw_bps=topo.edge_bw_bps)
            if (plan.partition == 0) != (len(cand) == 0):
                continue               # collapsed duplicate of device-only
            if plan.partition == 0:
                assign = CoopAssignment((), (), ())
                per_exit = self.stepper.per_exit_times_cached(
                    0, bw, device_load=device.slowdown)
                base = device.local_backlog_s(now)
            else:
                assign = assign_spans(plan.partition, cand)
                per_exit = self.stepper.per_exit_times_coop_cached(
                    plan.partition, assign.speeds, bw,
                    device_load=device.slowdown,
                    edge_bw_bps=topo.edge_bw_bps, include_input=False)
                base = float(blg[assign.eids[0] - topo.eid0]) + \
                    self.stepper.input_time(plan.partition, bw)
                for frac, eid in zip(assign.span_fractions()[1:],
                                     assign.eids[1:]):
                    base += float(blg[eid - topo.eid0]) * frac
            prefill = per_exit[plan.exit_point - 1] * prefill_steps
            est = base + prefill + \
                per_exit[plan.exit_point - 1] * req.max_new_tokens
            est_min = base + prefill + per_exit[0] * req.max_new_tokens
            if self.admission is not None and plan.partition != 0 \
                    and self.admission.saturated(topo.edge(assign.eids[0])):
                est = est_min = float("inf")
            cands.append(JointDecision(plan=plan, assign=assign,
                                       est_s=est, est_min_s=est_min))
        slack = req.deadline_s - now
        feasible = [d for d in cands if d.est_s <= slack]
        if feasible:
            return min(feasible, key=lambda d: (-d.plan.accuracy, d.est_s,
                                                d.assign.eids))
        return min(cands, key=lambda d: (d.est_min_s, d.assign.eids))

    def decide_scalar(self, req, device: DeviceNode, topo: FleetTopology,
                      now: float) -> JointDecision:
        """Reference implementation of :meth:`decide` (one Python loop over
        candidate sets) — kept as the oracle the vectorized path is tested
        against.  Prices per-primary when a mobility model is attached,
        matching :meth:`_decide_mobile` (scalar geometry calls instead of
        rows)."""
        link_bw = device.link.bw_at(now)
        cands: List[JointDecision] = []
        for cand in self._sets:
            if self.mobility is not None and cand:
                bw = self.mobility.bw(device.did, cand[0].eid, now)
            else:
                bw = link_bw
            speeds = tuple(e.speed for e in cand)
            plan = self.stepper.plan_multi(
                bw, speeds, device_load=device.slowdown,
                edge_bw_bps=topo.edge_bw_bps)
            # the engine bills prompt_len/prefill_div prefill steps at the
            # plan exit on admission — estimate the same way or marginal
            # requests look feasible when they are not
            prefill_steps = max(1, req.prompt_len // self.prefill_div)
            if plan.partition == 0:
                assign = CoopAssignment((), (), ())
                per_exit = self.stepper.per_exit_times_cached(
                    0, bw, device_load=device.slowdown)
                # the device runs local requests serially — queue behind its
                # in-flight work exactly as edge candidates queue behind
                # theirs
                base = device.local_backlog_s(now)
            else:
                assign = assign_spans(plan.partition, cand)
                per_exit = self.stepper.per_exit_times_coop_cached(
                    plan.partition, assign.speeds, bw,
                    device_load=device.slowdown,
                    edge_bw_bps=topo.edge_bw_bps, include_input=False)
                primary = topo.edge(assign.eids[0])
                base = primary.backlog_s() + \
                    self.stepper.input_time(plan.partition, bw)
                # secondaries are contended resources too: bill their current
                # backlog against this plan in proportion to the span of work
                # we would place there
                for frac, eid in zip(assign.span_fractions()[1:],
                                     assign.eids[1:]):
                    base += topo.edge(eid).backlog_s() * frac
            prefill = per_exit[plan.exit_point - 1] * prefill_steps
            est = base + prefill + \
                per_exit[plan.exit_point - 1] * req.max_new_tokens
            est_min = base + prefill + per_exit[0] * req.max_new_tokens
            if self.admission is not None and plan.partition != 0 \
                    and self.admission.saturated(topo.edge(assign.eids[0])):
                # the vectorized path's saturation mask, scalar form
                est = est_min = float("inf")
            if (plan.partition == 0) == (len(cand) == 0):
                # keep one canonical device-only candidate (the empty set);
                # a non-empty set whose plan collapsed to partition 0 is a
                # duplicate of it
                cands.append(JointDecision(plan=plan, assign=assign,
                                           est_s=est, est_min_s=est_min))
        slack = req.deadline_s - now
        feasible = [d for d in cands if d.est_s <= slack]
        if feasible:
            return min(feasible, key=lambda d: (-d.plan.accuracy, d.est_s,
                                                d.assign.eids))
        # nothing fits at its plan exit: the engine will demote per round, so
        # judge candidates by what they can achieve at the earliest exit
        return min(cands, key=lambda d: (d.est_min_s, d.assign.eids))

    # ------------------------------------------------------------ replan
    def replan(self, req, device: DeviceNode, topo: FleetTopology,
               now: float, *, allow_local: bool = False,
               move_cost_s: float = 0.0) -> Optional[JointDecision]:
        """Mid-request replan hook (mobility handover, docs/handover.md).

        Re-searches (edge set, partition, exit) for a request that is
        *already in flight*: only the remaining decode tokens count, the
        input payload and prefill are sunk costs unless the request has not
        prefilled yet, and moving to a primary other than ``req.edge`` pays
        ``move_cost_s`` (the state-transfer time over the backbone) — which
        makes staying put the default when no candidate genuinely wins.

        Candidates are ordered **nearest-first** when a mobility model is
        attached (each of the nearest edges as primary, partnered with the
        next-nearest up to ``max_coop``) and each candidate is priced at the
        bandwidth the device would actually see *to that primary*.
        ``allow_local=True`` additionally admits the device-only fallback
        (only safe before prefill — afterwards the edge holds state the
        device cannot absorb).  Returns ``None`` when every candidate
        collapses to an unusable plan: the caller keeps the request where
        it is."""
        did = device.did
        eid0 = topo.eid0
        drow = brow = None
        if self.mobility is not None:
            # one vectorized geometry row per replan instead of M scalar
            # path-loss evaluations per candidate (entries are bit-identical
            # to mobility.distance/bw)
            drow = self.mobility.distance_row(did, now)
            brow = self.mobility.bw_row(did, now)
            order = tuple(sorted(range(eid0, eid0 + topo.num_edges),
                                 key=lambda e: (drow[e - eid0], e)))
        else:
            order = tuple(e.eid for e in sorted(
                topo.edges, key=lambda e: (e.speed, e.eid)))
        blg = topo.backlog_s_row()     # vectorized EdgeNode.backlog_s row
        tokens_left = req.max_new_tokens - req.tokens_done
        prefill_steps = max(1, req.prompt_len // self.prefill_div)
        cands: List[JointDecision] = []
        for cand in self._ordered_sets(order):
            if not cand and not allow_local:
                continue
            if self.mobility is not None:
                primary_eid = cand[0].eid if cand \
                    else eid0 + int(np.argmin(drow))
                bw = float(brow[primary_eid - eid0])
            else:
                bw = device.link.bw_at(now)
            speeds = tuple(e.speed for e in cand)
            plan = self.stepper.plan_multi(
                bw, speeds, device_load=device.slowdown,
                edge_bw_bps=topo.edge_bw_bps)
            if (plan.partition == 0) != (len(cand) == 0):
                # collapsed duplicates of the device-only candidate (or an
                # empty set that somehow kept a partition) are skipped
                continue
            if plan.partition == 0:
                assign = CoopAssignment((), (), ())
                per_exit = self.stepper.per_exit_times_cached(
                    0, bw, device_load=device.slowdown)
                base = device.local_backlog_s(now)
                prefill = per_exit[plan.exit_point - 1] * prefill_steps
            else:
                assign = assign_spans(plan.partition, cand)
                per_exit = self.stepper.per_exit_times_coop_cached(
                    plan.partition, assign.speeds, bw,
                    device_load=device.slowdown,
                    edge_bw_bps=topo.edge_bw_bps, include_input=False)
                primary = topo.edge(assign.eids[0])
                base = float(blg[assign.eids[0] - eid0])
                for frac, eid in zip(assign.span_fractions()[1:],
                                     assign.eids[1:]):
                    base += float(blg[eid - eid0]) * frac
                if req.edge >= 0 and assign.eids[0] == req.edge:
                    # the request's own owed tokens sit in this backlog;
                    # pricing them against itself would bias every replan
                    # toward a spurious migration to an idle edge
                    per_round = primary.ema_round_s \
                        if primary.ema_round_s > 0 else 1e-3
                    base = max(0.0, base - per_round * tokens_left /
                               max(primary.capacity, 1))
                elif req.edge >= 0:
                    base += move_cost_s
                prefill = 0.0
                if req.prefill_pending:
                    prefill = self.stepper.input_time(plan.partition, bw) + \
                        per_exit[plan.exit_point - 1] * prefill_steps
            est = base + prefill + \
                per_exit[plan.exit_point - 1] * tokens_left
            est_min = base + prefill + per_exit[0] * tokens_left
            cands.append(JointDecision(plan=plan, assign=assign,
                                       est_s=est, est_min_s=est_min))
        if not cands:
            return None
        slack = req.deadline_s - now
        feasible = [d for d in cands if d.est_s <= slack]
        if feasible:
            return min(feasible, key=lambda d: (-d.plan.accuracy, d.est_s,
                                                d.assign.eids))
        return min(cands, key=lambda d: (d.est_min_s, d.assign.eids))
