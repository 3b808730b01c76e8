"""Algorithm 1 — Runtime Optimizer for the static environment.

Joint exhaustive search over (exit point i, partition point p): maximize
accuracy subject to the latency requirement, preferring larger exits (the
paper iterates i = M..1 and returns the first branch whose best partition
meets the deadline).

Partition convention (paper Sec. IV-B, re-indexed 0-based; DESIGN.md §3):
``p`` = number of leading layers of branch ``i`` that run on the EDGE tier.
The input lives on the device, so a non-trivial cut pays ``Input/B`` uplink,
edge computes layers [0, p), ships the intermediate ``D_{p}`` downlink, and
the device computes [p, N).  ``p = 0`` -> device-only (no transfers);
``p = N`` -> edge-only (uplink + result return).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.graph import InferenceGraph


@dataclass
class CoInferencePlan:
    exit_point: int        # 1-based (paper numbering; num_exits = full model)
    partition: int         # layers on the edge tier (total, across all cuts)
    latency_s: float       # predicted end-to-end latency
    accuracy: float
    feasible: bool = True
    # k-cut generalization (CoEdge-style multi-edge spans): ascending cut
    # points over the edge portion, last == partition.  Empty == legacy
    # single-cut plan (one edge owns [0, partition)).
    cuts: tuple = ()

    @property
    def all_cuts(self) -> tuple:
        return self.cuts if self.cuts else ((self.partition,)
                                            if self.partition > 0 else ())


_CUTS_MEMO: dict = {}   # (p, speeds) -> (cuts, keep); see proportional_cuts


def branch_latency(graph: InferenceGraph, exit_idx: int, p: int,
                   f_edge, f_device, bandwidth_bps: float,
                   edge_load: float = 1.0, device_load: float = 1.0) -> float:
    """A_{i,p} of Algorithm 1 (seconds).  ``bandwidth_bps`` in bytes/s.

    ``edge_load`` / ``device_load`` scale the respective tier's compute time;
    the fleet simulator uses them for heterogeneous edges and per-device
    slowdowns."""
    branch = graph.branches[exit_idx - 1]
    n = len(branch)
    t = 0.0
    if p > 0:
        t += graph.input_bytes / bandwidth_bps            # Input/B uplink
        t += graph.cut_bytes(exit_idx, p) / bandwidth_bps  # D_{p-1}/B downlink
    for j, layer in enumerate(branch):
        if j < p:
            t += f_edge.predict(layer) * edge_load
        else:
            t += f_device.predict(layer) * device_load
    return t


def proportional_cuts(p: int, speeds: Sequence[float]) -> Tuple[tuple, tuple]:
    """Split the edge portion ``[0, p)`` into contiguous spans sized
    proportionally to each edge's throughput (``1/speed`` — ``speed`` > 1
    means slower hardware, so faster edges own more layers; CoEdge's
    workload-proportional allocation at layer granularity).

    Returns ``(cuts, keep)``: ascending cut points (span ``i`` is
    ``[cuts[i-1], cuts[i])``, ``cuts[-1] == p``) and the indices into
    ``speeds`` that received a non-empty span.  Cumulative rounding keeps the
    allocation deterministic and the spans contiguous; edges whose share
    rounds to zero layers are dropped and the split re-runs over the
    survivors until stable, so the function is *idempotent on the kept set*
    — re-splitting ``p`` over ``speeds[keep]`` returns the same cuts.  Plan
    search, span assignment, and round timing all rely on that to agree on
    one span layout.  ``k == 1`` always returns ``((p,), (0,))``.

    Pure function of ``(p, speeds)``, memoized: the fleet's plan search and
    per-round span assignment ask for the same handful of splits millions
    of times at scale."""
    if p <= 0:
        return (), ()
    memo_key = (p, tuple(speeds))
    hit = _CUTS_MEMO.get(memo_key)
    if hit is not None:
        return hit

    def split(spds):
        weights = [1.0 / max(s, 1e-12) for s in spds]
        total = sum(weights)
        cuts: List[int] = []
        keep: List[int] = []
        prev, cum = 0, 0.0
        for i, w in enumerate(weights):
            cum += w
            c = p if i == len(weights) - 1 else int(round(p * cum / total))
            if c > prev:
                cuts.append(c)
                keep.append(i)
                prev = c
        return tuple(cuts), tuple(keep)

    idx = tuple(range(len(speeds)))
    spds = tuple(speeds)
    while True:
        cuts, keep = split(spds)
        if len(keep) == len(spds):
            out = cuts, tuple(idx[i] for i in keep)
            _CUTS_MEMO[memo_key] = out
            return out
        idx = tuple(idx[i] for i in keep)
        spds = tuple(spds[i] for i in keep)


def branch_preds(graph: InferenceGraph, f_edge, f_device):
    """Per-branch per-layer predictor outputs ``(edge, device)`` — the
    ``preds`` argument of :func:`multi_branch_latency`/:func:`optimize_multi`.
    ``predict`` is a pure function of the layer, so replaying these floats
    through the same accumulation order is bit-exact; callers that own a
    stable (graph, models) triple memoize this to skip per-call predictor
    dispatch on the fleet hot path."""
    return ([[f_edge.predict(l) for l in b] for b in graph.branches],
            [[f_device.predict(l) for l in b] for b in graph.branches])


def multi_branch_latency(graph: InferenceGraph, exit_idx: int,
                         cuts: Sequence[int], edge_loads: Sequence[float],
                         f_edge, f_device, bandwidth_bps: float,
                         device_load: float = 1.0,
                         edge_bw_bps: Optional[float] = None,
                         preds=None) -> float:
    """k-cut generalization of :func:`branch_latency`.

    ``cuts`` are ascending; span ``i`` = layers ``[cuts[i-1], cuts[i])`` runs
    on an edge with compute multiplier ``edge_loads[i]``; the device runs
    ``[cuts[-1], N)``.  Consecutive spans hand the activation over an
    edge<->edge backbone link (``edge_bw_bps``); the device<->edge uplink and
    final downlink are billed at ``bandwidth_bps`` exactly as in the 1-cut
    case.  With a single cut this accumulates the identical float terms in
    the identical order as :func:`branch_latency` — bit-exact reduction
    (asserted by tests/test_coop.py)."""
    branch = graph.branches[exit_idx - 1]
    n = len(branch)
    if preds is None:
        pe = [f_edge.predict(l) for l in branch]
        pd = [f_device.predict(l) for l in branch]
    else:
        pe, pd = preds[0][exit_idx - 1], preds[1][exit_idx - 1]
    p = cuts[-1] if cuts else 0
    t = 0.0
    if p > 0:
        t += graph.input_bytes / bandwidth_bps             # Input/B uplink
        t += graph.cut_bytes(exit_idx, p) / bandwidth_bps  # D_p/B downlink
    start = 0
    for i, (cut, load) in enumerate(zip(cuts, edge_loads)):
        for j in range(start, min(cut, n)):
            t += pe[j] * load
        if i < len(cuts) - 1:                              # edge -> edge hop
            assert edge_bw_bps is not None, \
                "multi-edge plans need an edge<->edge backbone bandwidth"
            t += graph.cut_bytes(exit_idx, cut) / edge_bw_bps
        start = cut
    for j in range(p, n):
        t += pd[j] * device_load
    return t


def optimize_multi(graph: InferenceGraph, f_edge, f_device,
                   bandwidth_bps: float, latency_req_s: float,
                   edge_speeds: Sequence[float], *,
                   device_load: float = 1.0,
                   edge_bw_bps: Optional[float] = None,
                   preds=None) -> CoInferencePlan:
    """Algorithm 1 over the k-cut space for one *fixed ordered* edge set:
    search (exit i, total edge layers p) with spans sized proportionally to
    ``edge_speeds``; prefer the largest exit meeting the deadline, else the
    global minimum-latency plan flagged infeasible (fallback semantics of
    :func:`optimize_with_fallback`).  ``preds`` optionally carries
    :func:`branch_preds` output to skip per-call predictor dispatch."""
    speeds = tuple(edge_speeds)

    def scan(exit_idx: int) -> Tuple[int, tuple, float]:
        nn = len(graph.branches[exit_idx - 1])
        best = (0, (), float("inf"))
        for p in range(nn + 1):
            cuts, kept = proportional_cuts(p, speeds)
            loads = [speeds[i] for i in kept]
            lat = multi_branch_latency(graph, exit_idx, cuts, loads, f_edge,
                                       f_device, bandwidth_bps,
                                       device_load=device_load,
                                       edge_bw_bps=edge_bw_bps, preds=preds)
            if lat < best[2]:
                best = (p, cuts, lat)
        return best

    fallback = None
    for i in range(graph.num_exits, 0, -1):        # largest exit first
        p, cuts, lat = scan(i)
        plan = CoInferencePlan(exit_point=i, partition=p, latency_s=lat,
                               accuracy=graph.accuracy[i - 1], cuts=cuts)
        if lat <= latency_req_s:
            return plan
        if fallback is None or lat < fallback.latency_s:
            plan.feasible = False
            fallback = plan
    return fallback


def best_partition(graph: InferenceGraph, exit_idx: int, f_edge, f_device,
                   bandwidth_bps: float) -> Tuple[int, float]:
    """Exhaustive scan over p = 0..N for one branch; returns (p*, latency)."""
    n = len(graph.branches[exit_idx - 1])
    best = (0, float("inf"))
    for p in range(n + 1):
        lat = branch_latency(graph, exit_idx, p, f_edge, f_device, bandwidth_bps)
        if lat < best[1]:
            best = (p, lat)
    return best


def optimize(graph: InferenceGraph, f_edge, f_device, bandwidth_bps: float,
             latency_req_s: float) -> Optional[CoInferencePlan]:
    """Algorithm 1.  Returns None when no (i, p) meets the deadline
    (the paper's NULL)."""
    for i in range(graph.num_exits, 0, -1):       # largest exit first
        p, lat = best_partition(graph, i, f_edge, f_device, bandwidth_bps)
        if lat <= latency_req_s:
            return CoInferencePlan(exit_point=i, partition=p, latency_s=lat,
                                   accuracy=graph.accuracy[i - 1])
    return None


def optimize_with_fallback(graph, f_edge, f_device, bandwidth_bps,
                           latency_req_s) -> CoInferencePlan:
    """Like :func:`optimize` but when infeasible returns the minimum-latency
    plan flagged infeasible — used by the serving engine as a straggler
    rescue (DESIGN.md §2)."""
    plan = optimize(graph, f_edge, f_device, bandwidth_bps, latency_req_s)
    if plan is not None:
        return plan
    best = None
    for i in range(1, graph.num_exits + 1):
        p, lat = best_partition(graph, i, f_edge, f_device, bandwidth_bps)
        if best is None or lat < best.latency_s:
            best = CoInferencePlan(i, p, lat, graph.accuracy[i - 1], feasible=False)
    return best


def search_latency(graph, f_edge, f_device, bandwidth_bps, latency_req_s,
                   repeats: int = 10) -> float:
    """Wall-clock of one Algorithm-1 search (paper claims < 1 ms)."""
    t0 = time.perf_counter()
    for _ in range(repeats):
        optimize(graph, f_edge, f_device, bandwidth_bps, latency_req_s)
    return (time.perf_counter() - t0) / repeats
