"""Cooperative multi-edge execution plans (CoEdge, arXiv:2012.03257).

A cooperative plan runs one request's edge portion across an *ordered set*
of edges: edge ``i`` owns the contiguous layer span ``[cuts[i-1], cuts[i])``
of the chosen branch, sized proportionally to its throughput (``1/speed``),
and hands the boundary activation to the next edge over the topology's
edge<->edge backbone link (``FleetTopology.edge_bw_bps``).  The device still
pays the wireless uplink once and receives the final cut activation per
token, exactly as in the single-edge case — a cooperative plan with one edge
*is* the single-edge plan (bit-exact; tests/test_coop.py).

The span math lives in ``repro_torch.core.partitioner`` (``proportional_cuts``,
``multi_branch_latency``); this module binds it to concrete ``EdgeNode``s.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from repro_torch.core.graph import InferenceGraph
from repro_torch.core.partitioner import proportional_cuts
from repro_torch.fleet.cluster import EdgeNode


@dataclass(frozen=True)
class CoopAssignment:
    """Ordered edge spans for one request: ``eids[i]`` runs layers
    ``[cuts[i-1], cuts[i])`` at speed ``speeds[i]``.  ``eids[0]`` is the
    *primary* edge — it owns the request's queue slot and decode rounds;
    the others contribute span compute and appear via transfer events."""
    eids: Tuple[int, ...]
    speeds: Tuple[float, ...]
    cuts: Tuple[int, ...]

    @property
    def k(self) -> int:
        return len(self.eids)

    @property
    def partition(self) -> int:
        return self.cuts[-1] if self.cuts else 0

    def spans(self) -> List[Tuple[int, int, int]]:
        """[(eid, start, end)] over the edge portion."""
        out, start = [], 0
        for eid, cut in zip(self.eids, self.cuts):
            out.append((eid, start, cut))
            start = cut
        return out

    def span_fractions(self) -> Tuple[float, ...]:
        hit = _FRAC_MEMO.get(self)
        if hit is not None:
            return hit
        p = self.partition
        if p <= 0:
            fr = (0.0,) * self.k
        else:
            out, start = [], 0
            for cut in self.cuts:
                out.append((cut - start) / p)
                start = cut
            fr = tuple(out)
        _FRAC_MEMO[self] = fr
        return fr


# pure-value memos for the per-arrival/per-round hot paths: assignments and
# their span fractions are small immutable values asked for millions of
# times at fleet scale
_FRAC_MEMO: dict = {}
_ASSIGN_MEMO: dict = {}


def assign_spans(partition: int, edges: Sequence[EdgeNode]) -> CoopAssignment:
    """Size contiguous spans over ``[0, partition)`` proportionally to each
    edge's throughput; edges whose share rounds to zero layers are dropped
    (so the realized set can be smaller than the candidate set).  Pure in
    ``(partition, [(eid, speed)])`` — memoized."""
    key = (partition, tuple((e.eid, e.speed) for e in edges))
    hit = _ASSIGN_MEMO.get(key)
    if hit is not None:
        return hit
    speeds = tuple(e.speed for e in edges)
    cuts, keep = proportional_cuts(partition, speeds)
    out = CoopAssignment(eids=tuple(edges[i].eid for i in keep),
                         speeds=tuple(speeds[i] for i in keep),
                         cuts=cuts)
    _ASSIGN_MEMO[key] = out
    return out


def effective_assignment(graph: InferenceGraph, exit_point: int,
                         assign: CoopAssignment) -> CoopAssignment:
    """Re-derive the assignment for a (possibly demoted) exit: the branch
    may be shorter than the planned partition, so clamp and re-split —
    exactly the cuts :meth:`CoInferenceStepper.per_exit_times_coop_cached`
    bills for that exit, keeping hop/busy accounting consistent with the
    latency model.  Returns ``assign`` unchanged when nothing clamps."""
    n = len(graph.branches[exit_point - 1])
    p = min(assign.partition, n)
    if p == assign.partition:
        return assign
    cuts, keep = proportional_cuts(p, assign.speeds)
    return CoopAssignment(eids=tuple(assign.eids[i] for i in keep),
                          speeds=tuple(assign.speeds[i] for i in keep),
                          cuts=cuts)


def span_seconds(graph: InferenceGraph, exit_point: int,
                 assign: CoopAssignment, f_edge) -> List[float]:
    """Per-span compute seconds (speed-scaled) of one decode round — what
    each participating edge is busy for while the chain passes through it."""
    branch = graph.branches[exit_point - 1]
    n = len(branch)
    out, start = [], 0
    for speed, cut in zip(assign.speeds, assign.cuts):
        out.append(sum(f_edge.predict(branch[j]) * speed
                       for j in range(start, min(cut, n))))
        start = cut
    return out


def hop_schedule(graph: InferenceGraph, exit_point: int,
                 assign: CoopAssignment, f_edge,
                 edge_bw_bps: float) -> List[Tuple[float, int, int, int]]:
    """Relative timeline of the inter-edge hand-offs within one decode round:
    ``[(dt_s, from_eid, to_eid, nbytes)]`` where ``dt_s`` is the offset from
    round start at which the hop *completes* (span compute so far + transfer
    times so far).  Used by the fleet engine to emit ``transfer`` events on
    the virtual clock."""
    branch = graph.branches[exit_point - 1]
    n = len(branch)
    out: List[Tuple[float, int, int, int]] = []
    t, start = 0.0, 0
    for i, (eid, cut) in enumerate(zip(assign.eids, assign.cuts)):
        for j in range(start, min(cut, n)):
            t += f_edge.predict(branch[j]) * assign.speeds[i]
        if i < assign.k - 1:
            nbytes = graph.cut_bytes(exit_point, cut)
            t += nbytes / edge_bw_bps
            out.append((t, eid, assign.eids[i + 1], nbytes))
        start = cut
    return out
