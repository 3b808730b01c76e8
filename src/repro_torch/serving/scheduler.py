"""SLO-aware admission + batching.

Requests carry an end-to-end deadline.  The scheduler forms decode batches,
tracks each batch's remaining budget, and exposes the *deadline demotion*
hook: when the predicted time to finish at the current exit point exceeds the
remaining budget, the batch is demoted to an earlier exit (Edgent's
right-sizing used as straggler mitigation — DESIGN.md §2)."""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass(order=True)
class _Queued:
    deadline: float
    idx: int = field(compare=False)
    arrival_s: float = field(compare=False, default=0.0)


class SLOScheduler:
    """Earliest-deadline-first admission into fixed-size batches."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.heap: List[_Queued] = []

    def submit(self, idx: int, deadline: float, arrival_s: float = 0.0):
        heapq.heappush(self.heap, _Queued(deadline, idx, arrival_s))

    def next_batch(self, now: Optional[float] = None) -> List[int]:
        """EDF batch.  With ``now`` given, only requests that have already
        arrived are admitted — a future request must not hold up an arrived
        one (empty result => nothing has arrived yet; see
        :meth:`earliest_arrival`)."""
        if now is None:
            out = []
            while self.heap and len(out) < self.batch_size:
                out.append(heapq.heappop(self.heap).idx)
            return out
        arrived = sorted(q for q in self.heap if q.arrival_s <= now)
        take = arrived[: self.batch_size]
        for q in take:
            self.heap.remove(q)
        heapq.heapify(self.heap)
        return [q.idx for q in take]

    def earliest_arrival(self) -> float:
        return min(q.arrival_s for q in self.heap)

    def __len__(self):
        return len(self.heap)


def pick_exit(remaining_s: float, per_exit_step_s: List[float],
              tokens_left: int, preferred: int) -> int:
    """Deepest exit (<= preferred) whose projected completion fits the
    remaining budget; floor at exit 1."""
    for e in range(preferred, 0, -1):
        if per_exit_step_s[e - 1] * tokens_left <= remaining_s:
            return e
    return 1
