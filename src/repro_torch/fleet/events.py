"""Virtual-clock discrete-event core of the fleet simulator.

A single binary heap orders :class:`Event`s by ``(time, seq)``; the ``seq``
counter breaks ties deterministically, which pins the **ordering contract**
(tested by ``tests/test_fleet.py::test_event_queue_orders_by_time_then_fifo``
and ``test_event_queue_tie_break_contract``):

* events pop in ascending ``time``;
* events pushed with the *same* timestamp pop in push (FIFO) order — the
  ``seq`` tie-break — regardless of kind or payload;
* therefore an event pushed *while handling* an event at time ``t`` pops
  after every event already scheduled for ``t``.

That last property is what lets the engine batch all per-device bandwidth
samples of one time slot into a single fleet-wide ``sample`` sweep event
(devices observed in ascending id order) without reordering anything: the
per-device sample events it replaces were themselves pushed — and therefore
popped — in device order, ahead of any same-timestamp event scheduled later.
A fixed seed always replays the identical schedule regardless of host speed.

``Event`` is a :class:`~typing.NamedTuple` so heap comparisons are plain
C-level tuple comparisons (the previous ``@dataclass(order=True)`` spent a
measurable slice of large simulations inside generated ``__lt__``); the
unique ``seq`` in slot 1 guarantees comparisons never reach ``kind``.
"""
from __future__ import annotations

import heapq
from typing import Any, List, NamedTuple


class Event(NamedTuple):
    time: float
    seq: int
    kind: str
    payload: Any = None


class EventQueue:
    """Min-heap of events + the simulator's virtual clock (``now``)."""

    def __init__(self):
        self._heap: List[Event] = []
        self._seq = 0
        self.now = 0.0

    def push(self, time_s: float, kind: str, payload: Any = None) -> Event:
        """Schedule an event; same-time events pop in push (FIFO) order."""
        ev = Event(time_s, self._seq, kind, payload)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        """Remove and return the earliest event, advancing ``now``."""
        ev = heapq.heappop(self._heap)
        self.now = ev.time
        return ev

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
