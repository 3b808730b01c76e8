"""Request-span tracing: Chrome/Perfetto trace-event JSON from a fleet run.

A :class:`Tracer` attached to a :class:`~repro_torch.fleet.engine.FleetEngine`
(via ``EngineSpec(trace="out.json")`` or directly) records every request
lifecycle edge the engine crosses — arrival/plan, queue wait, uplink,
prefill, decode rounds, cooperative span hops, handover snapshot/transfer/
resume, completion — as standard trace events that open directly in
``chrome://tracing`` or https://ui.perfetto.dev (docs/observability.md).

Track layout (the pid/tid conventions the engine emits):

* one *process* per edge (``pid`` = edge id): ``tid 0`` is the rounds
  track (one ``X`` span per decode round), ``tid 1..capacity`` are the
  continuous-batching slots carrying per-request ``uplink`` / ``prefill``
  / ``decode`` spans, and per-edge counter tracks (``backlog_s``,
  ``slots``, ``tokens_owed``, ``coop_inflight``) ride alongside;
* ``pid`` :data:`Tracer.PID_DEVICES`: one thread per device with local
  execution spans, zero-duration ``plan`` instants, and the request-scoped
  async spans (``request`` / ``queue`` / ``handover``, ``ph`` b/e keyed by
  request id) that survive migrations across edges;
* ``pid`` :data:`Tracer.PID_NET`: backbone ``transfer`` / ``handover``
  wire spans (one thread per source edge).

Timestamps are the simulator's *virtual* seconds scaled to microseconds
(the trace-event unit), so the viewer's ruler reads virtual time directly.
The tracer is write-only with respect to the simulation: attaching one
never schedules events, mutates state, or consumes RNG, so summaries stay
bit-identical with tracing on or off (pinned by tests/test_torch_obs.py).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

__all__ = ["Tracer", "load_trace", "validate_trace"]

_US = 1e6          # virtual seconds -> trace-event microseconds


class Tracer:
    """Accumulates trace events in memory; ``save()`` writes the standard
    ``{"traceEvents": [...]}`` JSON object."""

    PID_DEVICES = 10_000      # devices pseudo-process (above any edge id)
    PID_NET = 10_001          # backbone pseudo-process

    def __init__(self):
        self.events: List[Dict] = []

    def reset(self) -> None:
        """Drop all accumulated events (the engine calls this per run so a
        reused engine does not concatenate runs into one file)."""
        self.events = []

    # ------------------------------------------------------------- emitters
    def complete(self, name: str, t0_s: float, t1_s: float, pid: int,
                 tid: int, *, cat: str = "sim",
                 args: Optional[Dict] = None) -> None:
        """One ``X`` (complete) span over virtual [t0_s, t1_s]."""
        ev = {"name": name, "ph": "X", "cat": cat, "pid": pid, "tid": tid,
              "ts": t0_s * _US, "dur": (t1_s - t0_s) * _US}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, t_s: float, pid: int, tid: int, *,
                cat: str = "sim", args: Optional[Dict] = None) -> None:
        ev = {"name": name, "ph": "i", "s": "t", "cat": cat, "pid": pid,
              "tid": tid, "ts": t_s * _US}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, t_s: float, pid: int,
                values: Dict[str, float]) -> None:
        """One sample on the ``name`` counter track of process ``pid``
        (every key in ``values`` is a series on that track)."""
        self.events.append({"name": name, "ph": "C", "pid": pid, "tid": 0,
                            "ts": t_s * _US, "args": values})

    def async_begin(self, name: str, id_: int, t_s: float, pid: int,
                    tid: int, *, cat: str = "req",
                    args: Optional[Dict] = None) -> None:
        """Open one nestable async span, keyed by (cat, id) — request-scoped
        stages that outlive any single edge/track use these."""
        ev = {"name": name, "ph": "b", "cat": cat, "id": id_, "pid": pid,
              "tid": tid, "ts": t_s * _US}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def async_end(self, name: str, id_: int, t_s: float, pid: int,
                  tid: int, *, cat: str = "req",
                  args: Optional[Dict] = None) -> None:
        ev = {"name": name, "ph": "e", "cat": cat, "id": id_, "pid": pid,
              "tid": tid, "ts": t_s * _US}
        if args:
            ev["args"] = args
        self.events.append(ev)

    # ------------------------------------------------------------- metadata
    def process_name(self, pid: int, name: str) -> None:
        self.events.append({"name": "process_name", "ph": "M", "pid": pid,
                            "tid": 0, "args": {"name": name}})

    def thread_name(self, pid: int, tid: int, name: str) -> None:
        self.events.append({"name": "thread_name", "ph": "M", "pid": pid,
                            "tid": tid, "args": {"name": name}})

    def decode_stats(self, stats: Dict) -> None:
        """Attach the run's decode-efficiency counters (the engine's
        ``cache_stats()`` decode/arena/jit blocks) as a metadata record —
        not a span, so no timestamp.  ``repro_torch.obs report`` renders it as
        the decode-efficiency panel."""
        self.events.append({"name": "decode_stats", "ph": "M", "pid": 0,
                            "tid": 0, "args": stats})

    def annotate_fleet(self, topo) -> None:
        """Name every track for a fleet topology (edges/slots/devices/net)
        so the viewer shows labels instead of bare pids."""
        for edge in topo.edges:
            self.process_name(edge.eid,
                              f"edge {edge.eid} (speed {edge.speed:g})")
            self.thread_name(edge.eid, 0, "rounds")
            for slot in range(edge.capacity):
                self.thread_name(edge.eid, slot + 1, f"slot {slot}")
        self.process_name(self.PID_DEVICES, "devices")
        for dev in topo.devices:
            self.thread_name(self.PID_DEVICES, dev.did, f"device {dev.did}")
        self.process_name(self.PID_NET, "backbone")
        for edge in topo.edges:
            self.thread_name(self.PID_NET, edge.eid,
                             f"from edge {edge.eid}")

    # ------------------------------------------------------------------ I/O
    def to_chrome(self) -> Dict:
        return {"traceEvents": self.events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, default=float)


def load_trace(path: str) -> Dict:
    """Read a trace file back (either the ``{"traceEvents": ...}`` object
    form or a bare event array, both of which viewers accept)."""
    with open(path) as f:
        obj = json.load(f)
    if isinstance(obj, list):
        obj = {"traceEvents": obj}
    return obj


def validate_trace(trace: Dict) -> List[str]:
    """Structural checks on a loaded trace; returns human-readable problem
    strings (empty = valid).  CI runs this on the smoke-mobility artifact:
    parseable, >0 complete events, non-negative durations, balanced async
    begin/end pairs, required fields per phase."""
    problems: List[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["no traceEvents array"]
    n_complete = 0
    opens: Dict[tuple, int] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or "ph" not in ev or "name" not in ev:
            problems.append(f"event {i}: missing ph/name")
            continue
        ph = ev["ph"]
        if ph != "M" and "ts" not in ev:
            problems.append(f"event {i} ({ev['name']}): missing ts")
            continue
        if ph == "X":
            n_complete += 1
            if ev.get("dur", -1.0) < 0:
                problems.append(
                    f"event {i} ({ev['name']}): negative duration")
        elif ph in ("b", "e"):
            key = (ev.get("cat"), ev.get("id"), ev["name"])
            opens[key] = opens.get(key, 0) + (1 if ph == "b" else -1)
            if opens[key] < 0:
                problems.append(
                    f"event {i} ({ev['name']}): async end before begin")
        elif ph == "C" and not isinstance(ev.get("args"), dict):
            problems.append(f"event {i} ({ev['name']}): counter without "
                            "args series")
    if n_complete == 0:
        problems.append("no complete ('X') events")
    for key, depth in opens.items():
        if depth != 0:
            problems.append(f"unbalanced async span {key}: depth {depth}")
    return problems
