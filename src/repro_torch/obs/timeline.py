"""Telemetry timelines: columnar per-edge/per-device gauges over a run.

A :class:`Timeline` attached to a :class:`~repro_torch.fleet.engine.FleetEngine`
(via ``EngineSpec(timeline="out.jsonl")``) snapshots fleet state on the
sampling grid into numpy ring buffers — the streaming utilization/backlog
feed the ROADMAP's autoscaler subscribes to, and the raw material for
``python -m repro_torch.obs report`` dashboards.

Sampling piggybacks on whatever grid the engine already runs: under an
active handover policy each fleet-wide ``sample`` sweep takes one snapshot
(which also carries the per-device signals that sweep just computed —
observed best-signal bandwidth and the BOCD run-length MAP); otherwise the
engine schedules dedicated ``obs`` events every ``dt`` virtual seconds.
Either way snapshots read state and never mutate it, so summaries stay
bit-identical with the timeline on or off (pinned by
tests/test_torch_obs.py).

Columns per sample: ``t`` (virtual s), per-edge gauges
(:data:`EDGE_GAUGES`: backlog seconds, tokens owed, busy/queued slot
counts, cooperative in-flight spans, cumulative busy seconds, completions,
provisioned capacity — the admission/autoscaling state of every edge) and,
when device signals were available, :data:`DEVICE_SIGNALS`.  The buffers are rings: past
``capacity`` samples the oldest rows are overwritten (``n`` keeps the
total ever taken).  ``to_jsonl`` writes a self-describing header line plus
one JSON object per retained sample; :func:`load_timeline` reads that back
into arrays.
"""
from __future__ import annotations

import json
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["DEVICE_SIGNALS", "EDGE_GAUGES", "Timeline", "load_timeline"]

EDGE_GAUGES = ("backlog_s", "tokens_owed", "active", "queued",
               "coop_inflight", "busy_s", "completed", "capacity")
DEVICE_SIGNALS = ("bw_bps", "run_len")


class Timeline:
    def __init__(self, num_edges: int, *, num_devices: int = 0,
                 dt: float = 0.5, capacity: int = 4096):
        if num_edges <= 0:
            raise ValueError(f"num_edges must be positive, got {num_edges}")
        self.num_edges = num_edges
        self.num_devices = num_devices
        self.dt = dt
        self.capacity = capacity
        self.n = 0                      # samples ever taken (ring may wrap)
        self.t = np.zeros(capacity)
        self.edge: Dict[str, np.ndarray] = {
            g: np.zeros((capacity, num_edges)) for g in EDGE_GAUGES}
        self.device: Dict[str, np.ndarray] = {
            s: np.zeros((capacity, num_devices)) for s in DEVICE_SIGNALS} \
            if num_devices > 0 else {}
        self._device_sampled = False    # any snapshot carried device signals

    def reset(self) -> None:
        """Restart the ring (the engine calls this per run)."""
        self.n = 0
        self._device_sampled = False

    @property
    def num_retained(self) -> int:
        return min(self.n, self.capacity)

    # ------------------------------------------------------------- sampling
    def snapshot(self, t_s: float, topo, *,
                 bw_row: Optional[np.ndarray] = None,
                 run_len: Optional[np.ndarray] = None) -> None:
        """Record one sample of every edge's gauges (plus optional
        per-device signals) at virtual time ``t_s``.  Read-only with
        respect to ``topo`` — snapshotting must never perturb the run."""
        i = self.n % self.capacity
        self.t[i] = t_s
        eg = self.edge
        for k, e in enumerate(topo.edges):
            eg["backlog_s"][i, k] = e.backlog_s()
            eg["tokens_owed"][i, k] = e.tokens_owed
            eg["active"][i, k] = len(e.active)
            eg["queued"][i, k] = len(e.queue) - e.q_dead
            eg["coop_inflight"][i, k] = e.coop_inflight
            eg["busy_s"][i, k] = e.busy_s
            eg["completed"][i, k] = e.completed
            eg["capacity"][i, k] = e.capacity
        if self.device:
            if bw_row is not None:
                self.device["bw_bps"][i] = bw_row
            if run_len is not None:
                self.device["run_len"][i] = run_len
            if bw_row is not None or run_len is not None:
                self._device_sampled = True
        self.n += 1

    # ------------------------------------------------------------------ I/O
    def rows(self) -> Iterator[Dict]:
        """Retained samples in chronological order (ring-aware)."""
        kept = self.num_retained
        start = self.n - kept
        for j in range(kept):
            i = (start + j) % self.capacity
            row = {"t": float(self.t[i]),
                   "edge": {g: self.edge[g][i].tolist()
                            for g in EDGE_GAUGES}}
            if self.device and self._device_sampled:
                row["device"] = {s: self.device[s][i].tolist()
                                 for s in DEVICE_SIGNALS}
            yield row

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            header = {"type": "timeline", "dt": self.dt,
                      "num_edges": self.num_edges,
                      "num_devices": self.num_devices,
                      "samples": self.num_retained, "total_samples": self.n,
                      "edge_gauges": list(EDGE_GAUGES),
                      "device_signals": list(DEVICE_SIGNALS)
                      if self.device and self._device_sampled else []}
            f.write(json.dumps(header) + "\n")
            for row in self.rows():
                f.write(json.dumps(row) + "\n")


def load_timeline(path: str) -> Dict:
    """Read a timeline JSONL back into arrays: ``{"header": ..., "t": [S],
    "edge": {gauge: [S, E]}, "device": {signal: [S, N]} | {}}``."""
    with open(path) as f:
        lines = [line for line in f if line.strip()]
    if not lines:
        raise ValueError(f"{path}: empty timeline file")
    header = json.loads(lines[0])
    if header.get("type") != "timeline":
        raise ValueError(f"{path}: not a timeline JSONL "
                         "(missing header line)")
    rows = [json.loads(line) for line in lines[1:]]
    out = {"header": header,
           "t": np.array([r["t"] for r in rows]),
           "edge": {g: np.array([r["edge"][g] for r in rows])
                    for g in header["edge_gauges"]} if rows else {},
           "device": {}}
    if rows and header.get("device_signals"):
        out["device"] = {s: np.array([r["device"][s] for r in rows])
                         for s in header["device_signals"]}
    return out
