"""``python -m repro_torch.obs`` — text dashboards over traces and timelines.

    python -m repro_torch.obs report trace.json       # span breakdown + sparklines
    python -m repro_torch.obs report timeline.jsonl   # per-edge gauge sparklines
    python -m repro_torch.obs validate trace.json     # CI structural check

``report`` auto-detects the artifact kind (Chrome trace-event JSON from
``--trace``, or the timeline JSONL from ``--timeline``) and renders a
terminal dashboard: per-edge utilization sparklines and, for traces, the
span-latency breakdown table (queue vs uplink vs compute vs backbone vs
handover).  ``validate`` runs :func:`repro_torch.obs.trace.validate_trace` and
exits non-zero on structural problems — the CI observability smoke leg.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Sequence

from repro_torch.obs.timeline import load_timeline
from repro_torch.obs.trace import load_trace, validate_trace

__all__ = ["main", "render_timeline", "render_trace", "sparkline"]

_BLOCKS = "▁▂▃▄▅▆▇█"
# the span-latency breakdown rows, in pipeline order; "queue" and
# "handover" are measured from their async b/e pairs, the rest are X spans
_STAGES = ("queue", "uplink", "prefill", "decode", "transfer", "handover")
_ASYNC_STAGES = ("queue", "handover")


def sparkline(values: Sequence[float], width: int = 40) -> str:
    """Resample ``values`` to ``width`` buckets (bucket mean) and render
    them as unicode block characters scaled to the series max."""
    vals = [float(v) for v in values]
    if not vals:
        return ""
    if len(vals) > width:
        per = len(vals) / width
        vals = [sum(vals[int(i * per):max(int(i * per) + 1,
                                          int((i + 1) * per))])
                / max(1, int((i + 1) * per) - int(i * per))
                for i in range(width)]
    peak = max(vals)
    if peak <= 0:
        return _BLOCKS[0] * len(vals)
    return "".join(_BLOCKS[min(len(_BLOCKS) - 1,
                               int(v / peak * (len(_BLOCKS) - 1) + 0.5))]
                   for v in vals)


# ------------------------------------------------------------------ trace
def _span_stats(events: List[Dict]) -> Dict[str, Dict]:
    """Per-stage duration stats: X spans by name plus async pairs (queue)
    matched on (cat, id, name)."""
    stats: Dict[str, Dict] = {}

    def add(name: str, dur_s: float):
        s = stats.setdefault(name, {"count": 0, "total_s": 0.0})
        s["count"] += 1
        s["total_s"] += dur_s

    begins: Dict[tuple, float] = {}
    for ev in events:
        ph = ev.get("ph")
        if ph == "X":
            add(ev["name"], ev.get("dur", 0.0) / 1e6)
        elif ph == "b":
            begins[(ev.get("cat"), ev.get("id"), ev["name"])] = ev["ts"]
        elif ph == "e":
            t0 = begins.pop((ev.get("cat"), ev.get("id"), ev["name"]), None)
            if t0 is not None:
                add(ev["name"] + " (async)", (ev["ts"] - t0) / 1e6)
    return stats


def _edge_utilization(events: List[Dict], width: int) -> Dict[int, str]:
    """Busy-fraction sparkline per edge process, from its ``round`` spans
    bucketed over the trace's virtual-time extent."""
    rounds: Dict[int, List[tuple]] = {}
    t_max = 0.0
    for ev in events:
        if ev.get("ph") == "X":
            t_max = max(t_max, ev["ts"] + ev.get("dur", 0.0))
            if ev["name"] == "round":
                rounds.setdefault(ev["pid"], []).append(
                    (ev["ts"], ev.get("dur", 0.0)))
    if not rounds or t_max <= 0:
        return {}
    bucket = t_max / width
    out = {}
    for pid in sorted(rounds):
        busy = [0.0] * width
        for ts, dur in rounds[pid]:
            lo, hi = ts, ts + dur
            b0, b1 = int(lo / bucket), min(width - 1, int(hi / bucket))
            for b in range(b0, b1 + 1):
                w0, w1 = b * bucket, (b + 1) * bucket
                busy[b] += max(0.0, min(hi, w1) - max(lo, w0))
        out[pid] = sparkline([v / bucket for v in busy], width)
    return out


def render_trace(trace: Dict, *, width: int = 40) -> str:
    events = trace.get("traceEvents", [])
    lines = [f"trace: {len(events)} events, "
             f"{sum(1 for e in events if e.get('ph') == 'X')} spans"]
    stats = _span_stats(events)
    named = [(s, stats.get(s + " (async)") if s in _ASYNC_STAGES
              else stats.get(s)) for s in _STAGES]
    named += [("round", stats.get("round")),
              ("request e2e", stats.get("request (async)"))]
    rows = [(name, s) for name, s in named if s]
    if rows:
        total = sum(s["total_s"] for name, s in rows
                    if name in _STAGES) or 1.0
        lines.append("")
        lines.append(f"{'stage':>12} {'spans':>8} {'total_s':>10} "
                     f"{'mean_ms':>9} {'share':>7}")
        for name, s in rows:
            share = f"{100.0 * s['total_s'] / total:6.1f}%" \
                if name in _STAGES else "      -"
            lines.append(
                f"{name:>12} {s['count']:>8} {s['total_s']:>10.3f} "
                f"{1e3 * s['total_s'] / s['count']:>9.2f} {share}")
    util = _edge_utilization(events, width)
    if util:
        lines.append("")
        lines.append("edge utilization (rounds in flight, virtual time ->)")
        for pid, spark in util.items():
            lines.append(f"  edge {pid:>3} {spark}")
    panel = _decode_panel(events)
    if panel:
        lines.append("")
        lines.extend(panel)
    return "\n".join(lines)


def _decode_panel(events) -> list:
    """The decode-efficiency panel from the engine's ``decode_stats``
    metadata record (real-decode runs only; see Tracer.decode_stats).
    Counters are cumulative over the stepper's lifetime."""
    recs = [ev for ev in events
            if ev.get("ph") == "M" and ev.get("name") == "decode_stats"
            and isinstance(ev.get("args"), dict)]
    if not recs:
        return []
    args = recs[-1]["args"]
    dec = args.get("decode", {})
    ar = args.get("arena", {})
    jit = args.get("jit", {})
    lines = ["decode efficiency (real-decode path)"]
    waste_den = dec.get("batched_tokens", 0) + dec.get("padded_rows", 0)
    waste = 100.0 * dec.get("padded_rows", 0) / waste_den if waste_den \
        else 0.0
    lines.append(
        f"  batched: {dec.get('batched_calls', 0)} calls, "
        f"{dec.get('batched_tokens', 0)} tokens, "
        f"max group {dec.get('batched_max', 0)}, "
        f"padded rows {dec.get('padded_rows', 0)} ({waste:.1f}% waste); "
        f"serial tokens {dec.get('serial_tokens', 0)}")
    occ = ar.get("occupancy")
    lines.append(
        f"  arena:   {ar.get('calls', 0)} calls, "
        f"{ar.get('tokens', 0)} tokens, "
        f"occupancy {f'{100.0 * occ:.1f}%' if occ is not None else '-'}, "
        f"admits/evicts/grows "
        f"{ar.get('admits', 0)}/{ar.get('evicts', 0)}/{ar.get('grows', 0)}")
    hr = jit.get("hit_rate")
    var = jit.get("variants", {})
    lines.append(
        f"  jit:     hit rate "
        f"{f'{100.0 * hr:.1f}%' if hr is not None else '-'}, "
        f"{jit.get('entries', 0)} compiled variants "
        f"(serial {var.get('serial', 0)} / batched {var.get('batched', 0)}"
        f" / arena {var.get('arena', 0)})")
    return lines


# --------------------------------------------------------------- timeline
def render_timeline(tl: Dict, *, width: int = 40) -> str:
    header = tl["header"]
    t = tl["t"]
    lines = [f"timeline: {header['samples']} samples x "
             f"{header['num_edges']} edges (dt={header['dt']}s"
             + (f", {header['num_devices']} devices" if
                header.get("device_signals") else "") + ")"]
    if len(t) == 0:
        return lines[0]
    span = float(t[-1] - t[0])
    lines.append(f"virtual time {float(t[0]):.2f}s .. {float(t[-1]):.2f}s")
    backlog = tl["edge"]["backlog_s"]
    busy = tl["edge"]["busy_s"]
    done = tl["edge"]["completed"]
    lines.append("")
    lines.append("per-edge backlog_s (sparkline over samples), "
                 "utilization, completions")
    for k in range(header["num_edges"]):
        util = float(busy[-1, k] - busy[0, k]) / span if span > 0 else 0.0
        lines.append(f"  edge {k:>3} {sparkline(backlog[:, k], width)}  "
                     f"util={util:4.2f}  done={int(done[-1, k])}")
    if tl.get("device"):
        bw = tl["device"]["bw_bps"]
        mean_bw = bw.mean(axis=1) / 1e6 * 8
        lines.append("")
        lines.append(f"fleet mean observed bandwidth (Mbps): "
                     f"{sparkline(mean_bw, width)}  "
                     f"last={float(mean_bw[-1]):.2f}")
    return "\n".join(lines)


# -------------------------------------------------------------------- CLI
def _detect_and_render(path: str, width: int) -> str:
    with open(path) as f:
        head = f.read(2048).lstrip()
    if head.startswith("{") and '"type": "timeline"' in head.splitlines()[0]:
        return render_timeline(load_timeline(path), width=width)
    return render_trace(load_trace(path), width=width)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Dashboards over fleet observability artifacts "
                    "(docs/observability.md).")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser("report", help="render a text dashboard")
    rep.add_argument("path", help="trace JSON or timeline JSONL")
    rep.add_argument("--width", type=int, default=40,
                     help="sparkline width in characters")
    val = sub.add_parser("validate", help="structural trace check (CI)")
    val.add_argument("path", help="trace JSON")
    args = ap.parse_args(argv)

    if args.cmd == "report":
        print(_detect_and_render(args.path, args.width))
        return 0
    trace = load_trace(args.path)
    problems = validate_trace(trace)
    if problems:
        for p in problems:
            print(f"INVALID  {p}", file=sys.stderr)
        return 1
    events = trace["traceEvents"]
    print(f"valid Chrome trace: {len(events)} events, "
          f"{sum(1 for e in events if e.get('ph') == 'X')} complete spans")
    return 0


if __name__ == "__main__":
    sys.exit(main())
