"""The traced run: spans around the program's public calls, and the reduction of
``torch.profiler``'s trace to per-call device time, busy time and idle gaps.

Spans come from wrappers the benchmark installs around ``Model.prefill``,
``Model.decode_step``, ``ServingEngine.serve`` and the kernel wrappers of
``repro_torch.kernels.*.ops`` (module attributes, which the models look up at each
call).  Each span synchronises the device before and after the call.  A
kernel-wrapper call also launches a marker kernel before and after its work; its
device time is the sum of the operations between its two markers on the device's
timeline.  Every span is a ``record_function`` range named ``pb:<kind>:<n>``, in
the profiler's own clock.  Nothing is written to disk.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

from portbench.harness import flops as F

PREFIX = "pb:"
MARKER = "spin_kernel"          # the kernel torch.cuda._sleep launches
MARK_CYCLES = 1


@dataclass
class OpCall:
    kind: str
    name: str
    flops: float
    nbytes: float
    elt: int
    device_s: float = 0.0
    kernels: int = 0


@dataclass
class Span:
    kind: str
    name: str
    ms: float                      # host wall, synchronised at both ends
    info: dict


@dataclass
class TraceData:
    ops: List[OpCall] = field(default_factory=list)
    spans: List[Span] = field(default_factory=list)
    busy_s: float = 0.0
    window_s: float = 0.0
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    unattributed_calls: int = 0


def _elt(t) -> int:
    return t.element_size()


def count(kind: str, args, kw) -> Tuple[float, float, int]:
    """(flops, bytes, element size) of one kernel-wrapper call, from its arguments."""
    if kind == "flash_attention":
        q, k, v = args[:3]
        B, S, H, hd = q.shape
        f, b = F.flash_attention(B, S, k.shape[1], H, k.shape[2], hd,
                                 kw.get("causal", True), _elt(q))
        return f, b, _elt(q)
    if kind == "decode_attention":
        q, k, v, lengths = args[:4]
        B, _, H, hd = q.shape
        f, b = F.decode_attention(B, H, k.shape[2], hd, lengths.tolist(), _elt(q))
        return f, b, _elt(q)
    if kind == "ssm_scan":
        q, k, v, log_w, state = args[:5]
        u = kw.get("u", args[5] if len(args) > 5 else None)
        B, S, H, dk = q.shape
        dv = v.shape[-1]
        inb = sum(F.distinct_bytes(t.shape, t.stride(), _elt(t)) for t in (q, k, v, log_w))
        f, b = F.ssm_scan(B, S, H, dk, dv, inb, _elt(v), u is not None)
        return f, b, _elt(v)
    if kind == "exit_confidence":
        h, emb = args[:2]
        rows = h.shape[0] * h.shape[1]
        f, b = F.exit_head(rows, h.shape[2], emb.shape[0], _elt(h))
        return f, b, _elt(h)
    raise KeyError(kind)


class Tracer:
    def __init__(self, eng, device):
        self.eng, self.dev = eng, device
        self.data = TraceData()
        self.n = 0
        self._saved = []
        self.sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" \
            else (lambda: None)

    def _name(self, kind):
        self.n += 1
        return f"{PREFIX}{kind}:{self.n}"

    def span(self, kind, fn, info_of):
        def wrapped(*a, **k):
            name = self._name(kind)
            self.sync()
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = fn(*a, **k)
                self.sync()
            self.data.spans.append(Span(kind, name, (time.perf_counter() - t0) * 1e3,
                                        info_of(a, k)))
            return out
        return wrapped

    def mark(self):
        if self.dev.type == "cuda":
            torch.cuda._sleep(MARK_CYCLES)

    def op(self, kind, fn):
        def wrapped(*a, **k):
            f, b, elt = count(kind, a, k)
            name = self._name(kind)
            self.sync()
            with torch.profiler.record_function(name):
                self.mark()
                out = fn(*a, **k)
                self.mark()
                self.sync()
            self.data.ops.append(OpCall(kind, name, f, b, elt))
            return out
        return wrapped

    def install(self):
        from repro_torch.kernels.exit_head import ops as eh_ops
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.kernels.ssm_scan import ops as ss_ops
        mods = {"flash_attention": fa_ops, "decode_attention": fa_ops,
                "ssm_scan": ss_ops, "exit_confidence": eh_ops}
        for kind, mod in mods.items():
            fn = getattr(mod, kind)
            self._saved.append((mod, kind, fn))
            setattr(mod, kind, self.op(kind, fn))
        model, engine = self.eng.model, self.eng.engine
        n_seg = model.num_segments
        model.prefill = self.span(
            "prefill", model.prefill,
            lambda a, k: {"B": a[1].shape[0], "S": a[1].shape[1]})
        model.decode_step = self.span(
            "decode_step", model.decode_step,
            lambda a, k: {"B": a[2].shape[0], "segments": n_seg if k.get("exit_point") is None
                          else k["exit_point"] + 1, "n_segments": n_seg})
        engine.serve = self.span("serve", engine.serve, lambda a, k: {})

    def uninstall(self):
        for mod, kind, fn in self._saved:
            setattr(mod, kind, fn)


def _events(prof):
    """(name, is_device, start_ns, end_ns) of every event."""
    try:
        out = []
        for e in prof.profiler.kineto_results.events():
            st = e.start_ns()
            out.append((e.name(), e.device_type() != torch.autograd.DeviceType.CPU,
                        st, st + e.duration_ns()))
        return out
    except AttributeError:
        pass
    return [(e.name, e.device_type != torch.autograd.DeviceType.CPU,
             int(e.time_range.start * 1e3), int(e.time_range.end * 1e3)) for e in prof.events()]


GAP_LABEL = {"window": "harness between serve() calls",
             "serve": "engine host: plan, cache allocation, token reads",
             "prefill": "prefill host dispatch", "decode_step": "decode step host dispatch"}


def innermost(spans, points):
    """For each of ``points`` (sorted), the kind of the innermost span around it, or
    None: spans nest (one thread, synchronous calls), so a sweep in time order
    keeps the open ones on a stack."""
    out, stack, j = [], [], 0
    for t in points:
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def reduce(prof, data: TraceData, window_name: str):
    reduce_events(_events(prof), data, window_name)


def reduce_events(events, data: TraceData, window_name: str):
    """Fill ``data`` from the profile's events (see :func:`_events`): each op call's
    device time, busy and window seconds, the device time by operation name, and
    the idle gaps by what the host was doing (the innermost span around each gap's
    middle; the marker kernels are instrumentation and count as neither).

    An op call's operations are those between its two markers on the device's
    timeline (the i-th call's between the 2i-th and 2i+1-th marker): the host's
    clock and the device's part by tens of microseconds, so a span on the host
    cannot tell them.  A trace with device operations whose markers do not pair
    with the calls is refused; one with none (a run on the CPU) leaves every call
    without device time."""
    ranges: Dict[str, Tuple[int, int]] = {}
    dev_ops, marks = [], []
    for name, dev, s, e in events:
        if name.startswith(PREFIX):
            if not dev:
                ranges[name] = (s, e)
        elif dev:
            (marks if MARKER in name else dev_ops).append((s, e, name))
    w0, w1 = ranges[window_name]
    dev_ops = sorted(k for k in dev_ops if k[1] > w0 and k[0] < w1)
    marks = sorted(m for m in marks if m[1] > w0 and m[0] < w1)
    starts = [k[0] for k in dev_ops]
    if (dev_ops or marks) and len(marks) != 2 * len(data.ops):
        raise RuntimeError(f"{len(marks)} marker kernels in the window for {len(data.ops)} "
                           "kernel-wrapper calls: their operations cannot be told apart")
    for n, call in enumerate(data.ops):
        if not marks:
            data.unattributed_calls += 1
            continue
        lo, hi = marks[2 * n][1], marks[2 * n + 1][0]
        i, j = bisect.bisect_left(starts, lo), bisect.bisect_right(starts, hi)
        call.device_s = sum(dev_ops[x][1] - dev_ops[x][0] for x in range(i, j)) / 1e9
        call.kernels = j - i
        if j == i:
            data.unattributed_calls += 1
    busy, end, gaps = 0, w0, []
    by_name = defaultdict(float)
    for s, e, name in dev_ops:
        s, e = max(s, w0), min(e, w1)
        by_name[name] += (e - s) / 1e9
        if s > end:
            gaps.append((end, s))
        if e > end:
            busy += e - max(s, end)
            end = e
    if w1 > end:
        gaps.append((end, w1))
    data.busy_s, data.window_s = busy / 1e9, (w1 - w0) / 1e9
    data.device_ops = sorted(((n[:120], v) for n, v in by_name.items()),
                             key=lambda x: -x[1])[:10]
    spans = sorted((r[0], r[1], n.split(":")[1]) for n, r in ranges.items())
    kinds = innermost(spans, [(g0 + g1) // 2 for g0, g1 in gaps])
    by_host = defaultdict(float)
    for (g0, g1), kind in zip(gaps, kinds):
        by_host[GAP_LABEL.get(kind, f"{kind} wrapper host") if kind else "harness"] += (g1 - g0) / 1e9
    data.idle_gaps = sorted(by_host.items(), key=lambda x: -x[1])[:10]
