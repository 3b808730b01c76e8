"""The serving engine's spans and counters on the real clock.

Recording is on while a ``torch.profiler`` session records: the gate is
``torch.autograd._profiler_enabled()``, which takes tens of nanoseconds.
Off, a call site checks the gate once and does nothing else: it opens no
range, reads no clock, allocates nothing and never synchronises the device.
A call site reads::

    with spans.span("model.segment", {"index": si}) if spans.on() else spans.OFF:
        ...

On, a span is two things:

* a profiler range named ``edgent:<layer>.<what>`` in the profiler's own
  trace, on the clock of the device operations launched inside it; its
  ``args`` are the range's keyword values, which a session opened with
  ``record_shapes=True`` keeps (``prof.events()[i].kwinputs``, and ``args``
  in ``prof.export_chrome_trace``);
* its host time (``time.perf_counter_ns``), added to :data:`REGISTRY`: the
  counters ``<name>.calls`` and ``<name>.host_ns``; the host time of the
  ``kernel.*`` spans inside a ``model.decode_step`` goes to
  ``model.decode_step.kernel_ns`` as well.  ``counts`` given to a span are
  added to counters of those names when it closes.

The spans and counters, and what each is for: ``docs/torch_spans.md``.

The ranges are ``torch._C._profiler._RecordFunctionFast``.  The range that
``torch.profiler.record_function`` opens is a user annotation, which the
profiler also lays on the device's timeline over every kernel launched
inside it: a reading of the device's busy time from the trace would then
count a whole batch as busy.  This range stays on the host, and costs about
a third of a ``record_function`` range (2.6-4.5 µs against 8.1-13.9 under a
profiler session on the host of an H100 machine).

Recording adds no device operation and changes none: tokens are bit for bit
the same with recording on and off.  The registry is process-wide and
keeps what every profiled stretch recorded until :func:`reset`.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch

from repro_torch.obs.registry import MetricsRegistry

__all__ = ["OFF", "PREFIX", "REGISTRY", "STEP", "clock", "on", "reset", "segment", "span"]

PREFIX = "edgent:"

#: the gate: True while a ``torch.profiler`` session records
on = torch.autograd._profiler_enabled
#: the host clock of every span and request time, in ns
clock = time.perf_counter_ns
_range = torch._C._profiler._RecordFunctionFast

REGISTRY = MetricsRegistry()
STEP = "model.decode_step"
_in_step = False                         # a decode step's span is open


#: what a call site enters while the gate is off
OFF = contextlib.nullcontext()


class span:
    """One unit of work, opened only while the gate is on (module doc).
    ``args``: the range's keyword values (ints, floats, strings);
    ``counts``: counter name -> amount, added when the span closes (read
    then, so a call site may fill it inside the span)."""
    __slots__ = ("name", "counts", "rf", "t0", "t1")

    def __init__(self, name: str, args: Optional[Dict] = None,
                 counts: Optional[Dict[str, int]] = None):
        self.name, self.counts = name, counts
        self.rf = _range(PREFIX + name, (), args) if args else _range(PREFIX + name)

    def __enter__(self):
        global _in_step
        self.rf.__enter__()
        if self.name == STEP:
            _in_step = True
        self.t0 = clock()
        return self

    def __exit__(self, *exc):
        global _in_step
        self.t1 = clock()
        ns = self.t1 - self.t0
        self.rf.__exit__(*exc)
        name = self.name
        REGISTRY.counter(name + ".calls").inc()
        REGISTRY.counter(name + ".host_ns").inc(ns)
        if name == STEP:
            _in_step = False
        elif _in_step and name.startswith("kernel."):
            REGISTRY.counter(STEP + ".kernel_ns").inc(ns)
        if self.counts:
            for k, n in self.counts.items():
                REGISTRY.counter(k).inc(n)
        return False


def segment(index: int, units: int) -> span:
    """The ``model.segment`` span of segment ``index``, ``units`` long: a
    segment boundary is one of Edgent's exits."""
    return span("model.segment", {"index": index, "units": units})


def reset() -> None:
    """Empty the registry (and forget a decode step left open by a raise)."""
    global _in_step
    REGISTRY.clear()
    _in_step = False
