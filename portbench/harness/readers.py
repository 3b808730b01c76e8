"""Arithmetic the metric readers share.  A reader that finds nothing to read
returns None, and the harness leaves its metric out of the line."""
from __future__ import annotations

from typing import Optional

from portbench.harness import peaks


def spans(run, kind):
    return [s for s in run.trace.spans if s.kind == kind] if run.trace else []


def roofline(run, kind) -> Optional[float]:
    """Percent: the least time the calls of kernel wrapper ``kind`` could take
    (operations over the compute peak or bytes over HBM, the larger, call by
    call), over the device time of the kernels launched inside those calls."""
    if run.trace is None:
        return None
    calls = [c for c in run.trace.ops if c.kind == kind and c.kernels]
    dev = sum(c.device_s for c in calls)
    if not calls or dev <= 0:
        return None
    least = sum(peaks.least_seconds(c.flops, c.nbytes, c.elt) for c in calls)
    return 100.0 * least / dev
