"""Fleet-wide observability (the counterpart of ``src/repro/obs``).

Three pillars, all zero-overhead when unattached and determinism-preserving
when attached (summaries bit-identical with observers on or off):

* :mod:`repro_torch.obs.trace` — request-span tracing to Chrome/Perfetto
  trace-event JSON (``EngineSpec(trace=...)`` / ``repro_torch.sim --trace``);
* :mod:`repro_torch.obs.timeline` — columnar per-edge/per-device telemetry
  timelines (``EngineSpec(timeline=...)``), plus the
  :class:`~repro_torch.obs.registry.MetricsRegistry` instrument layer that
  :class:`~repro_torch.fleet.metrics.FleetMetrics` aggregates through;
* :mod:`repro_torch.obs.profile` — simulator self-profiling (wall time per
  event kind, cache hit rates, tombstone ratio).

All of it reads virtual time or host clocks and imports neither torch nor
the card.  ``python -m repro_torch.obs report FILE`` renders either
artifact as a terminal dashboard; ``python -m repro_torch.obs validate
FILE`` is the structural trace check.
"""
from repro_torch.obs.profile import SimProfiler
from repro_torch.obs.registry import (Counter, CounterFamily, Gauge, Histogram,
                                      MetricsRegistry)
from repro_torch.obs.timeline import (DEVICE_SIGNALS, EDGE_GAUGES, Timeline,
                                      load_timeline)
from repro_torch.obs.trace import Tracer, load_trace, validate_trace

__all__ = [
    "Counter", "CounterFamily", "DEVICE_SIGNALS", "EDGE_GAUGES", "Gauge",
    "Histogram", "MetricsRegistry", "SimProfiler", "Timeline", "Tracer",
    "load_timeline", "load_trace", "validate_trace",
]
