"""Fleet-wide observability (the counterpart of ``src/repro/obs``).

This slice ports the instrument layer,
:class:`~repro_torch.obs.registry.MetricsRegistry`, that
:class:`~repro_torch.fleet.metrics.FleetMetrics` aggregates through.  The
tracer, the timeline, the report and the simulator profiler wait for a
later slice (``ROADMAP.md``).
"""
from repro_torch.obs.registry import (Counter, CounterFamily, Gauge,  # noqa: F401
                                      Histogram, MetricsRegistry)

__all__ = ["Counter", "CounterFamily", "Gauge", "Histogram", "MetricsRegistry"]
