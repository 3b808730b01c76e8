"""Simulator self-profiling: where the engine's wall time actually goes.

A :class:`SimProfiler` attached to a :class:`~repro_torch.fleet.engine
.FleetEngine` times every event-handler dispatch (wall seconds and count
per event kind) and tracks the event heap's peak size.  ``report()`` folds
in the engine-side structural stats — queue tombstone ratio, the shared
:class:`~repro_torch.serving.engine.CoInferenceStepper` cache hit rates, the
mobility replanner's cache hit rates — plus the scenario build time when
the caller stamps ``build_s``.

``chip_smoke.py`` attaches one to the full-width real-decode fleet on the
card and logs its wall per event kind.  Unlike the tracer/timeline, a
profiler reads *host* clocks, so its numbers vary run to run — but it
never touches simulation state, so virtual-time results remain
bit-identical with profiling on or off.
"""
from __future__ import annotations

from typing import Dict, Optional

__all__ = ["SimProfiler"]


def _cache_block(hits: int, misses: int, entries: int) -> Dict:
    total = hits + misses
    return {"hits": hits, "misses": misses, "entries": entries,
            "hit_rate": round(hits / total, 6) if total else None}


class SimProfiler:
    def __init__(self):
        self.build_s: Optional[float] = None   # stamped by the builder;
        #                                        survives reset()
        self.reset()

    def reset(self) -> None:
        """Clear per-run accumulators (the engine calls this per run);
        ``build_s`` is construction-time metadata and is kept."""
        self.wall_by_kind: Dict[str, float] = {}
        self.count_by_kind: Dict[str, int] = {}
        self.peak_heap = 0
        self.run_wall_s = 0.0

    def add(self, kind: str, wall_s: float, heap_len: int) -> None:
        """Account one dispatched event of ``kind`` (called by the engine
        loop with the post-dispatch heap length)."""
        self.wall_by_kind[kind] = self.wall_by_kind.get(kind, 0.0) + wall_s
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1
        if heap_len > self.peak_heap:
            self.peak_heap = heap_len
        self.run_wall_s += wall_s

    def report(self, engine=None) -> Dict:
        """The ``profile`` block: per-kind wall time/counts, heap peak, and
        — given the engine — tombstone ratio and cache hit rates."""
        total = self.run_wall_s
        out: Dict = {
            "wall_s": round(total, 6),
            "peak_heap": self.peak_heap,
            "events": {
                kind: {"count": self.count_by_kind[kind],
                       "wall_s": round(self.wall_by_kind[kind], 6),
                       "wall_pct": round(
                           100.0 * self.wall_by_kind[kind] / total, 2)
                       if total > 0 else 0.0}
                for kind in sorted(self.count_by_kind)},
        }
        if self.build_s is not None:
            out["build_s"] = round(self.build_s, 6)
        if engine is not None:
            enqueued = getattr(engine, "enqueued", 0)
            tombstoned = getattr(engine, "tombstoned", 0)
            out["tombstones"] = tombstoned
            out["tombstone_ratio"] = round(tombstoned / enqueued, 6) \
                if enqueued else 0.0
            stepper = getattr(engine, "stepper", None)
            if stepper is not None and hasattr(stepper, "cache_stats"):
                out["stepper_caches"] = stepper.cache_stats()
            replanner = getattr(engine, "replanner", None)
            if replanner is not None and hasattr(replanner, "cache_stats"):
                out["replanner_caches"] = replanner.cache_stats()
        return out
