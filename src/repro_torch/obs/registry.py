"""Counter / gauge / histogram instruments and their registry.

The primitive layer of ``repro_torch.obs``: tiny, dependency-free instruments
that the rest of the stack aggregates through.  ``FleetMetrics`` keeps its
running aggregates in these (replacing the ad-hoc ``_handover_count``-style
private ints it used to carry), and anything else that wants a named
counter — cache stats, profilers, future autoscalers — registers it here so
``snapshot()`` can export everything at once.

Design constraints (the determinism contract, docs/observability.md):

* Instruments are *passive* — they never read clocks or RNG, so feeding
  them from the event loop cannot perturb a simulation.
* ``Histogram`` retains its raw samples: summaries need *exact* percentiles
  (``np.percentile`` over the full sample vector) to stay bit-identical
  with the pre-registry implementation, so there is no bucketing.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

__all__ = ["Counter", "CounterFamily", "Gauge", "Histogram",
           "MetricsRegistry"]

Number = Union[int, float]


class Counter:
    """Monotonic count (``inc`` only)."""
    __slots__ = ("name", "value")

    def __init__(self, name: str = ""):
        self.name = name
        self.value = 0

    def inc(self, n: Number = 1) -> None:
        self.value += n

    def __repr__(self) -> str:
        return f"Counter({self.name!r}, value={self.value!r})"


class Gauge:
    """Last-write-wins scalar (``set``)."""
    __slots__ = ("name", "value")

    def __init__(self, name: str = ""):
        self.name = name
        self.value: Number = 0

    def set(self, v: Number) -> None:
        self.value = v

    def __repr__(self) -> str:
        return f"Gauge({self.name!r}, value={self.value!r})"


class Histogram:
    """Sample-retaining distribution: exact percentiles and the pairwise
    ``np.mean``, bit-identical to computing over a plain list (~16 bytes per
    observation, the price of exactness)."""
    __slots__ = ("name", "samples")

    def __init__(self, name: str = ""):
        self.name = name
        self.samples: List[float] = []

    def observe(self, v: float) -> None:
        self.samples.append(v)

    @property
    def count(self) -> int:
        return len(self.samples)

    def percentile(self, q: float) -> Optional[float]:
        if not self.samples:
            return None
        return float(np.percentile(np.array(self.samples), q))

    def mean(self) -> Optional[float]:
        if not self.samples:
            return None
        return float(np.mean(np.array(self.samples)))

    def __repr__(self) -> str:
        return f"Histogram({self.name!r}, count={self.count})"


class CounterFamily:
    """A labeled set of counters (one count per label) — histograms over
    discrete keys like exit points, partitions, or tenant names."""
    __slots__ = ("name", "_counts")

    def __init__(self, name: str = ""):
        self.name = name
        self._counts: Dict = {}

    def inc(self, label, n: Number = 1) -> None:
        self._counts[label] = self._counts.get(label, 0) + n

    def get(self, label, default: Number = 0) -> Number:
        return self._counts.get(label, default)

    def items(self) -> Iterator[Tuple[object, Number]]:
        return iter(self._counts.items())

    def as_dict(self) -> Dict:
        """Label -> count, in sorted label order (summary()-stable)."""
        return dict(sorted(self._counts.items()))

    def __len__(self) -> int:
        return len(self._counts)

    def __contains__(self, label) -> bool:
        return label in self._counts

    def __repr__(self) -> str:
        return f"CounterFamily({self.name!r}, labels={len(self)})"


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram,
          "family": CounterFamily}


class MetricsRegistry:
    """Named instruments with get-or-create semantics.

    Asking twice for the same name returns the same instrument; asking for
    an existing name as a different kind raises (catching the silent-shadow
    bug where two subsystems fight over one name)."""

    def __init__(self):
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls):
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = cls(name)
        elif type(inst) is not cls:
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, not {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def family(self, name: str) -> CounterFamily:
        return self._get(name, CounterFamily)

    def names(self) -> List[str]:
        return list(self._instruments)

    def __contains__(self, name: str) -> bool:
        return name in self._instruments

    def clear(self) -> None:
        """Drop every instrument."""
        self._instruments.clear()

    def snapshot(self) -> Dict:
        """Export every instrument's current state as plain data (counters/
        gauges -> value, families -> sorted dict, histograms -> count/mean/
        p50/p95/p99)."""
        out: Dict = {}
        for name, inst in self._instruments.items():
            if isinstance(inst, (Counter, Gauge)):
                out[name] = inst.value
            elif isinstance(inst, CounterFamily):
                out[name] = inst.as_dict()
            else:
                out[name] = {"count": inst.count, "mean": inst.mean(),
                             "p50": inst.percentile(50),
                             "p95": inst.percentile(95),
                             "p99": inst.percentile(99)}
        return out
