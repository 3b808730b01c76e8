"""The measurement artifact: serializable timing samples.

A :class:`CalibrationTable` is the interchange format between the three
calibration stages (measure -> fit -> validate) and the scenario layer
(``ScenarioSpec.calibration.table`` names a saved one).  Like
``repro_torch.sim.spec`` it is plain data with strict field checking: unknown
keys raise ``ValueError`` on the way in, and
``table.to_dict() == json.loads(json.dumps(table.to_dict()))`` — the JSON
round-trip is lossless and canonical (pinned by tests/test_calib.py).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["CalibrationTable", "TimingSample"]

#: sample phases a table may carry (measure emits all four for LM targets)
PHASES = ("layer", "prefill", "decode", "head")


def _check_fields(cls, d: Dict):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(
            f"unknown {cls.__name__} field(s) {sorted(unknown)}: "
            f"expected a subset of {sorted(names)}")


@dataclass
class TimingSample:
    """One median-of-k wall-clock measurement.

    ``phase`` says what was timed: a single ``layer`` (Table-I granularity,
    the branchy-alexnet path), one ``decode`` step of branch ``exit_point``
    at ``batch`` co-located requests, a ``prefill`` of ``seq`` tokens, or
    one exit ``head`` (logits projection).  ``kind`` is the Table-I layer
    type for ``layer`` samples (``conv``/``relu``/...; ``block`` per-segment
    for LMs) and empty otherwise.  ``features`` carries the regression
    features of whatever was timed — for branch-level phases the fitter
    reconstructs per-layer designs from the graph instead."""
    phase: str
    latency_s: float
    kind: str = ""
    features: Dict[str, float] = field(default_factory=dict)
    exit_point: Optional[int] = None
    batch: int = 1
    seq: int = 1
    reps: int = 1

    def __post_init__(self):
        if self.phase not in PHASES:
            raise ValueError(f"unknown sample phase {self.phase!r}: "
                             f"expected one of {PHASES}")
        if self.latency_s < 0.0:
            raise ValueError(
                f"latency_s must be >= 0, got {self.latency_s}")

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "TimingSample":
        _check_fields(cls, d)
        return cls(**d)


@dataclass
class CalibrationTable:
    """A batch of :class:`TimingSample` rows plus provenance.

    ``arch`` names what was measured (a smoke-config arch or
    ``branchy-alexnet``); ``source`` how (``measure_lm`` /
    ``measure_alexnet`` / ``synthetic`` in tests); ``meta`` free-form
    measurement metadata (host, sweep axes, repeat counts)."""
    arch: str
    source: str = "measure"
    samples: List[TimingSample] = field(default_factory=list)
    meta: Dict = field(default_factory=dict)

    def __post_init__(self):
        self.samples = [TimingSample.from_dict(s) if isinstance(s, dict)
                        else s for s in self.samples]

    # ------------------------------------------------------------ queries
    def by_phase(self, phase: str) -> List[TimingSample]:
        if phase not in PHASES:
            raise ValueError(f"unknown sample phase {phase!r}: "
                             f"expected one of {PHASES}")
        return [s for s in self.samples if s.phase == phase]

    def exits(self) -> List[int]:
        return sorted({s.exit_point for s in self.samples
                       if s.exit_point is not None})

    # ------------------------------------------------------------ round-trip
    def to_dict(self) -> Dict:
        return {"arch": self.arch, "source": self.source,
                "samples": [s.to_dict() for s in self.samples],
                "meta": self.meta}

    @classmethod
    def from_dict(cls, d: Dict) -> "CalibrationTable":
        _check_fields(cls, d)
        return cls(**d)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "CalibrationTable":
        return cls.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "CalibrationTable":
        with open(path) as f:
            return cls.from_json(f.read())
