"""Two-tier serving topology: a weak 'device' tier and a strong 'edge' tier
joined by a bandwidth-limited link — the paper's testbed, datacenter-scaled.

Tiers bill virtual time from a latency model (RooflineLatencyModel at accelerator
scale, RegressionLatencyModel when profiled); the link bills bytes/bandwidth
with the current trace value.  This keeps experiments deterministic and
host-independent while the *token values* come from real model execution.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np


@dataclass
class Link:
    """Bandwidth-limited link fed by a trace (bytes/s per step index)."""
    trace_bps: np.ndarray
    idx: int = 0

    def current(self) -> float:
        return float(self.trace_bps[min(self.idx, len(self.trace_bps) - 1)])

    def advance(self):
        self.idx += 1

    def transfer_s(self, nbytes: float) -> float:
        return nbytes / max(self.current(), 1.0)


@dataclass
class Tier:
    name: str
    latency_model: object                  # .predict(GraphLayer) -> seconds

    def time_layers(self, layers) -> float:
        return sum(self.latency_model.predict(l) for l in layers)
