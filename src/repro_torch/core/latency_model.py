"""Layer-wise latency prediction (paper Table I + Sec. IV-B).

Two predictors behind one interface:

* :class:`RegressionLatencyModel` — the paper's approach verbatim: one linear
  regression per layer *type* over the Table-I independent variables, fit by
  closed-form least squares on profiled (features, latency) records.
* :class:`RooflineLatencyModel`  — the accelerator adaptation (DESIGN.md §2): no wall
  clock exists for the target hardware in this container, so per-layer latency
  = max(flops/peak_flops, bytes/hbm_bw) from the analytic counts carried by
  the InferenceGraph.

Both return seconds via ``predict(layer) -> float``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from repro_torch.config import HBM_BW, PEAK_FLOPS_BF16
from repro_torch.core.graph import GraphLayer

# feature ordering per layer type (Table I)
TABLE_I_FEATURES: Dict[str, Tuple[str, ...]] = {
    "conv": ("in_maps", "comp"),
    "relu": ("in_size",),
    "pool": ("in_size", "out_size"),
    "lrn": ("in_size",),
    "dropout": ("in_size",),
    "fc": ("in_size", "out_size"),
    "block": ("in_size", "flops"),   # LM segment granularity
}


@dataclass
class ProfileRecord:
    kind: str
    features: Dict[str, float]
    latency_s: float


class RegressionLatencyModel:
    """Per-type linear model  latency = theta . [features, 1]."""

    def __init__(self):
        self.theta: Dict[str, np.ndarray] = {}
        self.residual: Dict[str, float] = {}

    @staticmethod
    def _design(kind: str, feats: Dict[str, float]) -> np.ndarray:
        names = TABLE_I_FEATURES[kind]
        return np.array([feats.get(n, 0.0) for n in names] + [1.0])

    def fit(self, records: Iterable[ProfileRecord]) -> "RegressionLatencyModel":
        by_kind: Dict[str, List[ProfileRecord]] = {}
        for r in records:
            by_kind.setdefault(r.kind, []).append(r)
        for kind, rs in by_kind.items():
            X = np.stack([self._design(kind, r.features) for r in rs])
            y = np.array([r.latency_s for r in rs])
            theta, *_ = np.linalg.lstsq(X, y, rcond=None)
            self.theta[kind] = theta
            pred = X @ theta
            ss_res = float(np.sum((y - pred) ** 2))
            ss_tot = float(np.sum((y - y.mean()) ** 2)) or 1e-12
            self.residual[kind] = 1.0 - ss_res / ss_tot   # R^2
        return self

    def predict(self, layer: GraphLayer) -> float:
        th = self.theta.get(layer.kind)
        if th is None:
            raise KeyError(f"no regression model for layer kind {layer.kind!r}")
        return float(max(0.0, self._design(layer.kind, layer.features) @ th))

    def r2(self) -> Dict[str, float]:
        return dict(self.residual)


class RooflineLatencyModel:
    """Analytic predictor for an accelerator tier (H100 constants by
    default): latency = max(compute, memory) term.

    ``chips``: tier size; ``efficiency``: achievable fraction of peak (MFU-like
    discount, default 0.5).
    """

    def __init__(self, chips: int = 1, peak_flops: float = PEAK_FLOPS_BF16,
                 hbm_bw: float = HBM_BW, efficiency: float = 0.5):
        self.chips = chips
        self.peak = peak_flops * chips * efficiency
        self.bw = hbm_bw * chips * efficiency

    def predict(self, layer: GraphLayer) -> float:
        compute = layer.flops / self.peak
        memory = layer.bytes_moved / self.bw
        return float(max(compute, memory))


class ScaledLatencyModel:
    """Wrap any predictor with a constant speed factor (e.g. emulating the
    Raspberry-Pi : desktop asymmetry when both tiers profile on this CPU)."""

    def __init__(self, base, factor: float):
        self.base, self.factor = base, factor

    def predict(self, layer: GraphLayer) -> float:
        return self.base.predict(layer) * self.factor
