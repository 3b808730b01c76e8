"""Bandwidth trace generators reproducing the statistics of the paper's
datasets (neither ships offline):

* ``oboe_like_traces``   — Sec. V-C: 428 synthetic traces of 49 download
  chunks each, piecewise-stationary, state means spanning 0..6 Mbps; each
  trace's mean is one *bandwidth state* for the configuration map.
* ``belgium_lte_like``   — HTTP/2 4G/LTE mobility logs (van der Hooft et al.):
  mobility-segmented trace with mode-dependent mean/variance, scaled into
  0..10 Mbps as the paper does.
* ``dcn_trace``          — datacenter adaptation: inter-pod link GB/s with
  congestion episodes (used by the LM serving experiments).

All values are bytes/s.
"""
from __future__ import annotations

from typing import List

import numpy as np

MBPS = 1e6 / 8  # bytes/s


def oboe_like_traces(seed: int = 0, num: int = 428, chunks: int = 49,
                     lo_mbps: float = 0.05, hi_mbps: float = 6.0
                     ) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    traces = []
    means = np.linspace(lo_mbps, hi_mbps, num)
    rng.shuffle(means)
    for m in means:
        segs = rng.integers(1, 4)
        bounds = sorted(rng.choice(np.arange(5, chunks - 1), segs - 1, replace=False)) \
            if segs > 1 else []
        levels = np.clip(rng.normal(m, 0.15 * m + 0.02, segs), 0.01, hi_mbps)
        trace = np.empty(chunks)
        prev = 0
        for lvl, b in zip(levels, list(bounds) + [chunks]):
            trace[prev:b] = np.clip(rng.normal(lvl, 0.05 * lvl + 0.01, b - prev), 0.01, hi_mbps)
            prev = b
        traces.append(trace * MBPS)
    return traces


def belgium_lte_like(seed: int = 0, length: int = 600, transport: str = "bus",
                     hi_mbps: float = 10.0) -> np.ndarray:
    """Mobility trace: piecewise segments (stops, moving, handovers) with
    mode-dependent statistics, scaled to [0, hi_mbps] (paper Sec. V-C)."""
    params = {
        "foot": (6.0, 0.8, 40), "bicycle": (5.0, 1.2, 30),
        "bus": (4.0, 1.8, 25), "train": (3.0, 2.5, 15), "car": (5.0, 2.0, 20),
    }[transport]
    mean, vol, seg_len = params
    rng = np.random.default_rng(seed)
    out = np.empty(length)
    t = 0
    level = mean
    while t < length:
        n = int(rng.integers(seg_len // 2, seg_len * 2))
        level = float(np.clip(rng.normal(mean, vol), 0.2, hi_mbps))
        seg = np.clip(rng.normal(level, 0.15 * level, n), 0.05, hi_mbps)
        out[t : t + n] = seg[: length - t]
        t += n
    return out * MBPS


def dcn_trace(seed: int = 0, length: int = 600, base_gbps: float = 400.0,
              congested_gbps: float = 40.0) -> np.ndarray:
    """Inter-pod DCN bandwidth with congestion episodes (bytes/s)."""
    rng = np.random.default_rng(seed)
    out = np.full(length, base_gbps)
    t = 0
    while t < length:
        t += int(rng.integers(40, 120))
        dur = int(rng.integers(10, 60))
        out[t : t + dur] = congested_gbps * rng.uniform(0.5, 2.0)
        t += dur
    noise = rng.normal(1.0, 0.05, length)
    return np.clip(out * noise, 1.0, None) * 1e9 / 8
