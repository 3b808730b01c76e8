"""Algorithm 2 — Configuration Map Construction (dynamic environment).

For each bandwidth state (sketched from historical traces, Oboe-style
piecewise-stationary segments) evaluate every co-inference strategy
C_j = (exit point, partition point) with the reward of Eq. (1):

    reward = exp(acc) + throughput   if t_step <= t_req
             0                        otherwise

and record argmax_j in the map.  The map is the *dynamic configuration*
consumed by Algorithm 3 at the online stage.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import InferenceGraph
from repro_torch.core.partitioner import branch_latency


@dataclass
class MapEntry:
    exit_point: int
    partition: int
    reward: float
    latency_s: float
    accuracy: float


def reward_fn(accuracy: float, latency_s: float, latency_req_s: float) -> float:
    """Eq. (1).  throughput = 1 / t_step."""
    if latency_s > latency_req_s or latency_s <= 0:
        return 0.0
    return math.exp(accuracy) + 1.0 / latency_s


def sketch_states(traces: Sequence[Sequence[float]]) -> List[float]:
    """Oboe-style state sketching (paper Sec. V-C): each trace contributes
    the mean of its chunk bandwidths as one piecewise-stationary state."""
    return sorted(float(np.mean(np.asarray(t))) for t in traces if len(t))


def build_map(graph: InferenceGraph, f_edge, f_device,
              states_bps: Sequence[float], latency_req_s: float
              ) -> Dict[float, MapEntry]:
    """Algorithm 2: exhaustive reward search per bandwidth state."""
    cmap: Dict[float, MapEntry] = {}
    for s in states_bps:
        best: Optional[MapEntry] = None
        for i in range(1, graph.num_exits + 1):
            n = len(graph.branches[i - 1])
            for p in range(n + 1):
                lat = branch_latency(graph, i, p, f_edge, f_device, s)
                r = reward_fn(graph.accuracy[i - 1], lat, latency_req_s)
                if best is None or r >= best.reward:
                    best = MapEntry(i, p, r, lat, graph.accuracy[i - 1])
        cmap[float(s)] = best
    return cmap


def lookup(cmap: Dict[float, MapEntry], state_bps: float) -> MapEntry:
    """find(state): nearest recorded bandwidth state (paper Sec. IV-C)."""
    keys = np.array(sorted(cmap))
    idx = int(np.argmin(np.abs(keys - state_bps)))
    return cmap[float(keys[idx])]
