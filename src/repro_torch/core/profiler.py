"""Layer-wise profiling harness (paper Fig. 3 + the offline stage of the
static configurator).

Times each layer of an InferenceGraph on this host and emits
:class:`ProfileRecord` rows for the regression fit.  The device/edge
asymmetry of the paper's testbed (Raspberry Pi ~ 20x slower than the
desktop) is emulated with a latency scale factor, recorded in the output.

A layer's ``run`` is a plain torch callable ``(params, x) -> x``.  PyTorch
runs eagerly and a CUDA launch returns before the card finishes, so each
timed call ends in :func:`_sync` on the tensor's device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core.graph import InferenceGraph
from repro_torch.core.latency_model import ProfileRecord

DEVICE_SLOWDOWN = 20.0  # Raspberry Pi 3 vs desktop PC (paper Sec. V-A)


@dataclass
class LayerProfile:
    name: str
    kind: str
    latency_s: float          # measured on this host ("edge" tier)
    out_bytes: int
    features: Dict[str, float]


def _sync(y) -> None:
    """Wait for the work behind ``y`` (a tensor or nested tuple/list)."""
    if isinstance(y, torch.Tensor):
        if y.is_cuda:
            torch.cuda.synchronize(y.device)
    elif isinstance(y, (tuple, list)):
        for t in y:
            _sync(t)


def _time_layer(run, params, x, repeats: int, warmup: int):
    y = x
    for _ in range(warmup):
        y = run(params, x)
        _sync(y)
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        y = run(params, x)
        _sync(y)
        ts.append(time.perf_counter() - t0)
    return y, float(np.median(ts))


@torch.no_grad()
def profile_graph(graph: InferenceGraph, params, input_x, *, repeats: int = 5,
                  warmup: int = 2) -> List[LayerProfile]:
    """Run the longest branch layer-by-layer, timing each layer."""
    profiles = []
    x = input_x
    for layer in graph.branches[-1]:
        y, lat = _time_layer(layer.run, params, x, repeats, warmup)
        profiles.append(LayerProfile(
            name=layer.name, kind=layer.kind, latency_s=lat,
            out_bytes=layer.out_bytes, features=layer.features))
        x = y
    return profiles


def profiles_to_records(profiles: Sequence[LayerProfile],
                        scale: float = 1.0) -> List[ProfileRecord]:
    return [ProfileRecord(kind=p.kind, features=p.features,
                          latency_s=p.latency_s * scale) for p in profiles]


@torch.no_grad()
def profile_all_branches(graph: InferenceGraph, params, input_x, *,
                         repeats: int = 3) -> List[LayerProfile]:
    """Profile every branch (side layers differ across branches)."""
    seen = set()
    out: List[LayerProfile] = []
    for bi in range(graph.num_exits, 0, -1):
        x = input_x
        for layer in graph.branches[bi - 1]:
            if layer.name in seen:
                x = layer.run(params, x)
                continue
            seen.add(layer.name)
            y, lat = _time_layer(layer.run, params, x, repeats, warmup=1)
            out.append(LayerProfile(layer.name, layer.kind, lat,
                                    layer.out_bytes, layer.features))
            x = y
    return out
