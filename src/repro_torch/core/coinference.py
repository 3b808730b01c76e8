"""Co-inference executor — the co-inference stage (paper Sec. IV-A).

Executes a :class:`CoInferencePlan` over an InferenceGraph across two tiers
with a bandwidth-limited link.  Tiers and link are simulated on this host
with a *virtual clock*: edge layers run at measured speed, device layers are
billed at ``device_slowdown`` x, transfers at ``bytes / bandwidth``.  The
executor returns both the result and the accounted end-to-end latency, so
experiments are reproducible and independent of host jitter.

Each layer runs twice on the input tensor's device: one warm call (which
also absorbs cuDNN's algorithm choice), then one call timed on the host's
clock, ending in a device sync.  The host wall is what the planner prices:
a layer's cost to the caller, launch overhead included.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, List, Optional

import torch

from repro_torch.core.graph import InferenceGraph
from repro_torch.core.partitioner import CoInferencePlan
from repro_torch.core.profiler import _sync


@dataclass
class CoInferenceResult:
    output: Any
    latency_s: float          # virtual end-to-end latency
    edge_s: float
    device_s: float
    transfer_s: float
    exit_point: int
    partition: int
    hops_s: float = 0.0       # inter-edge backbone transfer (k-cut plans)


@dataclass
class TwoTierExecutor:
    """Executes 1-cut plans on (edge, device) and k-cut plans on an ordered
    chain of edge tiers (``edge_slowdowns``, one per span) with inter-edge
    hand-offs billed at ``edge_bw_bps``."""
    graph: InferenceGraph
    params: Any
    bandwidth_bps: float
    device_slowdown: float = 20.0
    edge_slowdown: float = 1.0
    edge_slowdowns: Optional[List[float]] = None   # per-span, k-cut plans
    edge_bw_bps: float = 1e9                       # edge<->edge backbone

    @torch.no_grad()
    def _run_layers(self, layers, x, slowdown: float):
        total = 0.0
        for layer in layers:
            y = layer.run(self.params, x)   # warm call: time steady state
            _sync(y)
            t0 = time.perf_counter()
            y = layer.run(self.params, x)
            _sync(y)
            total += (time.perf_counter() - t0) * slowdown
            x = y
        return x, total

    def run(self, plan: CoInferencePlan, x, bandwidth_bps: Optional[float] = None
            ) -> CoInferenceResult:
        bw = bandwidth_bps or self.bandwidth_bps
        branch = self.graph.branches[plan.exit_point - 1]
        p = plan.partition
        transfer = 0.0
        if p > 0:
            transfer += self.graph.input_bytes / bw
            transfer += self.graph.cut_bytes(plan.exit_point, p) / bw
        cuts = plan.all_cuts
        slowdowns = self.edge_slowdowns if self.edge_slowdowns is not None \
            else [self.edge_slowdown] * len(cuts)
        x_edge, t_edge, hops = x, 0.0, 0.0
        start = 0
        for i, cut in enumerate(cuts):
            span = branch[start:min(cut, len(branch))]
            x_edge, dt = self._run_layers(span, x_edge, slowdowns[i])
            t_edge += dt
            if i < len(cuts) - 1:
                hops += self.graph.cut_bytes(plan.exit_point, cut) / \
                    self.edge_bw_bps
            start = cut
        out, t_dev = self._run_layers(branch[p:], x_edge, self.device_slowdown)
        return CoInferenceResult(
            output=out, latency_s=t_edge + t_dev + transfer + hops,
            edge_s=t_edge, device_s=t_dev, transfer_s=transfer,
            exit_point=plan.exit_point, partition=p, hops_s=hops)
