"""Edgent's right-sizing, re-derived in plain Python from the configuration.

The model's segments (early exits evenly spaced in depth, aligned to the hybrid's
period), the per-segment cost model of the planner's graph (forward FLOPs and
weight bytes of one decode token for the whole batch, on roofline tiers),
Algorithm 1's plan (the deepest exit whose best edge/device partition meets the
planner's SLO, else the fastest), and the serving engine's deadline demotion
before each decode step against the batch's tightest SLO on its virtual clock.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12


def exit_layers(num_layers: int, num_exits: int) -> List[int]:
    return [max(1, round(num_layers * (i + 1) / (num_exits + 1))) for i in range(num_exits)]


def segment_lengths(cfg: dict) -> List[int]:
    """Layers (Mamba-2 blocks for the hybrid) in each segment between exits."""
    L = cfg["num_layers"]
    unit = cfg["hybrid_attn_period"] if cfg["family"] == "hybrid" else 1
    bounds: List[int] = []
    for li in exit_layers(L, cfg["num_exits"]):
        if unit > 1:
            b = min(max(unit, max(unit, int(round(li / unit)) * unit)), L - unit)
        else:
            b = min(max(1, round(li)), L - 1)
        if b not in bounds:
            bounds.append(b)
    edges = [0] + sorted(bounds) + [L]
    return [b - a for a, b in zip(edges[:-1], edges[1:])]


@dataclass
class Layer:
    flops: float
    nbytes: float
    out_bytes: float
    state_bytes: float = 0.0


def _per_unit(cfg: dict) -> float:
    d, H, KV, hd = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    if cfg["family"] == "hybrid":
        di, n = 2 * d, cfg["ssm_state"]
        return d * (2 * di + 2 * n + di // cfg["ssm_head_dim"]) + di * d + 4 * di
    return d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * cfg["d_ff"]


def branches(cfg: dict, batch: int) -> List[List[Layer]]:
    """The planner's graph: branch e runs segments [0, e) and exit head e."""
    d = cfg["d_model"]
    act = batch * d * 2
    pu = _per_unit(cfg)
    segs = []
    for n in segment_lengths(cfg):
        flops = 2.0 * pu * batch * n + n * 2.0 * 2.0 * batch / 2 * cfg["num_heads"] * cfg["head_dim"]
        state = 0.0
        if cfg["family"] == "hybrid":
            state = n * batch * (2 * d // cfg["ssm_head_dim"]) * cfg["ssm_state"] * cfg["ssm_head_dim"] * 4
        segs.append(Layer(flops, float(pu * n * 2), act, state))
    head = Layer(2.0 * batch * d * cfg["vocab_size"], float(cfg["vocab_size"] * d * 2), batch * 8)
    return [segs[:i] + [head] for i in range(1, len(segs) + 1)]


class Tiers:
    def __init__(self, cfg: dict, batch: int):
        dep = cfg["deployment"]
        eff = dep["efficiency"]
        self.edge = (PEAK_FLOPS * dep["edge_chips"] * eff, HBM_BW * dep["edge_chips"] * eff)
        self.device = (PEAK_FLOPS * dep["device_chips"] * eff, HBM_BW * dep["device_chips"] * eff)
        self.branches = branches(cfg, batch)
        self.input_bytes, self.result_bytes = batch * 4, batch * 8

    @staticmethod
    def _t(tier, layer: Layer) -> float:
        return max(layer.flops / tier[0], layer.nbytes / tier[1])

    def latency(self, e: int, p: int, bw: float) -> float:
        br = self.branches[e - 1]
        t = 0.0
        if p > 0:
            t += self.input_bytes / bw
            cut = self.result_bytes if p >= len(br) else br[p - 1].out_bytes + br[p - 1].state_bytes
            t += cut / bw
        for j, layer in enumerate(br):
            t += self._t(self.edge if j < p else self.device, layer)
        return t

    def best_partition(self, e: int, bw: float) -> Tuple[int, float]:
        best = (0, float("inf"))
        for p in range(len(self.branches[e - 1]) + 1):
            lat = self.latency(e, p, bw)
            if lat < best[1]:
                best = (p, lat)
        return best

    def plan(self, bw: float, slo_s: float) -> Tuple[int, int]:
        """(exit, partition) of Algorithm 1, or the fastest plan when none meets."""
        for e in range(len(self.branches), 0, -1):
            p, lat = self.best_partition(e, bw)
            if lat <= slo_s:
                return e, p
        best = None
        for e in range(1, len(self.branches) + 1):
            p, lat = self.best_partition(e, bw)
            if best is None or lat < best[2]:
                best = (e, p, lat)
        return best[0], best[1]


def pick_exit(remaining: float, per_exit: Sequence[float], tokens_left: int,
              preferred: int) -> int:
    for e in range(preferred, 0, -1):
        if per_exit[e - 1] * tokens_left <= remaining:
            return e
    return 1


def batch_exits(tiers: Tiers, planner_slo_s: float, prompt_len: int, steps: int,
                budget_s: float, trace: Sequence[float], link_idx: int) -> List[int]:
    """The exit of each decode step of one batch: ``prompt_len`` its padded length,
    ``steps`` its decode steps, ``budget_s`` its tightest SLO, the link at index
    ``link_idx`` of ``trace`` when it starts (one step a decode step)."""
    def bw(i):
        return float(trace[min(i, len(trace) - 1)])

    e0, p = tiers.plan(bw(link_idx), planner_slo_s)
    clock = tiers.latency(e0, p, bw(link_idx)) * max(1, prompt_len // 8)
    out = []
    for step in range(steps):
        b = bw(link_idx + step)
        per_exit = [tiers.latency(e, p, b) for e in range(1, len(tiers.branches) + 1)]
        e = pick_exit(budget_s - clock, per_exit, steps - step, e0)
        out.append(e)
        clock += tiers.latency(e, p, b)
    return out
