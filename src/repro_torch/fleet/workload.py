"""Fleet workload generators: arrival processes + multi-tenant SLO mix.

Arrivals are Poisson (constant rate) or diurnal (sinusoidal rate, generated
by thinning), stamped onto devices either uniformly or with a power-law skew
(a few hot devices produce most of the traffic).  Each request draws a
tenant class fixing its SLO and decode length.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class TenantClass:
    name: str
    slo_s: float
    max_new_tokens: int
    weight: float


DEFAULT_TENANTS = (
    TenantClass("interactive", slo_s=0.25, max_new_tokens=4, weight=0.5),
    TenantClass("standard", slo_s=1.0, max_new_tokens=8, weight=0.35),
    TenantClass("batch", slo_s=4.0, max_new_tokens=16, weight=0.15),
)


@dataclass(eq=False)
class FleetRequest:
    """One request in a fleet simulation: identity + SLO contract up top,
    engine-owned runtime state below (reset by every ``FleetEngine.run``).

    ``eq=False``: requests are unique live objects — membership tests and
    removals on engine queues are identity checks, not field-by-field
    comparisons (which sat on the hot path and are ambiguous once ``prompt``
    holds an array)."""
    rid: int
    device: int
    tenant: str
    slo_s: float
    max_new_tokens: int
    arrival_s: float
    prompt_len: int = 8
    prompt: Optional[np.ndarray] = None
    # --- runtime state (owned by FleetEngine) ---
    edge: int = -1
    assign: object = None        # CoopAssignment for multi-edge plans
    admitted_s: Optional[float] = None
    tokens_done: int = 0
    prefill_pending: bool = True
    plan: object = None
    exit_point: int = 0
    cache: object = None
    next_tok: object = None
    tokens: List[int] = field(default_factory=list)
    # --- mobility / handover state (docs/handover.md) ---
    replan_pending: bool = False  # policy fired; resolve at round boundary
    migrating: bool = False       # state snapshot in flight on the backbone
    coop_counted: bool = False    # holds coop_inflight slots at secondaries
    handovers: int = 0            # completed mid-request migrations
    migrated_bytes: int = 0       # state bytes shipped across all handovers

    @property
    def deadline_s(self) -> float:
        return self.arrival_s + self.slo_s


def poisson_arrivals(rate_hz: float, horizon_s: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Homogeneous Poisson arrival times on [0, horizon)."""
    if rate_hz <= 0:
        return np.empty(0)
    n = rng.poisson(rate_hz * horizon_s)
    return np.sort(rng.uniform(0.0, horizon_s, n))


def diurnal_rate(t_s: float, base_hz: float, peak_hz: float,
                 period_s: float) -> float:
    """Sinusoidal day curve: base at t=0, peak at half period."""
    phase = 0.5 * (1.0 - np.cos(2.0 * np.pi * t_s / period_s))
    return base_hz + (peak_hz - base_hz) * phase


def diurnal_arrivals(base_hz: float, peak_hz: float, period_s: float,
                     horizon_s: float, rng: np.random.Generator) -> np.ndarray:
    """Inhomogeneous Poisson arrivals by thinning against ``peak_hz``.

    ``diurnal_rate`` is pure ufunc math, so evaluating it on the whole
    candidate vector is bit-identical to the per-candidate scalar loop."""
    cand = poisson_arrivals(peak_hz, horizon_s, rng)
    keep = rng.uniform(0.0, 1.0, len(cand)) * peak_hz <= \
        diurnal_rate(cand, base_hz, peak_hz, period_s)
    return cand[keep]


def make_workload(num_devices: int, *, rate_hz: float, horizon_s: float,
                  seed: int = 0, arrival: str = "poisson",
                  tenants: Sequence[TenantClass] = DEFAULT_TENANTS,
                  device_skew: float = 0.0, peak_factor: float = 4.0,
                  period_s: Optional[float] = None, prompt_len: int = 8,
                  vocab_size: int = 0, rid0: int = 0,
                  did0: int = 0) -> List[FleetRequest]:
    """Generate the request stream for one simulation.

    ``rate_hz`` is the *fleet-wide* mean arrival rate.  ``device_skew`` > 0
    concentrates traffic on low-index devices with p(i) ~ (i+1)^-skew.
    ``vocab_size`` > 0 additionally samples real token prompts (needed only
    when the fleet engine executes the actual model).  ``rid0``/``did0``
    offset request and device ids into a fleet-global namespace — geography
    tiles (repro_torch.sim.shard) generate their own streams with disjoint ids.
    """
    rng = np.random.default_rng(seed)
    if arrival == "poisson":
        times = poisson_arrivals(rate_hz, horizon_s, rng)
    elif arrival == "diurnal":
        period = period_s if period_s is not None else horizon_s
        base = 2.0 * rate_hz / (1.0 + peak_factor)
        times = diurnal_arrivals(base, base * peak_factor, period,
                                 horizon_s, rng)
    else:
        raise ValueError(f"unknown arrival process: {arrival!r}")

    dev_w = (np.arange(num_devices) + 1.0) ** -device_skew
    dev_w /= dev_w.sum()
    ten_w = np.array([t.weight for t in tenants], float)
    ten_w /= ten_w.sum()

    # Inverse-CDF sampling with the cumulative weights built once.  Each
    # draw consumes exactly one uniform double and lands on the same index
    # as ``rng.choice(n, p=w)`` (which rebuilds the O(n) CDF per call —
    # the build-time bottleneck at 10k+ devices), so request streams are
    # bit-identical to the per-call form.
    dev_cdf = np.cumsum(dev_w)
    dev_cdf /= dev_cdf[-1]
    ten_cdf = np.cumsum(ten_w)
    ten_cdf /= ten_cdf[-1]
    n_ten = len(tenants)

    reqs: List[FleetRequest] = []
    times_l = times.tolist()
    for rid, t in enumerate(times_l):
        dev = min(int(dev_cdf.searchsorted(rng.random(), side="right")),
                  num_devices - 1)
        ten = tenants[min(int(ten_cdf.searchsorted(rng.random(),
                                                   side="right")), n_ten - 1)]
        prompt = rng.integers(0, vocab_size, prompt_len).astype(np.int32) \
            if vocab_size > 0 else None
        reqs.append(FleetRequest(
            rid=rid0 + rid, device=did0 + dev, tenant=ten.name,
            slo_s=ten.slo_s,
            max_new_tokens=ten.max_new_tokens, arrival_s=t,
            prompt_len=prompt_len, prompt=prompt))
    return reqs
