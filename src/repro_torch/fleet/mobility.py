"""Device mobility over a 2-D edge geography (docs/handover.md).

The static fleet gives each device a *time-indexed* bandwidth trace that is
independent of which edge serves it.  This module makes bandwidth a function
of **position**: edges sit at fixed coordinates, devices follow
random-waypoint trajectories, and the wireless rate to each edge follows a
path-loss curve of the device<->edge distance.  A moving device therefore
sees its link to the serving edge *degrade as it walks away* — the dynamic
environment of the paper (Sec. IV-C), realized at fleet scale.

Three pieces:

* :class:`Trajectory` / :func:`random_trajectory` — piecewise-linear
  random-waypoint motion at a configurable speed (area units / s).
* :class:`MobilityModel` — edge positions + device trajectories + the
  position->bandwidth law ``bw(d) = peak / (1 + (d / d_ref)^path_exp)``
  with deterministic per-device multiplicative noise; exposes per-pair
  ``bw(did, eid, t)``, ``distance``, and ``nearest``.
* :class:`HandoverController` — decides *when* a device's in-flight work
  should be re-planned: ``oracle`` watches the geometry directly (fires when
  a strictly nearer edge appears, with hysteresis), ``bocd`` runs the
  paper's Bayesian online change-point detector (`repro_torch.core.bocd`) on the
  bandwidth samples the device actually observes and fires on a detected
  state transition (Algorithm 3 lifted to the fleet), ``none`` never fires.

The controller only raises the flag; the migration itself (state snapshot,
backbone billing, re-binding) is executed by
:class:`~repro_torch.fleet.engine.FleetEngine` using
:meth:`~repro_torch.fleet.joint.JointPlanner.replan` — see docs/handover.md.
"""
from __future__ import annotations

import math
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.bocd import BandwidthStateDetector, BOCDBank
from repro_torch.core.graph import InferenceGraph
from repro_torch.fleet.cluster import DeviceNode, EdgeNode, FleetTopology

MBPS = 1e6 / 8  # bytes/s


@dataclass
class Trajectory:
    """Piecewise-linear position over time: waypoint ``points[i]`` is reached
    at ``times_s[i]``; the position is clamped to the endpoints outside the
    waypoint interval (a device that ran out of waypoints parks)."""
    times_s: np.ndarray          # [K] ascending, times_s[0] == 0
    points: np.ndarray           # [K, 2]

    def pos(self, t_s: float) -> np.ndarray:
        return np.array(self.pos_xy(t_s))

    def pos_xy(self, t_s: float) -> Tuple[float, float]:
        """Scalar hot path: the same interpolation as the ndarray ``pos``
        over cached plain-float waypoint lists (``bisect`` instead of
        ``searchsorted``, identical float64 arithmetic per component)."""
        times = getattr(self, "_times_l", None)
        if times is None:
            times = self._times_l = [float(v) for v in self.times_s]
            self._pts_l = [(float(p[0]), float(p[1])) for p in self.points]
        pts = self._pts_l
        t = float(t_s)
        if t <= times[0] or len(times) == 1:
            return pts[0]
        if t >= times[-1]:
            return pts[-1]
        i = bisect_right(times, t)
        t0, t1 = times[i - 1], times[i]
        w = (t - t0) / max(t1 - t0, 1e-12)
        x0, y0 = pts[i - 1]
        x1, y1 = pts[i]
        return (1.0 - w) * x0 + w * x1, (1.0 - w) * y0 + w * y1


def random_trajectory(rng: np.random.Generator, speed: float,
                      horizon_s: float, area: float = 1.0) -> Trajectory:
    """Random-waypoint motion: start uniformly in ``[0, area]^2``, walk to
    i.i.d. uniform waypoints at constant ``speed`` until the horizon is
    covered.  ``speed <= 0`` yields a stationary device."""
    start = rng.uniform(0.0, area, 2)
    if speed <= 0.0:
        return Trajectory(np.zeros(1), start[None, :])
    times, pts = [0.0], [start]
    while times[-1] < horizon_s:
        nxt = rng.uniform(0.0, area, 2)
        # scalar hypot == np.linalg.norm's 2-vector reduction, bitwise
        dx = float(nxt[0]) - float(pts[-1][0])
        dy = float(nxt[1]) - float(pts[-1][1])
        d = math.sqrt(dx * dx + dy * dy)
        if d < 1e-9:
            continue
        times.append(times[-1] + d / speed)
        pts.append(nxt)
    return Trajectory(np.asarray(times), np.stack(pts))


@dataclass
class MobilityModel:
    """Edge geography + device trajectories + the position->bandwidth law.

    ``bw(did, eid, t) = peak_bps / (1 + (d / d_ref)^path_exp) * noise``,
    floored at ``floor_bps``.  The noise is a pre-drawn per-(device, time
    slot) multiplicative grid so that two runs of the same seed observe the
    identical bandwidth history (the fleet determinism contract).

    ``eid0``/``did0`` make the model *tile-capable* (repro_torch.sim.shard): a
    sharded run hands each geography tile its own model covering only that
    tile's edges and devices, with ids offset into the fleet-global
    namespace.  Scalar APIs (``bw``, ``distance``, ``nearest``) speak
    global ids; the row/matrix APIs (``distance_row``, ``bw_row``,
    ``distances_at``, ``bw_matrix``) stay tile-local-indexed — callers
    offset columns by ``eid0`` (as :class:`~repro_torch.fleet.joint.JointPlanner`
    does with ``topo.eid0``)."""
    edge_pos: np.ndarray                     # [M, 2]
    trajectories: List[Trajectory]           # one per device
    peak_bps: float = 6.0 * MBPS
    floor_bps: float = 0.05 * MBPS
    d_ref: float = 0.25                      # distance at which bw halves
    path_exp: float = 3.0
    noise: Optional[np.ndarray] = None       # [N, T] multiplicative
    noise_dt: float = 0.5
    eid0: int = 0                            # first global edge id
    did0: int = 0                            # first global device id

    def pos(self, did: int, t_s: float) -> np.ndarray:
        return self.trajectories[did - self.did0].pos(t_s)

    def _edge_xy(self) -> List[Tuple[float, float]]:
        xy = getattr(self, "_edge_xy_l", None)
        if xy is None:
            xy = self._edge_xy_l = [(float(p[0]), float(p[1]))
                                    for p in self.edge_pos]
        return xy

    def distance(self, did: int, eid: int, t_s: float) -> float:
        # sqrt(dx*dx + dy*dy): the exact reduction np.linalg.norm applies
        # to a 2-vector, without building one
        x, y = self.trajectories[did - self.did0].pos_xy(t_s)
        ex, ey = self._edge_xy()[eid - self.eid0]
        dx, dy = x - ex, y - ey
        return math.sqrt(dx * dx + dy * dy)

    def bw(self, did: int, eid: int, t_s: float) -> float:
        d = self.distance(did, eid, t_s)
        raw = self.peak_bps / (1.0 + (d / self.d_ref) ** self.path_exp)
        if self.noise is not None:
            slot = min(max(int(t_s / self.noise_dt), 0),
                       self.noise.shape[1] - 1)
            raw *= float(self.noise[did - self.did0, slot])
        return max(raw, self.floor_bps)

    # ----------------------------------------------- spatial nearest-edge
    # A uniform grid over the edge positions answers nearest() by expanding
    # ring search instead of an O(M) scan.  Bit-identical to
    # argmin(distance_row): per-candidate distances use the same scalar
    # sqrt(dx*dx+dy*dy) as distance() (== np.sqrt per element), ties break
    # on the lowest edge index ((d, i) lexicographic — argmin's
    # first-minimum), and rings keep expanding while a tie at the ring's
    # lower bound is still possible (<= , not <).

    def _grid(self):
        g = getattr(self, "_grid_t", None)
        if g is None:
            xy = self._edge_xy()
            m = len(xy)
            gdim = max(1, int(math.sqrt(m)))
            minx = min(p[0] for p in xy)
            miny = min(p[1] for p in xy)
            ext = max(max(p[0] for p in xy) - minx,
                      max(p[1] for p in xy) - miny)
            cs = ext / gdim if ext > 0.0 else 1.0
            cells: List[List[int]] = [[] for _ in range(gdim * gdim)]
            for i, (x, y) in enumerate(xy):
                cx = min(int((x - minx) / cs), gdim - 1)
                cy = min(int((y - miny) / cs), gdim - 1)
                cells[cy * gdim + cx].append(i)  # ascending i per cell
            self._grid_t = g = (gdim, minx, miny, cs, cells)
        return g

    def _nearest_xy(self, x: float, y: float) -> int:
        """Tile-local index of the edge closest to ``(x, y)``; exact
        argmin-equivalent (see the block comment above)."""
        gdim, minx, miny, cs, cells = self._grid()
        xy = self._edge_xy()
        cx = min(max(int((x - minx) / cs), 0), gdim - 1)
        cy = min(max(int((y - miny) / cs), 0), gdim - 1)
        best_d = math.inf
        best_i = -1
        max_r = max(cx, cy, gdim - 1 - cx, gdim - 1 - cy)
        for r in range(max_r + 1):
            # any edge in ring r is >= (r-1)*cs away (axis separation); a
            # strictly greater bound cannot beat OR tie the incumbent
            if best_i >= 0 and (r - 1) * cs > best_d:
                break
            x0, x1 = max(cx - r, 0), min(cx + r, gdim - 1)
            y0, y1 = max(cy - r, 0), min(cy + r, gdim - 1)
            for gy in range(y0, y1 + 1):
                on_rim_y = gy == cy - r or gy == cy + r
                for gx in range(x0, x1 + 1):
                    if r and not on_rim_y and gx != cx - r and gx != cx + r:
                        continue            # interior: scanned by ring < r
                    for i in cells[gy * gdim + gx]:
                        ex, ey = xy[i]
                        dx, dy = x - ex, y - ey
                        d = math.sqrt(dx * dx + dy * dy)
                        if d < best_d or (d == best_d and i < best_i):
                            best_d, best_i = d, i
        return best_i

    def nearest(self, did: int, t_s: float) -> int:
        """Closest edge, as a *global* eid (deterministic tie-break on the
        lowest eid — the first minimum ``argmin`` would take over
        :meth:`distance_row`), answered by the spatial grid in O(1)-ish."""
        x, y = self.trajectories[did - self.did0].pos_xy(t_s)
        return self.eid0 + self._nearest_xy(x, y)

    def nearest_bruteforce(self, did: int, t_s: float) -> int:
        """Reference O(M) nearest (the pre-grid implementation); the
        equivalence tests pin ``nearest == nearest_bruteforce`` everywhere,
        including exact-tie geometries."""
        row = self.distance_row(did, t_s)
        return self.eid0 + int(np.argmin(row))  # first minimum

    def distance_row(self, did: int, t_s: float) -> np.ndarray:
        """One device's distance to every edge (tile-local ``[M]``), entry
        ``e`` == ``distance(did, eid0 + e, t_s)`` bitwise — the replanner's
        nearest-first candidate ordering reads this instead of M scalar
        calls."""
        x, y = self.trajectories[did - self.did0].pos_xy(t_s)
        dx = x - self.edge_pos[:, 0]
        dy = y - self.edge_pos[:, 1]
        return np.sqrt(dx * dx + dy * dy)

    def bw_row(self, did: int, t_s: float) -> np.ndarray:
        """One device's bandwidth to every edge (tile-local ``[M]``), entry
        ``e`` == ``bw(did, eid0 + e, t_s)`` bitwise — this row prices
        *replans*, so it must match the engine's scalar billing exactly;
        the ``**`` runs through scalar pow per edge because numpy's SIMD
        pow can differ from it in the last ulp (see :meth:`bw_matrix`)."""
        d = self.distance_row(did, t_s)
        noise = 1.0
        if self.noise is not None:
            slot = min(max(int(t_s / self.noise_dt), 0),
                       self.noise.shape[1] - 1)
            noise = float(self.noise[did - self.did0, slot])
        peak, d_ref, exp_ = self.peak_bps, self.d_ref, self.path_exp
        out = np.empty(len(d))
        for e in range(len(d)):
            raw = peak / (1.0 + (float(d[e]) / d_ref) ** exp_)
            if self.noise is not None:
                raw *= noise
            out[e] = max(raw, self.floor_bps)
        return out

    # ------------------------------------------------- vectorized (per slot)
    # The sampling sweep evaluates every device-edge pair once per time
    # slot.  These batched paths apply the *same elementwise float64 ops*
    # as pos()/distance()/bw() above, so each matrix entry is bit-identical
    # to the corresponding scalar call (pinned by
    # tests/test_fleet_perf.py::test_vectorized_mobility_matches_scalar) —
    # they only drop the per-call Python and tiny-ndarray overhead.

    def _pos_tables(self):
        """Trajectory waypoints padded into rectangular arrays (cached):
        ``(times [N, K] padded +inf, points [N, K, 2] padded with the last
        waypoint, valid counts [N], last valid time [N])``."""
        tabs = getattr(self, "_ptabs", None)
        if tabs is None:
            n = len(self.trajectories)
            kv = np.array([len(tr.times_s) for tr in self.trajectories])
            k = max(int(kv.max()), 2)
            times = np.full((n, k), np.inf)
            pts = np.empty((n, k, 2))
            for i, tr in enumerate(self.trajectories):
                ki = len(tr.times_s)
                times[i, :ki] = tr.times_s
                pts[i, :ki] = tr.points
                pts[i, ki:] = tr.points[-1]
            t_last = np.array([tr.times_s[-1] for tr in self.trajectories])
            self._ptabs = tabs = (times, pts, kv, t_last)
        return tabs

    def positions_at(self, t_s: float) -> np.ndarray:
        """All device positions at one instant: ``[N, 2]``, row ``d`` ==
        ``pos(d, t_s)`` bitwise."""
        t = float(t_s)
        times, pts, kv, t_last = self._pos_tables()
        n = len(kv)
        rows = np.arange(n)
        # count of waypoint times <= t == searchsorted(times, t, "right");
        # +inf padding never counts.  Clamp into the valid interior so the
        # gathers stay in-bounds; boundary rows are overwritten below.
        i = np.clip((times <= t).sum(axis=1), 1, np.maximum(kv - 1, 1))
        t0, t1 = times[rows, i - 1], times[rows, i]
        p0, p1 = pts[rows, i - 1], pts[rows, i]
        w = (t - t0) / np.maximum(t1 - t0, 1e-12)
        out = (1.0 - w)[:, None] * p0 + w[:, None] * p1
        first = (t <= times[:, 0]) | (kv == 1)
        last = t >= t_last
        return np.where(first[:, None], pts[:, 0],
                        np.where(last[:, None],
                                 pts[rows, np.maximum(kv - 1, 0)], out))

    def distances_at(self, t_s: float) -> np.ndarray:
        """Device-edge distance matrix ``[N, M]`` at one instant; entry
        ``(d, e)`` == ``distance(d, e, t_s)`` bitwise."""
        p = self.positions_at(t_s)
        dx = p[:, 0][:, None] - self.edge_pos[:, 0][None, :]
        dy = p[:, 1][:, None] - self.edge_pos[:, 1][None, :]
        return np.sqrt(dx * dx + dy * dy)

    def bw_matrix(self, t_s: float) -> np.ndarray:
        """Device-edge bandwidth matrix ``[N, M]`` at one instant (the
        path-loss law over :meth:`distances_at`).

        Entry ``(d, e)`` equals ``bw(d, e, t_s)`` up to 1 ulp: numpy's
        vectorized ``**`` may round differently from scalar ``pow`` in the
        last bit (everything else — interpolation, distances, noise, floor
        — is bit-exact; tests/test_fleet_perf.py pins the tolerance).  The
        matrix only feeds the handover policies' *observations* (BOCD
        samples, which are threshold decisions), never latency billing;
        both paths are individually deterministic, and the registry
        scenarios' metrics are pinned bit-identical to the pre-vectorized
        engine."""
        d = self.distances_at(t_s)
        raw = self.peak_bps / (1.0 + (d / self.d_ref) ** self.path_exp)
        if self.noise is not None:
            slot = min(max(int(t_s / self.noise_dt), 0),
                       self.noise.shape[1] - 1)
            raw = raw * self.noise[:, slot][:, None]
        return np.maximum(raw, self.floor_bps)


@dataclass
class MobileLink:
    """Drop-in for :class:`~repro_torch.fleet.cluster.TraceLink` under mobility:
    ``bw_at(t)`` reports the *best available* signal (the nearest edge's
    rate), which is what a placement-only router should shop with.  The
    per-serving-edge rate — the one decode rounds are actually billed at —
    comes from ``MobilityModel.bw`` via ``FleetEngine._bw``."""
    model: MobilityModel
    did: int

    def bw_at(self, t_s: float) -> float:
        return self.model.bw(self.did, self.model.nearest(self.did, t_s), t_s)


def edge_grid(num_edges: int, area: float = 1.0) -> np.ndarray:
    """Deterministic edge placement: cell centers of the smallest square grid
    covering ``num_edges`` sites over ``[0, area]^2``."""
    g = int(np.ceil(np.sqrt(num_edges)))
    pos = [((i % g + 0.5) / g * area, (i // g + 0.5) / g * area)
           for i in range(num_edges)]
    return np.asarray(pos)


def migration_bytes(graph: InferenceGraph, exit_point: int, partition: int,
                    tokens: int) -> int:
    """State that must ship when the edge span ``[0, partition)`` of branch
    ``exit_point`` moves to another edge mid-request: per-token attention
    state approximated as 2x (K and V) the activation width at every layer
    boundary inside the span, times the tokens processed so far, plus any
    explicit recurrent state the graph declares (``GraphLayer.state_bytes``,
    which is token-count independent)."""
    if partition <= 0 or tokens <= 0:
        return 0
    branch = graph.branches[exit_point - 1]
    p = min(partition, len(branch))
    per_token = sum(2 * lay.out_bytes for lay in branch[:p])
    state = sum(lay.state_bytes for lay in branch[:p])
    return int(per_token * tokens + state)


class HandoverController:
    """When should device ``did`` re-plan its in-flight work?

    * ``none``   — never (static binding; the no-handover baseline).
    * ``oracle`` — fires whenever some *serving* edge (an edge currently
      hosting one of the device's in-flight requests) has a strictly nearer
      alternative by the ``hysteresis`` margin: a geometry oracle, the
      upper reference in ``benchmarks/fleet_scale.py --mobility``.
    * ``bocd``   — feeds the bandwidth the device observes on its most
      at-risk serving link (the farthest serving edge) to a per-device
      :class:`~repro_torch.core.bocd.BandwidthStateDetector` (sampled every
      ``sample_dt`` seconds of virtual time) and fires on a detected change
      point, rate-limited by ``min_gap_s`` — the paper's Algorithm 3
      trigger driving fleet-level migration.

    The controller is *stateful per run*; :meth:`reset` restores a clean
    slate so one engine can be re-run deterministically.
    """

    POLICIES = ("none", "oracle", "bocd")

    def __init__(self, mobility: MobilityModel, policy: str = "bocd", *,
                 sample_dt: float = 0.5, hazard: float = 1 / 20.0,
                 hysteresis: float = 0.05, min_gap_s: float = 1.0):
        if policy not in self.POLICIES:
            raise ValueError(f"unknown handover policy {policy!r}: expected "
                             f"one of {', '.join(self.POLICIES)}")
        self.mobility = mobility
        self.policy = policy
        self.sample_dt = sample_dt
        self.hazard = hazard
        self.hysteresis = hysteresis
        self.min_gap_s = min_gap_s
        self.reset()

    def reset(self):
        self.detectors: Dict[int, BandwidthStateDetector] = {}
        self.bank: Optional[BOCDBank] = None
        self._last_fire: Dict[int, float] = {}

    # ------------------------------------------------------------ engine API
    def observe(self, did: int, now: float,
                serving: Tuple[int, ...] = ()) -> bool:
        """One bandwidth sample at virtual time ``now``; ``serving`` lists
        the distinct edges currently hosting this device's in-flight
        requests (a device with several concurrent requests may be bound to
        several).  True => the engine should re-plan the device's in-flight
        work.

        This is the one-device path (lazy per-device detectors); the engine
        drives the fleet through :meth:`observe_sweep` instead, which updates
        every detector in one batched step.  Do not mix the two in one run —
        the sweep's :class:`~repro_torch.core.bocd.BOCDBank` and the lazy
        ``detectors`` dict are separate state."""
        if self.policy == "none":
            return False
        if self.policy == "oracle":
            if not serving:
                return False
            near = self.mobility.nearest(did, now)
            d_near = self.mobility.distance(did, near, now)
            fire = any(
                eid != near and d_near <= (1.0 - self.hysteresis) *
                self.mobility.distance(did, eid, now)
                for eid in serving)
        else:
            # bocd: sample the most at-risk link the device is actually
            # using (the farthest serving edge — the one whose degradation
            # is hurting in-flight work), falling back to the best signal
            # while idle so the detector's history stays contiguous; a state
            # transition is a MAP run-length collapse (a new entry in the
            # detector's change log, NOT its float return — that is the
            # posterior state mean)
            if serving:
                eid = max(serving, key=lambda e:
                          (self.mobility.distance(did, e, now), e))
            else:
                eid = self.mobility.nearest(did, now)
            det = self.detectors.get(did)
            if det is None:
                det = self.detectors[did] = BandwidthStateDetector(
                    hazard=self.hazard)
            n_before = len(det.changes)
            det.update(self.mobility.bw(did, eid, now) / MBPS)
            fire = len(det.changes) > n_before and bool(serving)
        if not fire:
            return False
        return self._rate_limit(did, now)

    def _rate_limit(self, did: int, now: float) -> bool:
        # rate-limit both policies: while a condition persists (a nearer
        # edge exists but replan keeps deciding to stay put), re-searching
        # every sample is wasted compute
        last = self._last_fire.get(did)
        if last is not None and now - last < self.min_gap_s:
            return False
        self._last_fire[did] = now
        return True

    def observe_sweep(self, now: float, servings: List[Tuple[int, ...]],
                      dist: np.ndarray, bw: np.ndarray) -> List[int]:
        """One tick of the whole fleet's sampling grid: ``servings[did]``
        lists the edges serving device ``did``; ``dist``/``bw`` are this
        slot's :meth:`MobilityModel.distances_at` /
        :meth:`MobilityModel.bw_matrix` matrices.  Returns the devices whose
        in-flight work should re-plan, in ascending id order — exactly the
        devices (and order) the per-device :meth:`observe` grid would have
        fired, with all BOCD posteriors advanced in one
        :class:`~repro_torch.core.bocd.BOCDBank` step instead of a Python loop."""
        if self.policy == "none":
            return []
        n = len(servings)
        # servings/dist/bw are tile-local-indexed; serving eids and the
        # fired device ids are global (the engine replans by global did)
        e0, d0 = self.mobility.eid0, self.mobility.did0
        fired: List[int] = []
        if self.policy == "oracle":
            near = dist.argmin(axis=1)          # first minimum per row
            for did, serving in enumerate(servings):
                if not serving:
                    continue
                nr = int(near[did])
                d_near = float(dist[did, nr])
                if any(eid - e0 != nr and d_near <=
                       (1.0 - self.hysteresis) * float(dist[did, eid - e0])
                       for eid in serving) and \
                        self._rate_limit(did + d0, now):
                    fired.append(did + d0)
            return fired
        # bocd: one bank row per device, all rows updated in lockstep (the
        # engine samples every device on the same grid, so run lengths agree)
        if self.bank is None:
            self.bank = BOCDBank(n, hazard=self.hazard)
        near = dist.argmin(axis=1)
        # idle devices sample their best signal (vectorized gather); only
        # devices with in-flight work pick a serving link in Python
        xs = bw[np.arange(n), near]
        has_serving = np.zeros(n, dtype=bool)
        for did, serving in enumerate(servings):
            if serving:
                eid = max(serving,
                          key=lambda e: (float(dist[did, e - e0]), e))
                has_serving[did] = True
                xs[did] = bw[did, eid - e0]
        changed = self.bank.update(xs / MBPS) & has_serving
        for did in np.flatnonzero(changed):
            if self._rate_limit(int(did) + d0, now):
                fired.append(int(did) + d0)
        return fired


def make_mobile_fleet(num_devices: int, num_edges: int, *, seed: int = 0,
                      speed: float = 0.1, horizon_s: float = 60.0,
                      area: float = 1.0, edge_capacity: int = 8,
                      hetero_edges: bool = True,
                      max_edge_slowdown: float = 3.0,
                      device_slowdown_range=(0.8, 2.5),
                      peak_mbps: float = 6.0, floor_mbps: float = 0.05,
                      d_ref: float = 0.25, path_exp: float = 3.0,
                      noise_sigma: float = 0.1, noise_dt: float = 0.5,
                      edge_bw_mbps: float = 400.0,
                      eid0: int = 0, did0: int = 0
                      ) -> Tuple[FleetTopology, MobilityModel]:
    """Sample a reproducible *mobile* fleet: edges on a grid over
    ``[0, area]^2``, devices on random-waypoint trajectories at ``speed``
    (jittered +/-50% per device), per-pair bandwidth from the path-loss law.
    Device links are :class:`MobileLink`s so placement-only routers keep
    working unchanged.  ``eid0``/``did0`` offset all ids into a
    fleet-global namespace for geography-sharded runs (repro_torch.sim.shard)."""
    rng = np.random.default_rng(seed)
    pos = edge_grid(num_edges, area)
    trajs = [random_trajectory(rng, speed * float(rng.uniform(0.5, 1.5)),
                               horizon_s, area)
             for _ in range(num_devices)]
    slots = max(int(np.ceil(horizon_s / noise_dt)) + 1, 1)
    noise = np.clip(rng.normal(1.0, noise_sigma,
                               (num_devices, slots)), 0.3, 1.7) \
        if noise_sigma > 0 else None
    mobility = MobilityModel(edge_pos=pos, trajectories=trajs,
                             peak_bps=peak_mbps * MBPS,
                             floor_bps=floor_mbps * MBPS,
                             d_ref=d_ref, path_exp=path_exp,
                             noise=noise, noise_dt=noise_dt,
                             eid0=eid0, did0=did0)
    lo, hi = device_slowdown_range
    # one batched draw == num_devices sequential scalar uniforms, bitwise
    slowdowns = rng.uniform(lo, hi, num_devices)
    devices = [DeviceNode(did0 + i, MobileLink(mobility, did0 + i),
                          slowdown=s)
               for i, s in enumerate(slowdowns.tolist())]
    speeds = np.linspace(1.0, max_edge_slowdown, num_edges) if hetero_edges \
        else np.ones(num_edges)
    edges = [EdgeNode(eid0 + j, capacity=edge_capacity,
                      speed=float(speeds[j]))
             for j in range(num_edges)]
    topo = FleetTopology(devices, edges, edge_bw_bps=edge_bw_mbps * 125e3)
    return topo, mobility
