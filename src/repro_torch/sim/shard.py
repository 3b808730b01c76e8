"""Geography-sharded fleet simulation (the counterpart of
``src/repro/sim/shard.py``).

``TopologySpec.shards = k`` declares the fleet as ``k`` disjoint geography
*tiles*: tile ``g`` owns ``num_edges/k`` edges and ``num_devices/k``
devices, sampled from its own derived seed, with all ids offset into the
fleet-global namespace (edges ``g*M_t ..``, devices ``g*N_t ..``, request
ids ``g*RID_STRIDE ..``).  Reachability is block-diagonal — a tile's
devices route, cooperate, and hand over only within the tile — so each
tile is an independent discrete-event simulation, and a sharded run is
embarrassingly parallel across worker processes.

The merge is the virtual-time barrier: every tile's metric stream carries
its append times (:class:`~repro_torch.fleet.metrics.FleetMetrics.finish_keys`
/ ``handover_at``), and :meth:`FleetMetrics.merged` replays the per-tile
streams in (virtual time, tile index) order.  Because the spec *defines*
the tiling, a sharded run (``processes=k``) and an unsharded run of the
same spec (``processes=1``, or plain ``Simulation(spec).run()``) execute
the identical per-tile event loops and the identical merge — summaries and
handover logs are bit-identical (pinned by tests/test_torch_shard.py).

    spec = replace(get_scenario("smoke-mobility"), ...)   # shards=8
    metrics = run_sharded(spec, processes=8)              # -> FleetMetrics

Sharded runs are timing-only (real decode is refused, as the reference
refuses it), so a tile builds no model and touches no device.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

from repro_torch.fleet.cluster import make_fleet
from repro_torch.fleet.engine import FleetEngine
from repro_torch.fleet.metrics import FleetMetrics
from repro_torch.fleet.mobility import HandoverController, make_mobile_fleet
from repro_torch.fleet.workload import make_workload
from repro_torch.sim.build import build_stack, engine_dtype
from repro_torch.sim.spec import ScenarioSpec

__all__ = ["run_sharded", "run_sharded_info", "run_tile", "tile_spec"]

# seed stride between tiles: tiles draw from disjoint seed lanes (tile 0
# keeps the spec's own seed, so a shards=1 spec is unchanged)
TILE_SEED_STRIDE = 100_003
# request-id namespace per tile: rids stay unique fleet-wide
RID_STRIDE = 10 ** 9


def _check_shardable(spec: ScenarioSpec):
    if spec.topology.shards < 2:
        raise ValueError(
            f"spec {spec.name!r} has topology.shards="
            f"{spec.topology.shards}: nothing to shard")
    if spec.engine.trace is not None or spec.engine.timeline is not None:
        raise ValueError(
            "sharded runs do not support engine.trace / engine.timeline "
            "observers (each tile would write its own partial artifact); "
            "run the spec with shards=1 to attach them")
    if spec.engine.real_decode:
        raise ValueError(
            "sharded runs do not support engine.real_decode (each tile "
            "would build its own model replica and produce per-tile token "
            "streams the merge does not carry); run the spec with shards=1 "
            "for real decode, or real_decode=False to shard")


def tile_spec(spec: ScenarioSpec, g: int) -> ScenarioSpec:
    """The per-tile scenario: tile ``g``'s share of the fleet as a
    standalone ``shards=1`` spec with its derived seed and its absolute
    slice of the arrival rate.  (Offsets into the global id namespace are
    *not* spec fields — :func:`run_tile` threads them into the builders.)"""
    k = spec.topology.shards
    topo = dataclasses.replace(
        spec.topology, shards=1,
        num_devices=spec.topology.num_devices // k,
        num_edges=spec.topology.num_edges // k)
    # resolve against the *fleet* size first, then split evenly: both
    # rate_hz and rate_per_device_hz forms land on the same per-tile rate
    rate = spec.workload.resolve_rate_hz(spec.topology.num_devices) / k
    workload = dataclasses.replace(spec.workload, rate_hz=rate,
                                   rate_per_device_hz=None)
    return dataclasses.replace(
        spec, name=f"{spec.name}/tile{g}", topology=topo, workload=workload,
        seed=spec.seed + g * TILE_SEED_STRIDE)


def run_tile(spec: ScenarioSpec, g: int) -> Tuple[FleetMetrics, Dict]:
    """Build and run one geography tile to completion.  Returns the tile's
    metrics plus run info (event counts — measurement metadata, not part of
    the determinism contract)."""
    k = spec.topology.shards
    tspec = tile_spec(spec, g)
    t = tspec.topology
    eid0 = g * t.num_edges
    did0 = g * t.num_devices
    seeds = tspec.seeds()
    sc = build_stack(tspec.planner, with_model=tspec.engine.real_decode,
                     scenario_spec=tspec)
    if t.kind == "static":
        topo = make_fleet(
            t.num_devices, t.num_edges, seed=seeds.topology, trace=t.trace,
            edge_capacity=t.edge_capacity, hetero_edges=t.hetero_edges,
            max_edge_slowdown=t.max_edge_slowdown,
            device_slowdown_range=t.device_slowdown_range,
            lo_mbps=t.lo_mbps, hi_mbps=t.hi_mbps, trace_len=t.trace_len,
            edge_bw_mbps=t.edge_bw_mbps, eid0=eid0, did0=did0)
        mobility = None
    else:
        topo, mobility = make_mobile_fleet(
            t.num_devices, t.num_edges, seed=seeds.topology, speed=t.speed,
            horizon_s=t.horizon_s, area=t.area,
            edge_capacity=t.edge_capacity, hetero_edges=t.hetero_edges,
            max_edge_slowdown=t.max_edge_slowdown,
            device_slowdown_range=t.device_slowdown_range,
            peak_mbps=t.peak_mbps, floor_mbps=t.floor_mbps,
            d_ref=t.d_ref, path_exp=t.path_exp,
            noise_sigma=t.noise_sigma, noise_dt=t.noise_dt,
            edge_bw_mbps=t.edge_bw_mbps, eid0=eid0, did0=did0)
    handover = None
    if tspec.mobility is not None and tspec.mobility.policy != "none":
        if mobility is None:
            raise ValueError(
                f"spec {spec.name!r} sets a handover policy but its "
                "topology is static: mobility policies need "
                "TopologySpec(kind='mobile')")
        m = tspec.mobility
        handover = HandoverController(
            mobility, policy=m.policy, sample_dt=m.sample_dt,
            hazard=m.hazard, hysteresis=m.hysteresis, min_gap_s=m.min_gap_s)
    w = tspec.workload
    vocab = sc.cfg.vocab_size \
        if (w.sample_prompts or tspec.engine.real_decode) else 0
    workload = make_workload(
        t.num_devices, rate_hz=w.resolve_rate_hz(t.num_devices),
        horizon_s=w.horizon_s, seed=seeds.workload, arrival=w.arrival,
        tenants=w.tenants, device_skew=w.device_skew,
        peak_factor=w.peak_factor, period_s=w.period_s,
        prompt_len=w.prompt_len, vocab_size=vocab,
        rid0=g * RID_STRIDE, did0=did0)
    autoscaler = admission = None
    if tspec.autoscale is not None or tspec.admission is not None:
        from repro_torch.fleet.elastic import build_elasticity
        autoscaler, admission = build_elasticity(
            tspec.autoscale, tspec.admission, graph=sc.graph,
            planner=sc.planner, latency_req_s=tspec.planner.latency_req_s,
            ref_chips=t.edge_capacity)
    engine = FleetEngine(
        topo, sc.graph, sc.planner, router=tspec.router.name,
        model=sc.model, params=sc.params, dynamic=tspec.engine.dynamic,
        dtype=engine_dtype(tspec.engine.dtype),
        demote_on_deadline=tspec.engine.demote_on_deadline,
        prefill_div=tspec.engine.prefill_div, mobility=mobility,
        handover=handover, replan_max_coop=tspec.engine.replan_max_coop,
        max_coop=tspec.router.max_coop,
        retain_records=tspec.engine.retain_records,
        autoscaler=autoscaler, admission=admission,
        batch_decode=tspec.engine.batch_decode,
        shard_decode=tspec.engine.shard_decode)
    metrics = engine.run(workload)
    info = {"tile": g, "shards": k,
            "events_processed": engine.events_processed,
            "event_counts": dict(sorted(engine.event_counts.items())),
            "compactions": engine.compactions,
            "requests": len(workload)}
    return metrics, info


def _run_tile_json(payload: str) -> Tuple[FleetMetrics, Dict]:
    spec_json, g = json.loads(payload)
    return run_tile(ScenarioSpec.from_json(spec_json), g)


def run_sharded_info(spec: ScenarioSpec, *,
                     processes: Optional[int] = None
                     ) -> Tuple[FleetMetrics, Dict]:
    """Run every tile of a ``shards=k`` spec and merge (metrics, info).

    ``processes`` > 1 fans tiles out over a spawn-context worker pool (the
    ``repro_torch.sim.sweep`` skeleton — no fork: a forked child cannot use
    the parent's CUDA context); otherwise tiles run sequentially in this
    process.  Either way the result is bit-identical: per-tile event loops
    are deterministic in the tile spec, and :meth:`FleetMetrics.merged` is
    deterministic in the per-tile streams."""
    _check_shardable(spec)
    k = spec.topology.shards
    parts: List[Optional[FleetMetrics]] = [None] * k
    infos: List[Optional[Dict]] = [None] * k
    if processes is not None and processes > 1:
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        payload = [json.dumps([spec.to_json(), g]) for g in range(k)]
        with ctx.Pool(min(processes, k)) as pool:
            for g, (m, info) in enumerate(pool.imap(_run_tile_json,
                                                    payload)):
                parts[g], infos[g] = m, info
    else:
        for g in range(k):
            parts[g], infos[g] = run_tile(spec, g)
    merged = FleetMetrics.merged(parts, num_edges=spec.topology.num_edges)
    by_kind: Dict[str, int] = {}
    for info in infos:
        for kind, n in info["event_counts"].items():
            by_kind[kind] = by_kind.get(kind, 0) + n
    info = {"shards": k,
            "events_processed": sum(i["events_processed"] for i in infos),
            "event_counts": dict(sorted(by_kind.items())),
            "compactions": sum(i["compactions"] for i in infos),
            "requests": sum(i["requests"] for i in infos),
            "tiles": infos}
    return merged, info


def run_sharded(spec: ScenarioSpec, *,
                processes: Optional[int] = None) -> FleetMetrics:
    """:func:`run_sharded_info` without the info dict — the
    ``Simulation(spec).run()`` equivalent for sharded specs."""
    return run_sharded_info(spec, processes=processes)[0]
