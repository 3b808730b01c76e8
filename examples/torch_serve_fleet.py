"""Fleet serving end to end on the PyTorch port, with the real (smoke-scale)
model in the loop (the counterpart of ``examples/serve_fleet.py``).

A small fleet — 8 devices with independent LTE-like links, 2 heterogeneous
edges — serves a Poisson multi-tenant stream, wired entirely from one
declarative ``repro_torch.sim`` spec (docs/api.md).  Timing is virtual
(latency models on the event heap); token values come from actual decode
(``EngineSpec(real_decode=True)``): each admitted request carries its own
B=1 cache and steps through the per-exit variants shared fleet-wide, so
deadline demotion visibly changes which exit a request decodes through.
On the card each prefill runs the flash-attention kernel and each decode
step the decode-attention kernel; ``--device cpu`` runs their plain
versions.

Run:  PYTHONPATH=src python examples/torch_serve_fleet.py [--device cuda]
"""
import argparse

from repro_torch.device import resolve
from repro_torch.sim import (EngineSpec, RouterSpec, ScenarioSpec, Simulation,
                             TopologySpec, WorkloadSpec)

SPEC = ScenarioSpec(
    name="serve-fleet",
    description="small LTE fleet with real decode in the loop",
    seed=0,
    topology=TopologySpec(num_devices=8, num_edges=2, trace="lte",
                          edge_capacity=4, max_edge_slowdown=2.0),
    workload=WorkloadSpec(rate_hz=6.0, horizon_s=10.0, device_skew=0.5,
                          prompt_len=6),
    router=RouterSpec(name="bandwidth-aware"),
    engine=EngineSpec(real_decode=True, dtype="float32"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    sim = Simulation(SPEC, device=resolve(args.device))
    sc = sim.build()
    print(f"fleet: {sc.topo.num_devices} devices x {sc.topo.num_edges} "
          f"edges, {len(sc.workload)} requests over "
          f"{SPEC.workload.horizon_s:.0f}s (virtual)")

    metrics = sim.run()
    s = metrics.summary()

    print(f"\nSLO attainment: {s['slo_attainment']:.2%}   "
          f"p50 {s['p50_latency_s']*1e3:.1f} ms   "
          f"p99 {s['p99_latency_s']*1e3:.1f} ms")
    print(f"per tenant: {s['slo_by_tenant']}")
    print(f"edge utilization: {s['edge_utilization']}")
    print(f"exits: {s['exit_histogram']}   partitions: {s['partition_histogram']}")

    print("\n rid  tenant       dev edge  exit  latency(ms)  met  tokens")
    by_rid = {r.rid: r for r in sc.workload}
    for rec in metrics.records[:10]:
        toks = by_rid[rec.rid].tokens
        print(f"{rec.rid:4d}  {rec.tenant:<11} {rec.device:3d} {rec.edge:4d} "
              f"{rec.exit_point:5d} {rec.latency_s*1e3:12.1f}  {str(rec.met_slo):<5}"
              f"{toks}")
    return {"summary": s, "tokens": {r.rid: list(r.tokens) for r in sc.workload}}


if __name__ == "__main__":
    main()
