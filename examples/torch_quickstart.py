"""Quickstart: Edgent end-to-end on the PyTorch port (the counterpart of
``examples/quickstart.py``).

Builds the paper's branchy AlexNet, profiles it, fits the Table-I latency
regressions, then asks the planner for co-inference plans across bandwidths
and executes one plan on the simulated two-tier testbed.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cuda]
"""
import argparse

import torch

from repro_torch.core import EdgentPlanner, alexnet_graph
from repro_torch.core.coinference import TwoTierExecutor
from repro_torch.device import resolve
from repro_torch.models.alexnet import BranchyAlexNet, BranchyAlexNetConfig

KBPS = 125  # bytes/s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    # 1. the branchy model (5 exit points, paper Fig. 4)
    net = BranchyAlexNet(BranchyAlexNetConfig())
    params = net.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    graph = alexnet_graph(net)
    print(f"model: {graph.name}, branches: "
          f"{[len(b) for b in graph.branches]} layers")

    # 2. offline configuration: profile + fit per-layer-type regressions
    x = torch.randn((1, 32, 32, 3), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    planner = EdgentPlanner(graph, latency_req_s=1.0)
    planner.offline_static(params, x)
    print(f"tier calibration: edge x{planner.edge_factor:.1f}, "
          f"device x{planner.device_factor:.0f} (paper Fig. 2 endpoints)")
    print(f"regression R^2 per layer type: "
          f"{ {k: round(v, 3) for k, v in planner.f_edge.r2().items()} }")

    # 3. online tuning: the joint (exit, partition) plan per bandwidth
    print("\nbandwidth -> plan (SLO = 1000 ms):")
    plans = {}
    for kbps in (50, 100, 250, 500, 1000):
        plan = plans[kbps] = planner.plan(kbps * KBPS)
        print(f"  {kbps:5d} kbps: exit={plan.exit_point} "
              f"partition={plan.partition:2d} "
              f"latency={plan.latency_s * 1e3:7.1f} ms "
              f"acc={plan.accuracy:.2f} feasible={plan.feasible}")

    # 4. co-inference stage: execute the plan across the two tiers
    plan = planner.plan(500 * KBPS)
    executor = TwoTierExecutor(graph, params, bandwidth_bps=500 * KBPS,
                               device_slowdown=planner.device_factor,
                               edge_slowdown=planner.edge_factor)
    res = executor.run(plan, x)
    print(f"\nco-inference: exit={res.exit_point} partition={res.partition} "
          f"edge={res.edge_s * 1e3:.1f}ms device={res.device_s * 1e3:.1f}ms "
          f"transfer={res.transfer_s * 1e3:.1f}ms -> logits {tuple(res.output.shape)}")
    return {"planner": planner, "plans": plans, "result": res}


if __name__ == "__main__":
    main()
