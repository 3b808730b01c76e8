"""The paper's dynamic-environment workflow on the PyTorch port, end to end
(the counterpart of ``examples/serve_dynamic_bandwidth.py``):

  1. offline: sketch 428 bandwidth states from Oboe-like traces, build the
     configuration map (Algorithm 2);
  2. online: BOCD change-point detection over a Belgium-LTE-like mobility
     trace drives map lookups (Algorithm 3);
  3. co-inference: each plan is executed on the simulated two-tier testbed.

Run:  PYTHONPATH=src python examples/torch_serve_dynamic_bandwidth.py [--device cuda]
"""
import argparse

import torch

from repro_torch.core import EdgentPlanner, alexnet_graph
from repro_torch.core.coinference import TwoTierExecutor
from repro_torch.data.bandwidth import MBPS, belgium_lte_like, oboe_like_traces
from repro_torch.device import resolve
from repro_torch.models.alexnet import BranchyAlexNet, BranchyAlexNetConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    net = BranchyAlexNet(BranchyAlexNetConfig())
    params = net.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    graph = alexnet_graph(net)
    x = torch.randn((1, 32, 32, 3), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)

    planner = EdgentPlanner(graph, latency_req_s=1.0)
    planner.offline_static(params, x)
    traces = oboe_like_traces(seed=0, num=428)
    planner.offline_dynamic([t.tolist() for t in traces])
    print(f"configuration map: {len(planner.dynamic_opt.cmap)} bandwidth states")

    lte = belgium_lte_like(seed=3, length=120, transport="bus", hi_mbps=10.0)
    executor = TwoTierExecutor(graph, params, bandwidth_bps=1.0,
                               device_slowdown=planner.device_factor,
                               edge_slowdown=planner.edge_factor)
    print("\n t   bw(Mbps)  state(Mbps)  exit  partition  latency(ms)  in-SLO")
    met = 0
    for t, bw in enumerate(lte):
        plan = planner.plan(bw, dynamic=True)
        res = executor.run(plan, x, bandwidth_bps=bw)
        ok = res.latency_s <= planner.latency_req_s
        met += ok
        if t % 10 == 0:
            state = planner.dynamic_opt.state / MBPS
            print(f"{t:3d}  {bw / MBPS:7.2f}  {state:10.2f}  {plan.exit_point:4d} "
                  f"{plan.partition:9d}  {res.latency_s * 1e3:10.1f}  {ok}")
    print(f"\nSLO attainment: {met}/{len(lte)} "
          f"({100 * met / len(lte):.1f}%)  "
          f"state transitions: {planner.dynamic_opt.transitions}")
    return {"states": len(planner.dynamic_opt.cmap),
            "transitions": planner.dynamic_opt.transitions, "met": met, "steps": len(lte)}


if __name__ == "__main__":
    main()
