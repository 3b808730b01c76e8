"""Serving driver: ``python -m repro_torch.launch.serve --arch <id>``.

Runs the Edgent-planned two-tier serving engine: builds the LM inference
graph, arms the planner (static or dynamic configurator), streams batched
requests against a bandwidth trace, reports SLO attainment / exit
statistics — the paper's co-inference stage as a service.  The flags are the
reference's (``src/repro/launch/serve.py``) plus ``--device``.

On the card (``--device cuda``, the default) it serves the full-size config
in bfloat16 through the port's kernels; with ``--device cpu`` it serves the
smoke config in float32 through the kernels' plain versions, as the
reference does on its CPU.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import EdgentPlanner, lm_graph
from repro_torch.core.latency_model import RooflineLatencyModel
from repro_torch.data.bandwidth import belgium_lte_like, dcn_trace
from repro_torch.device import resolve
from repro_torch.models import Model
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.tiers import Link


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--slo-ms", type=float, default=400.0)
    ap.add_argument("--dynamic", action="store_true")
    ap.add_argument("--trace", default="dcn", choices=["dcn", "lte"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    on_card = device.type == "cuda"
    cfg = get_config(args.arch) if on_card else get_smoke_config(args.arch)
    dtype = torch.bfloat16 if on_card else torch.float32
    model = Model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init_params(gen, dtype=dtype, device=device)

    # tiers: edge = 8-card slice, device = 1 card; full-size graph for
    # virtual timing, the served model for token values
    graph = lm_graph(get_config(args.arch), batch=args.batch, seq=1)
    f_edge = RooflineLatencyModel(chips=8, efficiency=0.4)
    f_device = RooflineLatencyModel(chips=1, efficiency=0.4)
    planner = EdgentPlanner(graph, latency_req_s=args.slo_ms / 1e3)
    planner.with_models(f_edge, f_device)
    trace = (dcn_trace(0, 2048) if args.trace == "dcn"
             else belgium_lte_like(0, 2048))
    if args.dynamic:
        hist = [trace[i : i + 49] for i in range(0, 980, 49)]
        planner.offline_dynamic(hist)
    link = Link(trace_bps=trace)

    engine = ServingEngine(model, params, graph, planner, link,
                           batch_size=args.batch, dynamic=args.dynamic,
                           dtype=dtype)
    rs = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rs.integers(0, cfg.vocab_size, 12).astype(np.int32),
                    max_new_tokens=args.new_tokens,
                    slo_s=args.slo_ms / 1e3)
            for i in range(args.requests)]
    stats = engine.serve(reqs)
    print(f"served {cfg.name} on {device} in {dtype}")
    print("summary:", stats.summary())
    return stats


if __name__ == "__main__":
    main()
