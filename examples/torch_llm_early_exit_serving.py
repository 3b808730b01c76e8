"""The paper's technique at LM scale on the PyTorch port (the counterpart of
``examples/llm_early_exit_serving.py``): batched requests against a
multi-exit llama-style model, the Edgent planner choosing (exit point,
partition) per bandwidth state, deadline demotion as straggler mitigation,
fused exit-head confidence on every decode step.

On the card the prefill runs the flash-attention kernel, every decode step
the decode-attention kernel, and every token comes from the fused exit-head
kernel (``src/repro_torch/kernels/csrc``); ``--device cpu`` runs their plain
versions.

Run:  PYTHONPATH=src python examples/torch_llm_early_exit_serving.py [--dynamic] [--device cuda]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import EdgentPlanner, lm_graph
from repro_torch.core.latency_model import RooflineLatencyModel
from repro_torch.data.bandwidth import dcn_trace
from repro_torch.device import resolve
from repro_torch.kernels.exit_head import ops as exit_ops
from repro_torch.models import Model
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.tiers import Link


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--slo-ms", type=float, default=300.0)
    ap.add_argument("--dynamic", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    cfg = get_smoke_config(args.arch)
    model = Model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dtype=torch.float32, device=dev)
    print(f"arch {cfg.name}: {model.num_segments} segments "
          f"(exit heads between them)")

    # datacenter tiers: 8-chip edge slice vs 1-chip device slice.
    # The planner's graph carries the FULL-size architecture (virtual
    # timing); the smoke model executes the actual tokens.
    graph = lm_graph(get_config(args.arch), batch=4, seq=1)
    planner = EdgentPlanner(graph, latency_req_s=args.slo_ms / 1e3)
    planner.with_models(RooflineLatencyModel(chips=8, efficiency=0.4),
                        RooflineLatencyModel(chips=1, efficiency=0.4))
    trace = dcn_trace(0, 4096)
    if args.dynamic:
        hist = [trace[i:i + 49] for i in range(0, 2450, 49)]
        planner.offline_dynamic(hist)

    engine = ServingEngine(model, params, graph, planner, Link(trace_bps=trace),
                           batch_size=4, dynamic=args.dynamic)
    rs = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rs.integers(0, cfg.vocab_size, 10).astype(np.int32),
                    max_new_tokens=args.new_tokens, slo_s=args.slo_ms / 1e3)
            for i in range(args.requests)]
    stats = engine.serve(reqs)
    print("\nserving summary:", stats.summary())

    # fused exit-head confidence (the CUDA kernel on the card, its plain
    # version on the CPU)
    toks = torch.from_numpy(reqs[0].prompt).to(dev)[None]
    cache = model.init_cache(1, 32, dtype=torch.float32, device=dev,
                             enc_len=toks.shape[1])
    h, cache = model.prefill(params, toks, cache)
    conf = exit_ops.exit_confidence(h, params["embed"])
    print(f"\nfused exit-head on last prefill token: "
          f"token={int(conf['token'][0, 0])} "
          f"conf={float(conf['conf'][0, 0]):.3f} "
          f"entropy={float(conf['entropy'][0, 0]):.2f} "
          f"(vs vocab max {np.log(cfg.padded_vocab):.2f})")
    return {"summary": stats.summary(), "tokens": stats.tokens,
            "exit_head": {k: v[0, 0].item() for k, v in conf.items()},
            "log_vocab": float(np.log(cfg.padded_vocab))}


if __name__ == "__main__":
    main()
