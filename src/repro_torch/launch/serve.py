"""Serving driver: ``python -m repro_torch.launch.serve --arch <id>``.

Runs the Edgent-planned two-tier serving engine: builds the LM inference
graph, arms the planner (static or dynamic configurator), streams batched
requests against a bandwidth trace, reports SLO attainment / exit
statistics — the paper's co-inference stage as a service.  The flags are the
reference's (``src/repro/launch/serve.py``) plus ``--device``.

On the card (``--device cuda``, the default) it serves the full-size config
in bfloat16 through the port's kernels; with ``--device cpu`` it serves the
smoke config in float32 through the kernels' plain versions, as the
reference does on its CPU.  Run on the card so far: ``llama3.2-1b``,
``rwkv6-3b``, ``zamba2-2.7b`` (its shared attention at head dim 80),
``llava-next-mistral-7b`` (its mistral-7b text backbone: the serving engine
feeds no image prefix, as the reference's), ``granite-3-2b``,
``granite-3-8b`` and ``starcoder2-15b`` (48 heads over 4, 43.4 GB of bf16
weights).  Refused before any weight is
made (:func:`refusal`): ``seamless-m4t-large-v2`` anywhere, since the
serving engine feeds no audio frames to its encoder (nor does the
reference's), and on the card a model whose bf16 weights exceed the card's
memory (``llama4-scout-17b-a16e``, ``llama4-maverick-400b-a17b``).
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


def refusal(cfg, on_card: bool, card_bytes: int):
    """Why ``cfg`` cannot be served here (None when it can): the enc-dec
    needs frames the serving engine does not feed; on the card, the full
    config's bf16 weights must fit in ``card_bytes``."""
    if cfg.is_encdec:
        return (f"{cfg.name} is an encoder-decoder: the serving engine feeds no "
                "audio frames to its encoder (nor does the reference's)")
    weight_bytes = 2 * cfg.param_count()
    if on_card and weight_bytes > card_bytes:
        return (f"{cfg.name}: {weight_bytes / 1e9:.1f} GB of bf16 weights exceed "
                f"the card's {card_bytes / 1e9:.1f} GB")
    return None


def build(arch: str, device, *, batch: int = 4, slo_ms: float = 400.0,
          dynamic: bool = False, trace: str = "dcn"):
    """``(cfg, engine)``: the engine :func:`main` serves with on ``device``
    (the full config in bfloat16 on the card, the smoke config in float32
    on the CPU), or SystemExit with :func:`refusal`'s reason."""
    on_card = device.type == "cuda"
    cfg = get_config(arch) if on_card else get_smoke_config(arch)
    card_bytes = torch.cuda.get_device_properties(device).total_memory if on_card else 0
    why = refusal(cfg, on_card, card_bytes)
    if why is not None:
        raise SystemExit(f"cannot serve --arch {arch}: {why}")
    dtype = torch.bfloat16 if on_card else torch.float32
    model = Model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init_params(gen, dtype=dtype, device=device)

    # tiers: edge = 8-card slice, device = 1 card; full-size graph for
    # virtual timing, the served model for token values
    graph = lm_graph(get_config(arch), batch=batch, seq=1)
    f_edge = RooflineLatencyModel(chips=8, efficiency=0.4)
    f_device = RooflineLatencyModel(chips=1, efficiency=0.4)
    planner = EdgentPlanner(graph, latency_req_s=slo_ms / 1e3)
    planner.with_models(f_edge, f_device)
    bw = dcn_trace(0, 2048) if trace == "dcn" else belgium_lte_like(0, 2048)
    if dynamic:
        hist = [bw[i : i + 49] for i in range(0, 980, 49)]
        planner.offline_dynamic(hist)
    link = Link(trace_bps=bw)

    engine = ServingEngine(model, params, graph, planner, link,
                           batch_size=batch, dynamic=dynamic, dtype=dtype)
    return cfg, engine


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
    cfg, engine = build(args.arch, device, batch=args.batch, slo_ms=args.slo_ms,
                        dynamic=args.dynamic, trace=args.trace)
    rs = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rs.integers(0, cfg.vocab_size, 12).astype(np.int32),
                    max_new_tokens=args.new_tokens,
                    slo_s=args.slo_ms / 1e3)
            for i in range(args.requests)]
    stats = engine.serve(reqs)
    print(f"served {cfg.name} on {device} in {engine.dtype}")
    print("summary:", stats.summary())
    return stats


if __name__ == "__main__":
    main()
