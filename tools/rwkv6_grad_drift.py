#!/usr/bin/env python3
"""How far two float32 computations of rwkv6-3b's grads part, by depth, on
one CUDA card.

    python3 tools/rwkv6_grad_drift.py [--layers 2 3 4 8] [--seq 128]

For each depth of ``--layers`` (two at least: at one layer a segment of
the five exits holds no block, which the stack cannot run) it builds rwkv6-3b at full width and that
many layers in float32 (random weights from ``torch.Generator`` seed 0, a
batch of one row of ``--seq`` positions from seed 21, TF32 off) and takes
the loss of ``Model.loss`` (remat on) and its grads five ways: on the card
with the chunked scan, on the card with the sequential scan
(``linear_scan(mode="sequential")``), on the CPU with each of the two, and
on the card and the CPU with every RWKV-6 block replaced by the identity
(what lies outside the blocks: the embedding, the norms, the tied exit
heads and the CE).  Four pairs are compared: chunked against sequential on
the card, and card against CPU with the chunked scan, with the sequential
scan, and outside the blocks.  Each leaf's max |diff| is read as a share
of ``1e-4 max|g| + 1e-6`` (``max|g|`` the second path's), the rule of
``chip_smoke.py``'s phase 21.  For each pair it prints the loss gap, the
worst share by leaf name (the last part of its path, over all layers) and
the three worst leaves, then the whole result as one JSON line after the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

RTOL, ATOL = 1e-4, 1e-6
ARCH = "rwkv6-3b"


@contextlib.contextmanager
def patched(module, name, fn):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def main(argv=None):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 3, 4, 8])
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args(argv)

    import torch

    from repro_torch import tree as T
    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.models import linear_scan as LS
    from repro_torch.models import rwkv6
    from repro_torch.models.api import Model

    if not torch.cuda.is_available():
        raise SystemExit("rwkv6_grad_drift: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()

    def sequential(*a, **kw):
        return LS.linear_scan(*a, **dict(kw, mode="sequential"))

    def identity(p, cfg, x, state, lasts, **kw):
        return x, state, lasts

    def loss_grads(model, params, batch, how):
        leaves = [p.detach().clone().requires_grad_() for p in T.leaves(params)]
        ps = T.unflatten(params, leaves)
        with contextlib.ExitStack() as ctx:
            if how == "sequential":
                ctx.enter_context(patched(rwkv6, "linear_scan", sequential))
            if how == "identity":
                ctx.enter_context(patched(rwkv6, "block", identity))
            loss, _ = model.loss(ps, batch, remat=True)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return float(loss.detach()), [torch.zeros(p.shape) if g is None
                                      else g.detach().cpu() for p, g in zip(leaves, grads)]

    def compare(keys, a, b):
        shares = {}
        for k, ga, gb in zip(keys, a[1], b[1]):
            tol = RTOL * float(gb.abs().max()) + ATOL if gb.numel() else 1.0
            err = float((ga - gb).abs().max()) if ga.numel() else 0.0
            shares[k] = err / tol
        by_name = {}
        for k, s in shares.items():
            name = k.split("/")[-1]
            by_name[name] = max(by_name.get(name, 0.0), s)
        worst = sorted(shares.items(), key=lambda kv: -kv[1])[:3]
        return {"loss_gap": abs(a[0] - b[0]), "worst": worst,
                "by_name": dict(sorted(by_name.items(), key=lambda kv: -kv[1]))}

    out = {"arch": ARCH, "seq": args.seq, "card": card, "depths": {}}
    for layers in args.layers:
        cfg = dataclasses.replace(get_config(ARCH), num_layers=layers)
        model = Model(cfg)
        params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                                   dtype=torch.float32, device="cuda")
        batch = model.make_inputs(ShapeConfig("drift", args.seq, 1, "train"),
                                  generator=torch.Generator(device="cuda").manual_seed(21),
                                  device="cuda")
        keys = [k for k, _ in T.leaves_with_paths(params)]
        p_cpu = T.tree_map(lambda t: t.cpu(), params)
        b_cpu = {k: v.cpu() for k, v in batch.items()}
        runs = {}
        for how in ("chunked", "sequential", "identity"):
            runs["card", how] = loss_grads(model, params, batch, how)
            runs["cpu", how] = loss_grads(model, p_cpu, b_cpu, how)
        pairs = {"card chunked / card sequential": (runs["card", "chunked"],
                                                    runs["card", "sequential"]),
                 "card / CPU, chunked": (runs["card", "chunked"], runs["cpu", "chunked"]),
                 "card / CPU, sequential": (runs["card", "sequential"],
                                            runs["cpu", "sequential"]),
                 "card / CPU, outside the blocks": (runs["card", "identity"],
                                                    runs["cpu", "identity"])}
        res = {name: compare(keys, a, b) for name, (a, b) in pairs.items()}
        out["depths"][layers] = res
        for name, r in res.items():
            print(f"{ARCH} {layers} layers S{args.seq} f32, {name}: loss gap "
                  f"{r['loss_gap']:.3e}; worst share by leaf name "
                  + ", ".join(f"{n} {s:.3g}" for n, s in list(r["by_name"].items())[:6])
                  + "; worst leaves " + ", ".join(f"{k} {s:.3g}" for k, s in r["worst"]),
                  flush=True)
        del params, p_cpu, runs
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
