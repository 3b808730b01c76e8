"""Train the paper's branchy AlexNet (BranchyNet joint loss) on the
synthetic CIFAR-like set for a few hundred steps on the PyTorch port, with
checkpoint/restart, and report per-exit accuracy — the accuracy/latency
tradeoff that the right-sizing knob trades on (the counterpart of
``examples/train_branchy_alexnet.py``).

Run:  PYTHONPATH=src python examples/torch_train_branchy_alexnet.py [--steps 300] [--device cuda]
"""
import argparse
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.checkpointing import CheckpointManager
from repro_torch.data.synthetic import cifar_like
from repro_torch.device import resolve
from repro_torch.models.alexnet import BranchyAlexNet, BranchyAlexNetConfig
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.runtime.fault_tolerance import FailureInjector, ResilientLoop

#: checkpoints go under the checkout's build directory unless told otherwise
DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[1] / "build" / "branchy_alexnet_ckpt"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--noise", type=float, default=1.4)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    net = BranchyAlexNet(BranchyAlexNetConfig())
    params = net.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = adamw_init(params)

    def step(params, opt, x, y, r):
        params = T.tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = net.loss(params, (x, y), r)
        loss.backward()
        grads = T.tree_map(lambda p: p.grad, params)
        params, opt = adamw_update(grads, opt, params, lr=1e-3,
                                   weight_decay=1e-4)
        return params, opt, loss.detach()

    data_rng = np.random.default_rng(0)
    ckpt = CheckpointManager(args.ckpt_dir)
    loop = ResilientLoop(ckpt, save_every=100)
    injector = (FailureInjector(fail_at=(args.inject_failure_at,))
                if args.inject_failure_at else None)
    t0 = time.time()
    # the dropout masks' generator: each step draws on from where the last
    # left off (the reference splits a key a step)
    r = torch.Generator(device=dev).manual_seed(0)
    losses = {}

    def step_fn(state, i):
        params, opt = state
        x, y = cifar_like(data_rng, args.batch, noise=args.noise)
        params, opt, loss = step(params, opt, torch.from_numpy(x).to(dev),
                                 torch.from_numpy(y).to(dev), r)
        if i % 50 == 0:
            losses[i] = float(loss)
            print(f"step {i:4d}  joint loss {losses[i]:.4f}", flush=True)
        return params, opt

    (params, opt), info = loop.run((params, opt), step_fn, args.steps,
                                   injector=injector,
                                   on_restart=lambda s: print(f"[restart] at step {s}"))
    print(f"\ntrained {args.steps} steps in {time.time() - t0:.1f}s "
          f"(restarts={info['restarts']})")

    # per-exit accuracy (the right-sizing tradeoff, paper Fig. 4/9)
    xv, yv = cifar_like(np.random.default_rng(99), 1024, noise=args.noise)
    xv, yv = torch.from_numpy(xv).to(dev), torch.from_numpy(yv).to(dev)
    print("\nexit point -> accuracy (branch length):")
    accuracy = {}
    with torch.no_grad():
        for i in range(1, net.num_exits + 1):
            acc = accuracy[i] = float(net.accuracy(params, xv, yv, i))
            print(f"  exit {i}: {acc:.3f}   ({len(net.branch_layers(i))} layers)")
    return {"losses": losses, "info": info, "accuracy": accuracy}


if __name__ == "__main__":
    main()
