"""Training driver: ``python -m repro_torch.launch.train --arch <id>
[--smoke | --full] [--device cuda]`` (the counterpart of
``src/repro/launch/train.py`` on one device).

``--smoke`` (the default) trains the reduced config in float32; ``--full``
the full one in bfloat16 with float32 moments.  Either runs the whole
stack: the train step (joint multi-exit loss, flash attention with its
flash backward past 1024² scores, per-unit recompute, chunked CE, AdamW),
checkpoint/restart with auto-resume, and failure injection for drills.
On the card:

    python -m repro_torch.launch.train --full --arch llama3.2-1b --seq 2049 --batch 4 --steps 6
"""
from __future__ import annotations

import argparse
import math
import time
from pathlib import Path

import torch

from repro_torch.checkpointing import CheckpointManager
from repro_torch.config import ShapeConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.synthetic import token_batches
from repro_torch.device import resolve
from repro_torch.launch.steps import make_train_step
from repro_torch.models.api import Model
from repro_torch.models.encdec import AUDIO_DIM
from repro_torch.models.transformer import VIS_DIM
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.fault_tolerance import FailureInjector, ResilientLoop

#: checkpoints go under the checkout's build directory unless told otherwise
DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_ckpt"


def train_batch(cfg, tokens, step: int, seq: int, device):
    """Step ``step``'s batch from its ``tokens`` [B, seq], as the
    reference's trainer builds it: the enc-dec gets standard-normal stub
    frames [B, seq, 1024], the VLM a standard-normal stub prefix [B, P,
    1024] and its tokens cut to ``seq - P + 1``, so that prefix and text
    fill ``seq`` positions.  The noise is drawn from a generator seeded
    with ``step`` (the reference folds the step into its key)."""
    batch = {"tokens": tokens}
    gen = torch.Generator(device=device).manual_seed(step)
    B = tokens.shape[0]
    if cfg.is_encdec:
        batch["frames"] = torch.randn((B, seq, AUDIO_DIM), generator=gen, device=device)
    if cfg.frontend == "vision":
        P = cfg.num_prefix_tokens
        batch["prefix_emb"] = torch.randn((B, P, VIS_DIM), generator=gen, device=device)
        batch["tokens"] = tokens[:, : seq - P + 1]
    return batch


def train(arch="llama3.2-1b", *, smoke=True, steps=200, batch=8, seq=64,
          ckpt_dir=DEFAULT_CKPT_DIR, save_every=50, inject_failure_at=None,
          device="cuda"):
    """Train ``arch`` for ``steps`` steps on batches of ``batch`` sequences
    of ``seq`` tokens (the model sees ``seq - 1``).  Returns ``{"params",
    "opt", "losses", "info", "seconds"}``: the final state, the loss of
    every step run (replays included), the loop's restarts and final step,
    and the loop's wall time."""
    dev = resolve(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = Model(cfg)
    shape = ShapeConfig("cli", seq, batch, "train")
    step = make_train_step(model, shape, device=dev, remat=True,
                           ce_chunk=min(512, seq))
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dtype=torch.float32 if smoke else torch.bfloat16,
                               device=dev)
    opt = adamw_init(params)
    data = token_batches(0, batch, seq, cfg.vocab_size)

    loop = ResilientLoop(CheckpointManager(str(ckpt_dir)), save_every=save_every)
    injector = (FailureInjector(fail_at=(inject_failure_at,))
                if inject_failure_at else None)
    losses = []

    def step_fn(state, i):
        params, opt = state
        tokens = torch.from_numpy(next(data)).to(dev)
        params, opt, metrics = step(params, opt, train_batch(cfg, tokens, i, seq, dev))
        loss = float(metrics["loss"])
        losses.append(loss)
        if i % 20 == 0:
            print(f"step {i:5d} loss {loss:.4f}", flush=True)
        return params, opt

    t0 = time.perf_counter()
    (params, opt), info = loop.run((params, opt), step_fn, steps, injector=injector,
                                   on_restart=lambda s: print(f"[restart] resumed at step {s}"))
    return {"params": params, "opt": opt, "losses": losses, "info": info,
            "seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = train(args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
                seq=args.seq, ckpt_dir=args.ckpt_dir, save_every=args.save_every,
                inject_failure_at=args.inject_failure_at, device=args.device)
    losses, dt = out["losses"], out["seconds"]
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({args.steps * args.batch * args.seq / dt:.0f} tok/s), "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
          f"restarts={out['info']['restarts']}")
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit("non-finite loss")


if __name__ == "__main__":
    main()
