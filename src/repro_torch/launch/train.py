"""Training driver: ``python -m repro_torch.launch.train --arch <id>
[--smoke | --full] [--device cuda]`` (the counterpart of
``src/repro/launch/train.py``).

On a running world of more than one process the step runs sharded on
:func:`repro_torch.launch.mesh.make_host_mesh`, the ``(data, model)`` mesh
over that world; on a world of one (none running) it is the mesh-less step
on ``--device``.  ``--smoke`` (the default) trains the reduced config in
float32.  ``--full``, as the reference's, trains the full config in
bfloat16 with float32 moments on the production mesh (16×16 over 256
ranks), which one card cannot hold: it raises on any other world, and no
smaller mesh is built in its place.  :func:`train` with ``smoke=False``
trains the full config with the same step (``chip_smoke.py``'s phase 15
runs llama3.2-1b so on one card, and phase 21 times the step for the other
five families).  Either runs the whole stack: the train step (joint
multi-exit loss, flash attention with its flash backward past 1024²
scores, per-unit recompute, chunked CE, AdamW on the donated state),
checkpoint/restart
with auto-resume, and failure injection for drills.  The state is kept
whole between steps (a sharded step's outputs are gathered), as the
reference's checkpoint manager gathers it to the host.
"""
from __future__ import annotations

import argparse
import math
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.checkpointing import CheckpointManager
from repro_torch.config import ShapeConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.synthetic import token_batches
from repro_torch.device import resolve
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch import tree as T
from repro_torch.models.api import Model
from repro_torch.models.encdec import AUDIO_DIM
from repro_torch.models.transformer import VIS_DIM
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.fault_tolerance import FailureInjector, ResilientLoop

#: checkpoints go under the checkout's build directory unless told otherwise
DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_ckpt"


def _whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


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


def trainer_step(model, seq, batch, *, device="cuda", production_mesh=False):
    """The step :func:`train` runs on batches of ``batch`` sequences of
    ``seq`` tokens: ``make_train_step(remat=True, ce_chunk=min(512,
    seq))``, which donates the state it is given.  With
    ``production_mesh`` it runs on the production mesh, on a running world
    of more than one process on the host mesh, its parameters and
    optimiser state gathered whole after each step; on a world of one it
    is the mesh-less step on ``device`` (a mesh of one device shards
    nothing, and DTensor's dispatch would cost host time on every op)."""
    dev = resolve(device)
    if production_mesh:
        mesh = make_production_mesh(device=dev)
    elif dist.is_initialized() and dist.get_world_size() > 1:
        mesh = make_host_mesh(device=dev)
    else:
        mesh = None
    sharded, _ = make_train_step(model, mesh, ShapeConfig("cli", seq, batch, "train"),
                                 remat=True, ce_chunk=min(512, seq), device=dev)

    def step(params, opt, batch):
        params, opt, metrics = sharded(params, opt, batch)
        return T.tree_map(_whole, params), T.tree_map(_whole, opt), metrics
    return step


def train(arch="llama3.2-1b", *, smoke=True, steps=200, batch=8, seq=64,
          ckpt_dir=DEFAULT_CKPT_DIR, save_every=50, inject_failure_at=None,
          device="cuda", production_mesh=False):
    """Train ``arch`` for ``steps`` steps on batches of ``batch`` sequences
    of ``seq`` tokens (the model sees ``seq - 1``) with
    :func:`trainer_step`, on the production mesh with ``production_mesh``
    (``--full``; it raises off a world of 256).
    Returns ``{"params", "opt", "losses", "info", "seconds"}``: the final
    state (whole tensors), the loss of every step run (replays included),
    the loop's restarts and final step, and the loop's wall time (the
    initial state's making included)."""
    dev = resolve(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = Model(cfg)
    step = trainer_step(model, seq, batch, device=dev, production_mesh=production_mesh)

    def fresh():
        """The initial state, made anew for a cold restart: the step
        donates the one it was given."""
        params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                                   dtype=torch.float32 if smoke else torch.bfloat16,
                                   device=dev)
        return params, adamw_init(params)
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
    # no name keeps the initial state: a cold restart makes it anew in its place
    (params, opt), info = loop.run(fresh(), step_fn, steps, injector=injector, fresh=fresh,
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
                inject_failure_at=args.inject_failure_at, device=args.device,
                production_mesh=not args.smoke)
    losses, dt = out["losses"], out["seconds"]
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({args.steps * args.batch * args.seq / dt:.0f} tok/s), "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
          f"restarts={out['info']['restarts']}")
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit("non-finite loss")


if __name__ == "__main__":
    main()
