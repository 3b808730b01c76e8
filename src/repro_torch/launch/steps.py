"""Step builders (the counterpart of ``src/repro/launch/steps.py`` on one
device): ``make_train_step``.

The reference jits each step with explicit shardings over a mesh and
donates the parameters and optimiser state.  Here a step runs eagerly on
one device; the mesh, ``seq_parallel`` and the prefill and serve steps wait
for the substrate slice (``ROADMAP.md`` open item 1).
"""
from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.config import ShapeConfig
from repro_torch.device import resolve
from repro_torch.models.api import Model
from repro_torch.optim.adamw import adamw_update
from repro_torch.optim.schedule import warmup_cosine


def make_train_step(model: Model, shape: ShapeConfig, *, device="cuda",
                    moment_dtype=torch.float32, peak_lr: float = 3e-4,
                    warmup: int = 200, total_steps: int = 10000,
                    remat: bool = True, attn_impl: str = "auto",
                    ce_chunk: int = 512, scan_chunk: int = 16,
                    moe_dispatch: str = "einsum"):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "final_ce"})``: the joint multi-exit loss and its backward,
    the learning rate of the warm-up cosine at the optimiser's step, then
    AdamW.  ``batch`` is ``{"tokens": [B, shape.seq_len]}`` on ``device``,
    with ``frames`` for the enc-dec and ``prefix_emb`` for the VLM (see
    :meth:`Model.loss`; ``adamw_init(params, moment_dtype)`` makes the
    state).  The step
    works on leaves that require grad (parameters restored from a
    checkpoint do not, so it marks them) and clears their grads when
    done; the returned parameters are new tensors, the given ones are not
    changed."""
    dev = resolve(device)
    if shape.kind != "train":
        raise ValueError(f"make_train_step takes a train shape, got {shape.kind!r}")

    def train_step(params, opt_state, batch):
        params = T.tree_map(lambda p: p.detach().to(dev).requires_grad_(), params)
        loss, metrics = model.loss(params, batch, remat=remat, attn_impl=attn_impl,
                                   scan_chunk=scan_chunk, ce_chunk=ce_chunk,
                                   moe_dispatch=moe_dispatch)
        loss.backward()
        leaves = T.leaves(params)
        grads = T.unflatten(params, [torch.zeros_like(p) if p.grad is None else p.grad
                                     for p in leaves])
        lr = warmup_cosine(opt_state.step, peak_lr=peak_lr, warmup=warmup,
                           total=total_steps)
        new_params, new_opt = adamw_update(grads, opt_state, params, lr=lr)
        for p in leaves:
            p.grad = None
        return new_params, new_opt, {"loss": metrics["loss"].detach(),
                                     "final_ce": metrics["final_ce"].detach()}

    return train_step
