"""AdamW over parameter trees (the counterpart of
``src/repro/optim/adamw.py``).  Moments may be kept in bfloat16 (the
standard large-model memory trick); every update computes in float32 and
casts back to each leaf's dtype, as the reference does.

The update is functional: it returns new parameters and a new state and
changes neither argument.  The step count stays on the parameters' device,
so an update never waits on the host.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree as T


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32, 0-d
    mu: Any
    nu: Any


def adamw_init(params, moment_dtype=torch.float32) -> AdamWState:
    leaves = T.leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=T.tree_map(zeros, params), nu=T.tree_map(zeros, params))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, grad_clip=1.0):
    """Returns (new_params, new_state): the global-norm clip over every
    leaf, then AdamW.  ``lr`` is a float or a 0-d tensor.  Each constant
    meets the float32 values as the reference's weakly typed scalars do:
    rounded to float32 first, and the bias corrections ``1 - b ** step``
    are taken in float32."""
    flat_p = T.leaves(params)
    flat_g, flat_m, flat_v = T.leaves(grads), T.leaves(state.mu), T.leaves(state.nu)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and moments must be congruent trees")
    dev = state.step.device
    f32 = dict(dtype=torch.float32, device=dev)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in flat_g))
    # a tensor numerator: `float / tensor` is a reciprocal and a product
    scale = torch.clamp(torch.tensor(grad_clip, **f32) / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    b1c = 1 - torch.pow(torch.tensor(b1, **f32), step.float())
    b2c = 1 - torch.pow(torch.tensor(b2, **f32), step.float())

    def upd(p, g, m, v):
        g = g.float() * scale
        m32, v32 = m.float(), v.float()
        m32 = b1 * m32 + (1 - b1) * g
        v32 = b2 * v32 + (1 - b2) * g * g
        update = (m32 / b1c) / (torch.sqrt(v32 / b2c) + eps)
        update = update + weight_decay * p.float()
        newp = p.float() - lr * update
        return newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    out = [upd(p, g, m, v) for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v)]
    return (T.unflatten(params, [o[0] for o in out]),
            AdamWState(step=step, mu=T.unflatten(state.mu, [o[1] for o in out]),
                       nu=T.unflatten(state.nu, [o[2] for o in out])))
