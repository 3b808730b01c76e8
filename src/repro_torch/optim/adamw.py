"""AdamW over parameter trees (the counterpart of
``src/repro/optim/adamw.py``).  Moments may be kept in bfloat16 (the
standard large-model memory trick); every update computes in float32 and
casts back to each leaf's dtype, as the reference does.

The update is functional unless the caller donates its arguments
(``donate=True``, the counterpart of the reference's ``donate_argnums``):
then it writes the new values into them.  The train step donates, so it
holds one copy of the state.  The step count stays on the parameters'
device, so an update never waits on the host.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch import tree as T


#: elements an update computes at once: its float32 temporaries stay a few
#: hundred MB whatever the leaf (an embedding of 1e9 elements would otherwise
#: take ~20 GB of them)
UPDATE_SLICE = 1 << 24


def _whole(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _slices(t):
    """``t`` as views of at most UPDATE_SLICE elements each, split along
    its leading dims (the leaf's layout does not matter)."""
    if t.ndim <= 1 or t.numel() <= UPDATE_SLICE:
        return t.split(UPDATE_SLICE) if t.ndim else (t,)
    inner = math.prod(t.shape[1:])
    if inner > UPDATE_SLICE:
        return [s for row in t for s in _slices(row)]
    return t.split(UPDATE_SLICE // inner)


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
                 eps=1e-8, weight_decay=0.1, grad_clip=1.0, donate=False):
    """Returns (new_params, new_state): the global-norm clip over every
    leaf, then AdamW.  ``lr`` is a float or a 0-d tensor.  Each constant
    meets the float32 values as the reference's weakly typed scalars do:
    rounded to float32 first, and the bias corrections ``1 - b ** step``
    are taken in float32.  The new values are computed UPDATE_SLICE
    elements at a time and written into ``params`` and the moments of
    ``state`` with ``donate``, into copies of them without; element by
    element the arithmetic is the same either way.  DTensor leaves are
    updated on their local shards (parameters, grads and moments in the
    same placements, as the train step lays them out)."""
    if not donate:
        params, state = T.tree_map(torch.clone, (params, state))
    flat_p = T.leaves(params)
    flat_g, flat_m, flat_v = T.leaves(grads), T.leaves(state.mu), T.leaves(state.nu)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and moments must be congruent trees")
    dev = _local(state.step).device
    f32 = dict(dtype=torch.float32, device=dev)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in flat_g))
    # a tensor numerator: `float / tensor` is a reciprocal and a product
    scale = _whole(torch.clamp(torch.tensor(grad_clip, **f32) / (gnorm + 1e-9), max=1.0))
    step = state.step + 1
    b1c = _whole(1 - torch.pow(torch.tensor(b1, **f32), step.float()))
    b2c = _whole(1 - torch.pow(torch.tensor(b2, **f32), step.float()))
    lr = _whole(lr)

    def upd(p, g, m, v):
        g = g.float() * scale
        m32, v32 = m.float(), v.float()
        m32 = b1 * m32 + (1 - b1) * g
        v32 = b2 * v32 + (1 - b2) * g * g
        update = (m32 / b1c) / (torch.sqrt(v32 / b2c) + eps)
        update = update + weight_decay * p.float()
        newp = p.float() - lr * update
        return newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    for leaf in zip(flat_p, flat_g, flat_m, flat_v):
        for p, g, m, v in zip(*(_slices(_local(t)) for t in leaf)):
            for dst, new in zip((p, m, v), upd(p, g, m, v)):
                dst.copy_(new)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
