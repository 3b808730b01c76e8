"""The weights of a run, made on the device from ``--seed``.

Shapes and dtypes come from the program's abstract parameter tree (``meta``
tensors).  Every leaf of one dtype is a view into one buffer, drawn in a single
``torch.randn`` call on the device's generator in the dtype the model is served
in; each view is then scaled in place.  The scales follow the program's own
initialisation: a projection ``[.., in, out]`` by ``1/sqrt(in)``, the embedding
``[V, D]`` by ``1/sqrt(D)``, the causal conv ``[.., width, C]`` by
``1/sqrt(width)``; norm weights and Mamba-2's ``D`` are ones.  Mamba-2's decay
parameters follow the architecture's published initialisation (the Mamba-2
reference code's defaults): ``A`` uniform in [1, 16] (``A_log = log A``), and
``dt_bias`` the inverse softplus of a ``dt`` log-uniform in [0.001, 0.1].  The
same tensors go to the program and to the reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

ONES = ("ln", "gn", "final_norm", "exit_norms", "D")
MAMBA2_A = (1.0, 16.0)          # A's range
MAMBA2_DT = (1e-3, 1e-1)        # dt's range, log-uniform
ALIGN = 64                      # elements: every view starts 128-byte aligned in bf16


def leaves(tree, path=()) -> List[Tuple[tuple, torch.Tensor]]:
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves(v, path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in leaves(v, path + (i,))]
    return [(path, tree)]


def rebuild(tree, made: Dict[tuple, torch.Tensor], path=()):
    if isinstance(tree, dict):
        return {k: rebuild(v, made, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(rebuild(v, made, path + (i,)) for i, v in enumerate(tree))
    return made[path]


def scale(path: tuple, shape: tuple) -> float:
    """The draw's scale for a leaf (see the module docstring)."""
    name = path[-1]
    if name == "embed":
        return 1.0 / math.sqrt(shape[-1])
    return 1.0 / math.sqrt(max(1, shape[-2]))


def make(abstract, seed: int, device) -> dict:
    """A tree like ``abstract`` (meta tensors) with every leaf made on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    made: Dict[tuple, torch.Tensor] = {}
    drawn: Dict[torch.dtype, List[Tuple[tuple, torch.Tensor]]] = {}
    for path, t in leaves(abstract):
        name = path[-1]
        if name in ONES:
            made[path] = torch.ones(t.shape, dtype=t.dtype, device=device)
        elif name in ("A_log", "dt_bias"):
            continue
        else:
            drawn.setdefault(t.dtype, []).append((path, t))
    for dtype, items in drawn.items():
        offs, n = [], 0
        for _, t in items:
            offs.append(n)
            n += -(-t.numel() // ALIGN) * ALIGN
        buf = torch.randn(n, generator=gen, dtype=dtype, device=device)
        for (path, t), o in zip(items, offs):
            view = buf[o:o + t.numel()].view(t.shape)
            view.mul_(scale(path, tuple(t.shape)))
            made[path] = view
    for path, t in leaves(abstract):
        if path[-1] == "A_log":
            a = torch.empty(t.shape, dtype=torch.float32, device=device)
            made[path] = a.uniform_(*MAMBA2_A, generator=gen).log_().to(t.dtype)
        elif path[-1] == "dt_bias":
            lo, hi = (math.log(x) for x in MAMBA2_DT)
            dt = torch.empty(t.shape, dtype=torch.float32, device=device)
            dt = dt.uniform_(lo, hi, generator=gen).exp_()
            made[path] = (dt + torch.log(-torch.expm1(-dt))).to(t.dtype)
    return rebuild(abstract, made)
