"""Carry the reference's parameters into the port.

The JAX package draws its parameters from ``jax.random``, which torch cannot
replay, so the port is held against the reference on the reference's own
parameters: the caller turns the JAX pytree into nested dicts of numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``) and hands it here.
Weights keep the reference's ``[in, out]`` layout (the port multiplies
``x @ W`` as the reference does), so every leaf is copied as it is.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import transformer

_UNIT_KEYS = {"attn": ("wq", "wk", "wv", "wo", "ln"),
              "ffn": ("wg", "wu", "wd", "ln")}


def _leaf(a, dtype, device):
    t = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
    return t.to(device=device, dtype=dtype)


def params_from_numpy(cfg: ModelConfig, tree, *, dtype=torch.float32,
                      device="cuda"):
    """``tree``: ``embed`` [V, D], ``segments`` (a tuple with one dict per
    segment of stacked ``[n, ...]`` unit leaves), ``final_norm`` [D] and
    ``exit_norms`` [n_seg - 1, D].  Returns the port's parameter dict."""
    dev = resolve(device)
    segs = transformer.segment_lengths(cfg)
    if len(tree["segments"]) != len(segs):
        raise ValueError(f"{len(tree['segments'])} segments, config has {len(segs)}")
    out = {"embed": _leaf(tree["embed"], dtype, dev)}
    seg_out = []
    for n, seg in zip(segs, tree["segments"]):
        unit = {}
        for block, keys in _UNIT_KEYS.items():
            unit[block] = {k: _leaf(seg[block][k], dtype, dev) for k in keys}
            if unit[block]["ln"].shape[0] != n:
                raise ValueError(f"segment stacks {unit[block]['ln'].shape[0]} "
                                 f"units, config has {n}")
        seg_out.append(unit)
    out["segments"] = tuple(seg_out)
    out["final_norm"] = _leaf(tree["final_norm"], dtype, dev)
    if "exit_norms" in tree:
        out["exit_norms"] = _leaf(tree["exit_norms"], dtype, dev)
    return out
