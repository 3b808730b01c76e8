"""Carry the reference's parameters into the port.

The JAX package draws its parameters from ``jax.random``, which torch cannot
replay, so the port is held against the reference on the reference's own
parameters: the caller turns the JAX pytree into nested dicts of numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``) and hands it here.
Weights keep the reference's ``[in, out]`` layout (the port multiplies
``x @ W`` as the reference does), so every leaf is copied as it is, and the
port's tree has the reference's structure for every family.

BranchyAlexNet's parameters (a dict of layers keyed by name) convert with
:func:`alexnet_params_from_numpy`: its conv weights turn from the
reference's HWIO into the port's OIHW.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve
from repro_torch.models.api import Model

#: leaves that stay float32 whatever the model dtype, as in the reference
#: (RWKV-6's decay base and bonus, Mamba-2's A, D and dt bias, the MoE
#: router)
F32_LEAVES = ("w0", "u", "A_log", "D", "dt_bias", "router")


def _convert(tree, dtype, device, key=None):
    if isinstance(tree, dict):
        return {k: _convert(v, dtype, device, k) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_convert(v, dtype, device, key) for v in tree)
    t = torch.from_numpy(np.array(tree, dtype=np.float32, copy=True))
    return t.to(device=device, dtype=torch.float32 if key in F32_LEAVES else dtype)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _check_depth(name, tree, n):
    depths = {np.shape(leaf)[0] for leaf in _leaves(tree)}
    if depths != {n}:
        raise ValueError(f"{name} stacks {sorted(depths)} units, config has {n}")


def params_from_numpy(cfg: ModelConfig, tree, *, dtype=torch.float32,
                      device="cuda"):
    """``tree``: the reference's parameter pytree of numpy arrays —
    ``embed`` [V, D], ``segments`` (a tuple with one dict per segment of
    stacked ``[n, ...]`` unit leaves: ``attn``/``ffn``, the MoE's
    ``attn``/``moe`` or ``attn0``/``ffn``/``attn1``/``moe``, the enc-dec
    decoder's ``attn``/``xattn``/``ffn``), ``final_norm`` [D],
    ``exit_norms`` [n_seg - 1, D] and, by family, the hybrid's unstacked
    ``shared_attn`` and ``shared_ffn``, the VLM's ``mm_proj`` [1024, D], the
    enc-dec's ``audio_proj`` [1024, D], ``encoder`` (stacked over
    ``num_encoder_layers``) and ``enc_norm``.  Returns the port's parameter
    dict, every leaf in ``dtype`` but :data:`F32_LEAVES`."""
    dev = resolve(device)
    segs = Model(cfg).segment_lengths()
    if len(tree["segments"]) != len(segs):
        raise ValueError(f"{len(tree['segments'])} segments, config has {len(segs)}")
    for n, seg in zip(segs, tree["segments"]):
        _check_depth("segment", seg, n)
    if cfg.is_encdec:
        _check_depth("encoder", tree["encoder"], cfg.num_encoder_layers)
    return _convert(tree, dtype, dev)


def alexnet_params_from_numpy(tree, *, dtype=torch.float32, device="cuda"):
    """``tree``: the reference's BranchyAlexNet parameters as numpy arrays,
    ``{layer name: {"w", "b"}}`` (``{}`` for layers without parameters).
    Conv weights go from HWIO ``[f, f, in, out]`` to OIHW ``[out, in, f,
    f]``, stored channels-last as ``BranchyAlexNet.init`` stores them; fc
    weights keep ``[in, out]``."""
    dev = resolve(device)

    def leaf(v):
        t = torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
        if t.ndim == 4:                                    # conv HWIO -> OIHW
            return t.permute(3, 2, 0, 1).to(device=dev, dtype=dtype) \
                .contiguous(memory_format=torch.channels_last)
        return t.to(device=dev, dtype=dtype)
    return {name: {k: leaf(v) for k, v in layer.items()}
            for name, layer in tree.items()}
