"""Gradient compression for the inter-pod all-reduce (the counterpart of
``src/repro/optim/grad_compress.py``).

Error-feedback int8 quantization: each step quantizes (grad + residual) to
int8 with one scale per tensor and keeps the quantization error as the
residual.  ``torch.round`` rounds half to even, as ``jnp.round`` does, so
the int8 payload is the reference's byte for byte.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import tree as T


class EFState(NamedTuple):
    residual: Any


def ef_init(params) -> EFState:
    return EFState(residual=T.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))


def quantize_int8(x):
    # a tensor divisor: a python scalar one is a reciprocal and a product on CUDA
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / torch.tensor(
        127.0, device=x.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.float() * scale


def compress_grads(grads, ef: EFState) -> Tuple[Any, EFState]:
    """Returns (compressed-then-decompressed grads, new error-feedback
    state); compression and the feedback loop are exact."""

    def one(g, r):
        x = g.float() + r
        q, s = quantize_int8(x)
        deq = dequantize(q, s)
        return deq.to(g.dtype), x - deq

    out = [one(g, r) for g, r in zip(T.leaves(grads), T.leaves(ef.residual))]
    return (T.unflatten(grads, [o[0] for o in out]),
            EFState(residual=T.unflatten(ef.residual, [o[1] for o in out])))


def topk_compress(g, frac: float = 0.01):
    """Top-k sparsification by magnitude: a dense tensor that keeps every
    entry at least as large as the k-th largest magnitude (ties included),
    zeros elsewhere."""
    x = g.float()
    k = max(1, int(x.numel() * frac))
    thresh = torch.topk(torch.abs(x).reshape(-1), k).values[-1]
    return torch.where(torch.abs(x) >= thresh, x, 0.0).to(g.dtype)
