"""Plain PyTorch versions of the flash-attention kernels (the counterpart
of ``src/repro/kernels/flash_attention/ref.py``, head-major layout)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention(q, k, v, lengths):
    """q: [B, H, 1, hd]; k/v: [B, KV, T, hd]; lengths: [B] -> [B, H, 1, hd].

    Row ``b`` attends over its first ``lengths[b]`` key positions only (a
    zero-length row returns zeros — the padded-slot convention)."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    qr = q.reshape(B, KV, G, S, hd).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qr, k.float()) / math.sqrt(hd)
    lengths = torch.as_tensor(lengths, dtype=torch.int64, device=q.device)
    valid = (torch.arange(T, device=q.device)[None, :] < lengths[:, None])
    valid = valid[:, None, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid, p, 0.0)                       # len == 0 -> zeros
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return o.reshape(B, H, S, hd).to(q.dtype)


def attention(q, k, v, *, causal: bool = True):
    """q: [B, H, S, hd]; k/v: [B, KV, T, hd] -> [B, H, S, hd]; f32 softmax.
    The causal diagonal is aligned bottom-right (key j visible to query i
    when j <= i + T - S)."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    qr = q.reshape(B, KV, G, S, hd).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qr, k.float()) / math.sqrt(hd)
    if causal:
        mask = torch.ones(S, T, dtype=torch.bool, device=q.device).tril(T - S)
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return o.reshape(B, H, S, hd).to(q.dtype)
