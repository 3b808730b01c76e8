"""Plain PyTorch version of the fused exit head (the counterpart of
``src/repro/kernels/exit_head/ref.py``).

Given normed hidden states ``h`` [B, S, D] and the tied embedding table
``emb`` [V, D], produce per position:

    token  = argmax_v h . emb_v      (the first maximum wins, as torch.argmax)
    conf   = max softmax probability
    ent    = entropy of the softmax

It materializes the [B, S, V] logits; the kernel never does.
"""
from __future__ import annotations

import torch


def exit_confidence(h, emb):
    """Returns dict(token [B,S] int32, conf [B,S] f32, entropy [B,S] f32)."""
    logits = torch.einsum("bsd,vd->bsv", h, emb).float()
    p = torch.softmax(logits, dim=-1)
    ent = -torch.sum(p * torch.log(torch.clamp(p, 1e-30, 1.0)), dim=-1)
    return {
        "token": torch.argmax(logits, dim=-1).to(torch.int32),
        "conf": p.max(dim=-1).values,
        "entropy": ent,
    }
