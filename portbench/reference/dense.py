"""Plain reference of the dense GQA transformer (granite-3-8b's family): pre-norm
attention with split-half RoPE and a SwiGLU FFN in every layer, early exits that
share the tied embedding as their head, each behind its own RMSNorm."""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from portbench.reference import common as C
from portbench.reference.plan import segment_lengths


def _forward(cfg, params, row: C.Row, mm, embed_f32, prefix: Optional[C.Prefix], keep=None):
    """Runs ``row`` from its first position after the pad that ``prefix`` stands for
    (from position 0 without one); returns the logits behind ``row.picks``.
    ``keep``: a list that receives each layer's keys and values."""
    dev = embed_f32.device
    segs = segment_lengths(cfg)
    P = row.pad if prefix is not None else 0
    tok = torch.as_tensor(np.asarray(row.tokens[P:]), dtype=torch.long, device=dev)
    dep = torch.as_tensor(np.asarray(row.depth[P:]), dtype=torch.long, device=dev)
    N = len(row.tokens)
    x = embed_f32[tok]
    out, layer = {}, 0
    for s, n_units in enumerate(segs):
        local = torch.nonzero(dep > s).squeeze(1)
        act = local + P
        seg = params["segments"][s]
        for u in range(n_units):
            head = prefix.head(layer, P) if prefix is not None else None
            h = x[local]
            h = h + C.attention(cfg, C.unit(seg["attn"], u), h, act, N, mm, head, keep)
            h = h + C.swiglu(cfg, C.unit(seg["ffn"], u), h, mm)
            x[local] = h
            layer += 1
        at = [pos for pos, d in row.picks if d == s + 1]
        if at:
            lg = C.head_logits(cfg, params, x[[a - P for a in at]], s, len(segs), embed_f32, mm)
            out.update(((pos, s + 1), v) for pos, v in zip(at, lg))
    return [out[pick] for pick in row.picks]


@torch.no_grad()
def pad_prefix(cfg: dict, params: dict, n: int, mm: C.Matmul, embed_f32) -> C.Prefix:
    """The keys and values of ``n`` pad positions (id 0) at full depth."""
    kv: list = []
    n_seg = len(segment_lengths(cfg))
    _forward(cfg, params, C.Row(np.zeros(n, np.int64), np.full(n, n_seg), []), mm, embed_f32,
             None, kv)
    return C.Prefix(n, kv)


@torch.no_grad()
def row_logits(cfg: dict, params: dict, row: C.Row, mm: C.Matmul, embed_f32,
               prefix: Optional[C.Prefix] = None) -> List[torch.Tensor]:
    """The logits [Vp] behind each of ``row.picks``, in order.  With ``prefix`` (at
    least ``row.pad`` long), the row's pad positions are read from it."""
    return _forward(cfg, params, row, mm, embed_f32, prefix)
