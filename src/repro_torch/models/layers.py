"""Shared model primitives of the dense family: RMSNorm, RoPE, GQA attention
(+KV cache), SwiGLU, tied embedding / logits.

Plain functions over parameter dicts of tensors, mirroring
``src/repro/models/layers.py``.  Weights keep the reference's ``[in, out]``
layout, so every projection is ``x @ W`` as there.

``impl`` selects attention: ``"kernel"`` (the default) runs the port's
kernels through their wrappers — the CUDA kernels for a CUDA tensor, their
plain versions for a CPU tensor; ``"dense"`` runs the reference's masked
dense ``_sdpa`` in plain PyTorch.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops

NEG_INF = -1e30
IMPLS = ("kernel", "dense")


def dense_init(generator, shape, dtype, fan_in, device):
    scale = 1.0 / math.sqrt(max(1, fan_in))
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def rms_norm(x, w, eps):
    # cast back to the input dtype BEFORE the weight multiply, as the reference
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


# ----------------------------------------------------------------------------
# RoPE (split-half, not interleaved)
# ----------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None):
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta):
    """x: [..., S, H, hd]; positions: [..., S] int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # [hd/2]
    angles = positions[..., None].float() * freqs            # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# GQA attention
# ----------------------------------------------------------------------------

def init_attn(generator, cfg: ModelConfig, dtype, device, stack: int = 0):
    d, hd = cfg.d_model, cfg.hd
    hp, kv = cfg.padded_heads, cfg.num_kv_heads
    pre = (stack,) if stack else ()

    def mk(shape, fan):
        return dense_init(generator, pre + shape, dtype, fan, device)

    return {
        "wq": mk((d, hp * hd), d),
        "wk": mk((d, kv * hd), d),
        "wv": mk((d, kv * hd), d),
        "wo": mk((hp * hd, d), hp * hd),
        "ln": torch.ones(pre + (d,), dtype=dtype, device=device),
    }


def _sdpa(q, k, v, mask_bias):
    """q: [B,S,H,hd], k/v: [B,T,KV,hd] -> [B,S,H,hd]; f32 softmax.  Scores
    come from a product in the input dtype, cast to f32; probabilities are
    cast to v's dtype before PV — as the reference."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    q = q.reshape(B, S, KV, G, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float()
    scores = scores / math.sqrt(hd) + mask_bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, hd)


def causal_bias(S: int, T: int, offset: int = 0, device=None):
    """[1,1,1,S,T] additive bias; position i attends to j <= i + offset."""
    qi = torch.arange(S, device=device)[:, None] + offset
    kj = torch.arange(T, device=device)[None, :]
    bias = torch.where(kj <= qi, 0.0, NEG_INF).float()
    return bias[None, None, None]


def _decode_bias(cache_pos, S: int, T: int, device):
    """Additive bias of the cached decode: query i attends to key
    j <= cache_pos + i.  A scalar position gives [1,1,1,S,T]; a [B]
    position gives [B,1,1,S,T]."""
    if isinstance(cache_pos, int):
        return causal_bias(S, T, cache_pos, device)
    kj = torch.arange(T, device=device)
    qi = cache_pos.to(device)[:, None, None] + torch.arange(S, device=device)[None, :, None]
    bias = torch.where(kj[None, None, :] <= qi, 0.0, NEG_INF).float()
    return bias[:, None, None]


def decode_lengths(cache_pos, B: int, device):
    """[B] int32 key counts of the cached decode, ``cache_pos + 1`` per row:
    the ``lengths`` of the decode-attention kernel."""
    if isinstance(cache_pos, int):
        return torch.full((B,), cache_pos + 1, dtype=torch.int32, device=device)
    return (cache_pos + 1).to(device=device, dtype=torch.int32)


def _write_cache(buf, val, cache_pos, mask=None):
    """In-place KV write at ``cache_pos`` along the sequence axis.

    The reference's ``jax.lax.dynamic_update_slice_in_dim`` returns a new
    buffer and clamps an out-of-range start; here the buffer is written in
    place, and an out-of-range write raises instead of clamping (the
    serving cache is sized prompt + max_new + 1, so the main path never
    reaches the end).

    ``mask`` ([B] bool, or None for every row; only with [B] positions)
    is the masked commit of the
    reference's arena call, which computes every row and keeps the new
    state only where the mask is set: a row outside it writes back the
    value it already holds, bit for bit, so several calls with disjoint
    masks may sweep one cache in turn.  The old value is gathered on the
    card, so the commit needs no host sync."""
    S, T = val.shape[1], buf.shape[1]
    if isinstance(cache_pos, int):
        if mask is not None:
            raise ValueError("a masked commit takes [B] cache positions")
        if not (0 <= cache_pos and cache_pos + S <= T):
            raise IndexError(f"cache write [{cache_pos}, {cache_pos + S}) "
                             f"outside a cache of length {T}")
        buf[:, cache_pos:cache_pos + S] = val.to(buf.dtype)
    else:                                   # [B] positions, one token each
        if S != 1:
            raise ValueError("per-row cache positions take one token per row")
        rows = torch.arange(buf.shape[0], device=buf.device)
        idx = cache_pos.to(buf.device)
        new = val[:, 0].to(buf.dtype)
        if mask is not None:
            new = torch.where(mask.view(-1, 1, 1), new, buf[rows, idx])
        buf[rows, idx] = new


def attention(p, cfg: ModelConfig, x, positions, *, causal=True,
              kv_cache=None, cache_pos=None, lengths=None, impl="kernel",
              prefill_mode=False, write_mask=None):
    """Full/cached attention.

    - training: ``kv_cache is None`` -> self attention over x.
    - prefill: ``kv_cache`` given + ``prefill_mode=True`` — writes k/v at
      [cache_pos, cache_pos+S) but attends within the current block only.
    - decode: ``kv_cache=(k,v) [B,T,KV,hd]`` and ``cache_pos`` an int or a
      [B] tensor — writes the new kv at ``cache_pos`` and attends to
      [0, cache_pos].  ``lengths`` is :func:`decode_lengths` of
      ``cache_pos``; a decode step builds it once for all its layers, and it
      is built here when not given.  ``write_mask`` ([B] bool) commits the
      cache write of the rows it selects only (:func:`_write_cache`).
    Returns (out [B,S,D], new_cache or None); the cache is written in place
    and returned.

    When ``cfg.padded_heads > cfg.num_heads`` the padding query heads are
    masked to zero before the output projection.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")

    def _mask_pad_heads(out, h):
        if h == cfg.num_heads:
            return out
        gp = h // cfg.num_kv_heads
        g = cfg.num_heads // cfg.num_kv_heads
        mask = (torch.arange(h, device=out.device) % gp) < g
        return out * mask[None, None, :, None].to(out.dtype)

    B, S, _ = x.shape
    hd, kv_h = cfg.hd, cfg.num_kv_heads
    h = p["wq"].shape[-1] // hd           # padded head count (cfg.padded_heads)
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    q = (xn @ p["wq"]).reshape(B, S, h, hd)
    k = (xn @ p["wk"]).reshape(B, S, kv_h, hd)
    v = (xn @ p["wv"]).reshape(B, S, kv_h, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    new_cache = None
    if kv_cache is not None:
        ck, cv = kv_cache
        _write_cache(ck, k, cache_pos, write_mask)
        _write_cache(cv, v, cache_pos, write_mask)
        new_cache = (ck, cv)
        if not prefill_mode:
            # decode: attend to the filled cache
            T = ck.shape[1]
            if impl == "kernel":
                if lengths is None:
                    lengths = decode_lengths(cache_pos, B, x.device)
                out = fa_ops.decode_attention(q, ck.to(q.dtype), cv.to(q.dtype),
                                              lengths)
            else:
                bias = _decode_bias(cache_pos, S, T, x.device)
                out = _sdpa(q, ck.to(q.dtype), cv.to(q.dtype), bias)
            out = _mask_pad_heads(out, h)
            return out.reshape(B, S, h * hd) @ p["wo"], new_cache
    if impl == "kernel":
        out = fa_ops.flash_attention(q, k, v, causal=causal)
    else:
        bias = causal_bias(S, S, device=x.device) if causal else 0.0
        out = _sdpa(q, k, v, bias)
    out = _mask_pad_heads(out, h)
    out = out.reshape(B, S, h * hd) @ p["wo"]
    return out, new_cache


# ----------------------------------------------------------------------------
# SwiGLU FFN
# ----------------------------------------------------------------------------

def init_ffn(generator, cfg: ModelConfig, dtype, device, stack: int = 0):
    d, f = cfg.d_model, cfg.d_ff
    pre = (stack,) if stack else ()
    return {
        "wg": dense_init(generator, pre + (d, f), dtype, d, device),
        "wu": dense_init(generator, pre + (d, f), dtype, d, device),
        "wd": dense_init(generator, pre + (f, d), dtype, f, device),
        "ln": torch.ones(pre + (d,), dtype=dtype, device=device),
    }


def ffn(p, cfg: ModelConfig, x):
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    return (F.silu(xn @ p["wg"]) * (xn @ p["wu"])) @ p["wd"]


# ----------------------------------------------------------------------------
# Embedding / logits (tied)
# ----------------------------------------------------------------------------

def init_embed(generator, cfg: ModelConfig, dtype, device):
    return dense_init(generator, (cfg.padded_vocab, cfg.d_model), dtype,
                      cfg.d_model, device)


def embed(table, tokens):
    return table[tokens.long()]


def logits(table, x):
    """Tied LM head: [B,S,D] @ [V,D]^T -> [B,S,V]."""
    return torch.einsum("bsd,vd->bsv", x, table)
