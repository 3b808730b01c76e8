"""Decoder-only LM stack, dense family (the counterpart of the dense branch
of ``src/repro/models/transformer.py``).

Layers are grouped into *segments* separated by early-exit heads (the
paper's right-sizing knob); each segment's parameters are stacked along a
leading ``[n_units]`` axis as in the reference, and a Python loop over the
units takes the place of its ``lax.scan``.  Exit heads are tied to the
embedding (RMSNorm + shared vocab projection).

The KV cache keeps the reference's per-segment layout, a tuple of dicts of
``[n_units, B, T, KV, hd]`` tensors, and is written in place.

The MoE, VLM-prefix and int8-cache branches wait for their slices
(``ROADMAP.md``); :class:`repro_torch.models.api.Model` refuses them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve
from repro_torch.kernels.exit_head import ops as eh_ops
from repro_torch.kernels.exit_head import ref as eh_ref
from repro_torch.models import layers as L


# ----------------------------------------------------------------------------
# structure: units / segments
# ----------------------------------------------------------------------------

def unit_size(cfg: ModelConfig) -> int:
    if cfg.num_experts and cfg.moe_period == 2:
        return 2
    return 1


def num_units(cfg: ModelConfig) -> int:
    return cfg.num_layers // unit_size(cfg)


def segment_boundaries(cfg: ModelConfig):
    """Exit positions in *units*, strictly inside (0, n_units)."""
    n = num_units(cfg)
    u = unit_size(cfg)
    bounds = []
    for li in cfg.exit_layer_indices():
        b = min(max(1, round(li / u)), n - 1)
        if b not in bounds:
            bounds.append(b)
    return sorted(bounds)


def segment_lengths(cfg: ModelConfig):
    bounds = segment_boundaries(cfg)
    edges = [0] + bounds + [num_units(cfg)]
    return [b - a for a, b in zip(edges[:-1], edges[1:])]


# ----------------------------------------------------------------------------
# params
# ----------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device="cuda"):
    """Random parameters drawn from ``generator`` (a seeded
    :class:`torch.Generator` on ``device``; seed 0 when None).  Torch cannot
    replay the reference's ``jax.random`` stream: to hold the port against
    the reference, convert its parameters with
    :func:`repro_torch.models.convert.params_from_numpy` instead."""
    dev = resolve(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    segs = segment_lengths(cfg)
    params = {"embed": L.init_embed(generator, cfg, dtype, dev)}
    params["segments"] = tuple(
        {"attn": L.init_attn(generator, cfg, dtype, dev, stack=n),
         "ffn": L.init_ffn(generator, cfg, dtype, dev, stack=n)}
        for n in segs)
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    if cfg.num_exits:
        params["exit_norms"] = torch.ones((len(segs) - 1, cfg.d_model),
                                          dtype=dtype, device=dev)
    return params


# ----------------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------------

def _unit(tree, u: int):
    """Unit ``u`` of a stacked parameter/cache dict (views, no copies)."""
    return {k: (_unit(v, u) if isinstance(v, dict) else v[u])
            for k, v in tree.items()}


def _run_segment(cfg, seg_params, x, positions, *, impl="kernel",
                 seg_cache=None, cache_pos=None, lengths=None,
                 prefill_mode=False):
    """Run a segment's stacked units in order.  Returns (x, seg_cache); the
    cache is written in place."""
    n = seg_params["attn"]["wq"].shape[0]
    for u in range(n):
        lp = _unit(seg_params, u)
        kv = None
        if seg_cache is not None:
            kv = (seg_cache["attn_k"][u], seg_cache["attn_v"][u])
        out, _ = L.attention(lp["attn"], cfg, x, positions, kv_cache=kv,
                             cache_pos=cache_pos, lengths=lengths, impl=impl,
                             prefill_mode=prefill_mode)
        x = x + out
        x = x + L.ffn(lp["ffn"], cfg, x)
    return x, seg_cache


def forward(cfg: ModelConfig, params, tokens, *,
            exit_point: Optional[int] = None, impl="kernel",
            collect_exits=True):
    """Eval forward.  Returns a list of (exit_idx, hidden_normed)."""
    B = tokens.shape[0]
    x = L.embed(params["embed"], tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    segs = segment_lengths(cfg)
    n_seg = len(segs) if exit_point is None else exit_point + 1
    outs = []
    for si in range(n_seg):
        x, _ = _run_segment(cfg, params["segments"][si], x, positions, impl=impl)
        is_last = si == n_seg - 1
        if not is_last and cfg.num_exits and collect_exits:
            outs.append((si, L.rms_norm(x, params["exit_norms"][si], cfg.norm_eps)))
        if is_last:
            norm = params["final_norm"] if exit_point in (None, len(segs) - 1) \
                else params["exit_norms"][si]
            outs.append((si, L.rms_norm(x, norm, cfg.norm_eps)))
    return outs


# ----------------------------------------------------------------------------
# KV cache / decode
# ----------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               device="cuda"):
    dev = resolve(device)
    kvh, hd = cfg.num_kv_heads, cfg.hd
    return tuple(
        {"attn_k": torch.zeros((n, batch, max_seq, kvh, hd), dtype=dtype, device=dev),
         "attn_v": torch.zeros((n, batch, max_seq, kvh, hd), dtype=dtype, device=dev)}
        for n in segment_lengths(cfg))


def prefill(cfg: ModelConfig, params, tokens, cache, *, impl="kernel"):
    """Fills cache positions [0, S); returns (final_hidden_last_tok, cache)."""
    B = tokens.shape[0]
    x = L.embed(params["embed"], tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    for si, segp in enumerate(params["segments"]):
        x, _ = _run_segment(cfg, segp, x, positions, impl=impl,
                            seg_cache=cache[si], cache_pos=0, prefill_mode=True)
    h = L.rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    return h, cache


def decode_step(cfg: ModelConfig, params, cache, tokens, pos, *,
                exit_point: Optional[int] = None,
                with_exit_confidence: bool = False, impl="kernel"):
    """One decode step.  tokens: [B,1]; pos: the cache position, an int for
    every row or a [B] integer tensor (one per row).

    ``exit_point`` right-sizes the model: only segments [0, exit_point] run
    and the exit head at that boundary produces the hidden state.
    Returns (normed_hidden [B,1,D], cache, exit_confidences); the cache is
    written in place.  With ``with_exit_confidence`` every intermediate exit
    passed on the way reports its head's (token, conf, entropy) — through the
    exit-head kernel for ``impl="kernel"``, its plain version otherwise."""
    B = tokens.shape[0]
    x = L.embed(params["embed"], tokens)
    if isinstance(pos, torch.Tensor) and pos.ndim == 0:
        pos = int(pos)
    if isinstance(pos, int):
        positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    else:
        positions = pos.to(x.device)[:, None]
    # the decode-attention kernel's key counts, once for every layer
    lengths = L.decode_lengths(pos, B, x.device) if impl == "kernel" else None
    segs = segment_lengths(cfg)
    n_seg = len(segs) if exit_point is None else exit_point + 1
    confs = []
    head = eh_ops.exit_confidence if impl == "kernel" else eh_ref.exit_confidence
    for si in range(n_seg):
        x, _ = _run_segment(cfg, params["segments"][si], x, positions,
                            impl=impl, seg_cache=cache[si], cache_pos=pos,
                            lengths=lengths)
        is_last = si == n_seg - 1
        if with_exit_confidence and not is_last and cfg.num_exits:
            h = L.rms_norm(x, params["exit_norms"][si], cfg.norm_eps)
            confs.append(head(h, params["embed"]))
    norm = params["final_norm"] if exit_point in (None, len(segs) - 1) \
        else params["exit_norms"][n_seg - 1]
    h = L.rms_norm(x, norm, cfg.norm_eps)
    return h, cache, confs
