"""Encoder-decoder backbone (seamless-m4t-large-v2), the counterpart of
``src/repro/models/encdec.py``.

Encoder: a stack of non-causal dense blocks over precomputed audio-frame
embeddings (the modality frontend is a stub, as in the reference: frames
come in as embeddings).  Decoder: causal self-attention, cross-attention
over the encoder memory and an FFN a layer; early-exit heads sit between
decoder segments only.  Cross K/V are computed once a segment at prefill,
from ``rms_norm(memory, xattn.ln)`` without RoPE, and carried in the cache.

Parameters keep the reference's layout: ``encoder`` stacked over
``num_encoder_layers`` beside the decoder ``segments``, each stacked over
its units, and a Python loop over the units takes the place of its
``lax.scan``.  ``impl`` selects attention as in
:func:`repro_torch.models.layers.attention`: with ``"kernel"`` the encoder
and the cross-attention of a prefill run the flash kernel without a mask,
and a decode step's cross-attention the decode kernel over the whole
memory.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import layers as L
from repro_torch.models.transformer import _attn_shard_flags, _units
from repro_torch.obs import spans
from repro_torch.tree import P

AUDIO_DIM = 1024  # stub frontend embedding width (== d_model for seamless)


# ----------------------------------------------------------------------------
# params
# ----------------------------------------------------------------------------

def segment_lengths(cfg: ModelConfig):
    """Decoder segments (exits between them)."""
    L_ = cfg.num_layers
    bounds = []
    for li in cfg.exit_layer_indices():
        b = min(max(1, li), L_ - 1)
        if b not in bounds:
            bounds.append(b)
    edges = [0] + sorted(bounds) + [L_]
    return [b - a for a, b in zip(edges[:-1], edges[1:])]


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device="cuda"):
    """Random parameters drawn from ``generator`` (seed 0 when None); see
    :func:`repro_torch.models.transformer.init_params`."""
    dev = resolve(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    segs = segment_lengths(cfg)
    ne = cfg.num_encoder_layers

    def dec_unit(n):
        return {"attn": L.init_attn(generator, cfg, dtype, dev, stack=n),
                "xattn": L.init_attn(generator, cfg, dtype, dev, stack=n),
                "ffn": L.init_ffn(generator, cfg, dtype, dev, stack=n)}

    params = {
        "embed": L.init_embed(generator, cfg, dtype, dev),
        "audio_proj": L.dense_init(generator, (AUDIO_DIM, cfg.d_model), dtype,
                                   AUDIO_DIM, dev),
        "encoder": {"attn": L.init_attn(generator, cfg, dtype, dev, stack=ne),
                    "ffn": L.init_ffn(generator, cfg, dtype, dev, stack=ne)},
        "enc_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
        "segments": tuple(dec_unit(n) for n in segs),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if cfg.num_exits:
        params["exit_norms"] = torch.ones((len(segs) - 1, cfg.d_model),
                                          dtype=dtype, device=dev)
    return params


def _dec_spec(cfg):
    qs, ks = _attn_shard_flags(cfg)
    sa = L.spec_attn(True, q_shard=qs, kv_shard=ks)
    return {"attn": sa, "xattn": sa, "ffn": L.spec_ffn(True)}


def param_specs(cfg: ModelConfig):
    segs = segment_lengths(cfg)
    specs = {
        "embed": L.spec_embed(),
        "audio_proj": P(None, "data"),
        "encoder": {"attn": L.spec_attn(True, *_attn_shard_flags(cfg)),
                    "ffn": L.spec_ffn(True)},
        "enc_norm": P(None),
        "segments": tuple(_dec_spec(cfg) for _ in segs),
        "final_norm": P(None),
    }
    if cfg.num_exits:
        specs["exit_norms"] = P(None, None)
    return specs


# ----------------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------------

def encode(cfg: ModelConfig, params, frames, *, impl="kernel", remat=False):
    """frames: [B, S_enc, AUDIO_DIM] stub embeddings -> memory [B, S_enc, D]."""
    x = frames.to(params["audio_proj"].dtype) @ params["audio_proj"]
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    enc = params["encoder"]
    for lp in _units(enc, enc["attn"]["wq"].shape[0]):
        def unit(x, lp=lp):
            a, _ = L.attention(lp["attn"], cfg, x, positions, causal=False, impl=impl)
            x = x + a
            return x + L.ffn(lp["ffn"], cfg, x)

        x = checkpoint(unit, x, use_reentrant=False) if remat else unit(x)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _cross_kv(cfg, lp_x, memory):
    """Cross-attention K/V of one stacked segment: memory [B,T,D] -> k/v
    [n, B, T, KV, hd], each unit's from ``rms_norm(memory, ln)``, no RoPE."""
    B, T, _ = memory.shape
    kvh, hd = cfg.num_kv_heads, cfg.hd
    ks, vs = [], []
    for lp in _units(lp_x, lp_x["wq"].shape[0]):
        mn = L.rms_norm(memory, lp["ln"], cfg.norm_eps)
        ks.append((mn @ lp["wk"]).reshape(B, T, kvh, hd))
        vs.append((mn @ lp["wv"]).reshape(B, T, kvh, hd))
    return torch.stack(ks), torch.stack(vs)


def _dec_segment(cfg, segp, x, positions, cross_k, cross_v, *, impl="kernel",
                 seg_cache=None, cache_pos=None, lengths=None, cross_lengths=None,
                 remat=False, prefill_mode=False, write_mask=None):
    """Run a decoder segment's units.  ``seg_cache``: ``{"k", "v"}`` of
    stacked self-attention caches (written in place) or None; ``lengths``
    and ``cross_lengths``: the decode kernel's key counts over the self
    cache and over the memory, built once a step."""
    n = segp["attn"]["wq"].shape[0]
    caches = _units(seg_cache, n) if seg_cache is not None else [None] * n
    for u, (lp, kv) in enumerate(zip(_units(segp, n), caches)):
        def unit(x, lp=lp, kv=kv, u=u):
            a, _ = L.attention(lp["attn"], cfg, x, positions,
                               kv_cache=None if kv is None else (kv["k"], kv["v"]),
                               cache_pos=cache_pos, lengths=lengths, impl=impl,
                               prefill_mode=prefill_mode, write_mask=write_mask)
            x = x + a
            xa, _ = L.attention(lp["xattn"], cfg, x, positions,
                                cross_kv=(cross_k[u], cross_v[u]),
                                lengths=cross_lengths, impl=impl)
            x = x + xa
            return x + L.ffn(lp["ffn"], cfg, x)

        x = checkpoint(unit, x, use_reentrant=False) if remat else unit(x)
    return x


def forward(cfg: ModelConfig, params, tokens, frames, *,
            exit_point: Optional[int] = None, impl="auto", remat=False,
            collect_exits=True):
    """Training/eval forward: the encoder over frames and the teacher-forced
    decoder.  Returns ([(seg_idx, normed_hidden)], aux=0.0)."""
    memory = encode(cfg, params, frames, impl=impl, remat=remat)
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens)
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    segs = segment_lengths(cfg)
    n_seg = len(segs) if exit_point is None else exit_point + 1
    outs = []
    for si in range(n_seg):
        ck, cv = _cross_kv(cfg, params["segments"][si]["xattn"], memory)
        x = _dec_segment(cfg, params["segments"][si], x, positions, ck, cv,
                         impl=impl, remat=remat)
        is_last = si == n_seg - 1
        if not is_last and cfg.num_exits and collect_exits:
            outs.append((si, L.rms_norm(x, params["exit_norms"][si], cfg.norm_eps)))
        if is_last:
            norm = params["final_norm"] if exit_point in (None, len(segs) - 1) \
                else params["exit_norms"][si]
            outs.append((si, L.rms_norm(x, norm, cfg.norm_eps)))
    return outs, 0.0


# ----------------------------------------------------------------------------
# cache / decode
# ----------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, enc_len: int,
               dtype=torch.bfloat16, device="cuda"):
    """``{"self": ({"k", "v"} per segment), "cross_k": (...), "cross_v":
    (...)}``, each leaf [n_units, B, T, KV, hd], T = ``max_seq`` for the
    self-attention caches and ``enc_len`` for the cross ones."""
    dev = resolve(device)
    kvh, hd = cfg.num_kv_heads, cfg.hd
    cache = {"self": [], "cross_k": [], "cross_v": []}
    for n in segment_lengths(cfg):
        cache["self"].append(
            {"k": torch.zeros((n, batch, max_seq, kvh, hd), dtype=dtype, device=dev),
             "v": torch.zeros((n, batch, max_seq, kvh, hd), dtype=dtype, device=dev)})
        for key in ("cross_k", "cross_v"):
            cache[key].append(torch.zeros((n, batch, enc_len, kvh, hd), dtype=dtype,
                                          device=dev))
    return {k: tuple(v) for k, v in cache.items()}


def cache_specs(cfg: ModelConfig, batch_axes, seq_axes="model"):
    self_spec = P(None, batch_axes, seq_axes, None, None)
    segs = segment_lengths(cfg)
    return {
        "self": tuple({"k": self_spec, "v": self_spec} for _ in segs),
        "cross_k": tuple(self_spec for _ in segs),
        "cross_v": tuple(self_spec for _ in segs),
    }


def prefill(cfg: ModelConfig, params, tokens, cache, frames, *, impl="kernel"):
    """Encode ``frames`` and run the teacher-forced decoder prefill: the
    self caches are written in place at [0, S), and the cross caches are
    replaced by the memory's K/V in the cache's dtype, as the reference's
    prefill replaces them — at the memory's length, whatever ``enc_len``
    the cache was built with, so no row of an earlier memory is left.
    Returns (final_hidden_last_tok, cache)."""
    memory = encode(cfg, params, frames, impl=impl)
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens)
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    cross_k, cross_v = [], []
    for si, segp in enumerate(params["segments"]):
        with spans.segment(si, segment_lengths(cfg)[si]) if spans.on() else spans.OFF:
            ck, cv = _cross_kv(cfg, segp["xattn"], memory)
            x = _dec_segment(cfg, segp, x, positions, ck, cv, impl=impl,
                             seg_cache=cache["self"][si], cache_pos=0, prefill_mode=True)
        cross_k.append(ck.to(cache["cross_k"][si].dtype))
        cross_v.append(cv.to(cache["cross_v"][si].dtype))
    cache["cross_k"], cache["cross_v"] = tuple(cross_k), tuple(cross_v)
    h = L.rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    return h, cache


def decode_step(cfg: ModelConfig, params, cache, tokens, pos, *,
                exit_point: Optional[int] = None, impl="kernel", mask=None):
    """One decoder step against the filled self and cross caches.  tokens
    [B, 1]; pos an int or a [B] tensor; ``mask`` as the transformer's.
    Returns (normed_hidden [B, 1, D], cache, []): the reference's decoder
    reports no intermediate exits."""
    B = tokens.shape[0]
    x = L.embed(params["embed"], tokens)
    if isinstance(pos, torch.Tensor) and pos.ndim == 0:
        pos = int(pos)
    if isinstance(pos, int):
        positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    else:
        positions = pos.to(x.device)[:, None]
    lengths = cross_lengths = None
    if impl == "kernel":
        lengths = L.decode_lengths(pos, B, x.device)
        cross_lengths = torch.full((B,), cache["cross_k"][0].shape[2],
                                   dtype=torch.int32, device=x.device)
    segs = segment_lengths(cfg)
    n_seg = len(segs) if exit_point is None else exit_point + 1
    for si in range(n_seg):
        with spans.segment(si, segs[si]) if spans.on() else spans.OFF:
            x = _dec_segment(cfg, params["segments"][si], x, positions,
                             cache["cross_k"][si], cache["cross_v"][si], impl=impl,
                             seg_cache=cache["self"][si], cache_pos=pos, lengths=lengths,
                             cross_lengths=cross_lengths, write_mask=mask)
    norm = params["final_norm"] if exit_point in (None, len(segs) - 1) \
        else params["exit_norms"][n_seg - 1]
    h = L.rms_norm(x, norm, cfg.norm_eps)
    return h, cache, []
