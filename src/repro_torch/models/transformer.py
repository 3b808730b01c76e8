"""Decoder-only LM stack, dense / MoE / VLM families (the counterpart of
``src/repro/models/transformer.py``).

Layers are grouped into *segments* separated by early-exit heads (the
paper's right-sizing knob); each segment's parameters are stacked along a
leading ``[n_units]`` axis as in the reference, and a Python loop over the
units takes the place of its ``lax.scan``.  A unit is one layer, attention
and a SwiGLU FFN (dense) or the top-1 MoE FFN (``moe_period`` 1,
llama4-scout); for ``moe_period == 2`` (llama4-maverick) it is the pair
``attn0, ffn, attn1, moe``.  The MoE's auxiliary loss is summed over the
units and returned by :func:`forward`.  The VLM (``frontend == "vision"``)
puts ``prefix_emb @ mm_proj`` in front of the text embeddings, so its
positions run 0..P+S-1.  Exit heads are tied to the embedding (RMSNorm +
shared vocab projection).  With ``remat`` each unit runs under
``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of its scan
body.

The KV cache keeps the reference's per-segment layout, a tuple of dicts of
``[n_units, B, T, KV, hd]`` tensors keyed ``attn_k``/``attn_v`` (or
``attn0_*``/``attn1_*``), and is written in place; the int8 cache
(``init_cache(quant=True)``) adds ``*_k_scale``/``*_v_scale`` bf16 leaves
``[n_units, B, T, KV]``.

A prefill of left-padded rows of unequal prompts may compute the rows'
shared pad prefix once (:func:`prefill`'s ``lengths``, where
:func:`shares_pad_prefix`): one packed sequence of the prefix and each row's
prompt, whose attention reads every row's pads back from its cache row.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.config import MODEL_AXIS_SIZE, ModelConfig
from repro_torch.device import resolve
from repro_torch.kernels.exit_head import ops as eh_ops
from repro_torch.kernels.exit_head import ref as eh_ref
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.obs import spans
from repro_torch import spmd
from repro_torch.tree import P

VIS_DIM = 1024  # stub modality-frontend embedding width


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

def attn_names(cfg: ModelConfig):
    """The attention blocks of a unit, which name its cache leaves."""
    return ["attn0", "attn1"] if (cfg.num_experts and unit_size(cfg) == 2) else ["attn"]


def _init_unit(generator, cfg: ModelConfig, dtype, dev, n: int):
    if n == 0:
        # a segment of no units (an exit before the first unit, as a
        # two-layer llama4-maverick's one unit gives segments [0, 1]): an
        # empty stack.  ``stack=0`` would build one unstacked unit whose
        # weights no forward reads, and whose leading axes the unit loop
        # (the reference's scan) would take for the unit count
        unit = _init_unit(None, cfg, dtype, torch.device("meta"), 1)
        return _empty_stack(unit, dev)
    if cfg.num_experts and unit_size(cfg) == 2:
        return {"attn0": L.init_attn(generator, cfg, dtype, dev, stack=n),
                "ffn": L.init_ffn(generator, cfg, dtype, dev, stack=n),
                "attn1": L.init_attn(generator, cfg, dtype, dev, stack=n),
                "moe": MOE.init_moe(generator, cfg, dtype, dev, stack=n)}
    if cfg.num_experts:
        return {"attn": L.init_attn(generator, cfg, dtype, dev, stack=n),
                "moe": MOE.init_moe(generator, cfg, dtype, dev, stack=n)}
    return {"attn": L.init_attn(generator, cfg, dtype, dev, stack=n),
            "ffn": L.init_ffn(generator, cfg, dtype, dev, stack=n)}


def _empty_stack(unit, dev):
    return {k: _empty_stack(v, dev) if isinstance(v, dict)
            else torch.empty((0,) + v.shape[1:], dtype=v.dtype, device=dev)
            for k, v in unit.items()}


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device="cuda"):
    """Random parameters drawn from ``generator`` (a seeded
    :class:`torch.Generator` on ``device``; seed 0 when None).  Torch cannot
    replay the reference's ``jax.random`` stream: to hold the port against
    the reference, convert its parameters with
    :func:`repro_torch.models.convert.params_from_numpy` instead.  The MoE
    router is float32 whatever ``dtype``."""
    dev = resolve(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    segs = segment_lengths(cfg)
    params = {"embed": L.init_embed(generator, cfg, dtype, dev)}
    params["segments"] = tuple(_init_unit(generator, cfg, dtype, dev, n) for n in segs)
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    if cfg.num_exits:
        params["exit_norms"] = torch.ones((len(segs) - 1, cfg.d_model),
                                          dtype=dtype, device=dev)
    if cfg.frontend == "vision":
        params["mm_proj"] = L.dense_init(generator, (VIS_DIM, cfg.d_model), dtype,
                                         VIS_DIM, dev)
    return params


def _attn_shard_flags(cfg: ModelConfig):
    """(q_shard, kv_shard): whether whole padded query / key heads divide
    the production ``model`` axis."""
    return (cfg.padded_heads % MODEL_AXIS_SIZE == 0,
            cfg.num_kv_heads % MODEL_AXIS_SIZE == 0)


def _spec_unit(cfg: ModelConfig):
    qs, ks = _attn_shard_flags(cfg)
    sa = L.spec_attn(True, q_shard=qs, kv_shard=ks)
    if cfg.num_experts and unit_size(cfg) == 2:
        return {"attn0": sa, "ffn": L.spec_ffn(True),
                "attn1": sa, "moe": MOE.spec_moe(True)}
    if cfg.num_experts:
        return {"attn": sa, "moe": MOE.spec_moe(True)}
    return {"attn": sa, "ffn": L.spec_ffn(True)}


def param_specs(cfg: ModelConfig):
    """The reference's ``param_specs``: a spec tree congruent with
    :func:`init_params`."""
    segs = segment_lengths(cfg)
    specs = {
        "embed": L.spec_embed(),
        "segments": tuple(_spec_unit(cfg) for _ in segs),
        "final_norm": P(None),
    }
    if cfg.num_exits:
        specs["exit_norms"] = P(None, None)
    if cfg.frontend == "vision":
        specs["mm_proj"] = P(None, "data")
    return specs


# ----------------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------------

def _units(tree, n: int):
    """The ``n`` units of a stacked parameter dict, as views (one
    ``unbind`` per leaf, whose backward stacks the units' grads once)."""
    flat = {k: (_units(v, n) if isinstance(v, dict) else torch.unbind(v))
            for k, v in tree.items()}
    return [{k: v[u] for k, v in flat.items()} for u in range(n)]


def _seq_shard(x):
    """Sequence parallelism (the reference's ``_seq_shard``): the residual
    stream of a sharded run redistributed to its sequence split over the
    ``model`` axis between blocks, the other mesh axes as they are, so the
    tensor-parallel output reductions become reduce-scatters and
    all-gathers.  A plain tensor is returned as it is."""
    if not isinstance(x, DTensor) or "model" not in x.device_mesh.mesh_dim_names:
        return x
    pl = list(x.placements)
    pl[x.device_mesh.mesh_dim_names.index("model")] = Shard(1)
    return x.redistribute(x.device_mesh, pl)


def _unit_fwd(cfg, lp, x, positions, *, impl, kv, cache_pos, lengths,
              prefill_mode, write_mask, moe_dispatch, seq_parallel=False, pack=None):
    """One unit.  ``kv``: this unit's cache leaves by name (``attn_k``, ...)
    or None; ``pack``: a packed prefill's :class:`~repro_torch.models.layers.PadPrefix`.
    Returns (x, aux)."""
    aux = 0.0
    x0 = x
    maybe_shard = _seq_shard if seq_parallel else (lambda x: spmd.pin(x, x0))

    def attn(name, x):
        c = None
        if kv is not None:
            if name + "_k_scale" in kv:
                c = {sfx: kv[f"{name}_{sfx}"] for sfx in ("k", "v", "k_scale", "v_scale")}
            else:
                c = (kv[name + "_k"], kv[name + "_v"])
        out, _ = L.attention(lp[name], cfg, x, positions, kv_cache=c,
                             cache_pos=cache_pos, lengths=lengths, impl=impl,
                             prefill_mode=prefill_mode, write_mask=write_mask, pack=pack)
        return x + out

    if cfg.num_experts and unit_size(cfg) == 2:
        x = maybe_shard(attn("attn0", x))
        x = maybe_shard(x + L.ffn(lp["ffn"], cfg, x))
        x = maybe_shard(attn("attn1", x))
        mo, aux = MOE.moe_ffn(lp["moe"], cfg, x, dispatch_mode=moe_dispatch)
        x = maybe_shard(x + mo)
    elif cfg.num_experts:
        x = maybe_shard(attn("attn", x))
        mo, aux = MOE.moe_ffn(lp["moe"], cfg, x, dispatch_mode=moe_dispatch)
        x = maybe_shard(x + mo)
    else:
        x = maybe_shard(attn("attn", x))
        x = maybe_shard(x + L.ffn(lp["ffn"], cfg, x))
    return x, aux


def _run_segment(cfg, seg_params, x, positions, *, impl="kernel",
                 seg_cache=None, cache_pos=None, lengths=None,
                 prefill_mode=False, write_mask=None, remat=False,
                 moe_dispatch="einsum", seq_parallel=False, pack=None):
    """Run a segment's stacked units in order.  Returns (x, aux_sum,
    seg_cache); the cache is written in place (only the rows of
    ``write_mask`` when given).  ``remat`` (no cache) checkpoints each
    unit."""
    n = seg_params[attn_names(cfg)[0]]["wq"].shape[0]
    caches = _units(seg_cache, n) if seg_cache is not None else [None] * n
    aux = 0.0
    for lp, kv in zip(_units(seg_params, n), caches):
        def unit(x, lp=lp, kv=kv):
            return _unit_fwd(cfg, lp, x, positions, impl=impl, kv=kv,
                             cache_pos=cache_pos, lengths=lengths,
                             prefill_mode=prefill_mode, write_mask=write_mask,
                             moe_dispatch=moe_dispatch, seq_parallel=seq_parallel,
                             pack=pack)

        x, a = checkpoint(unit, x, use_reentrant=False) if remat else unit(x)
        aux = aux + a
    return x, aux, seg_cache


def _embed_inputs(cfg, params, tokens, prefix_emb):
    """Token embeddings, with the VLM's projected prefix in front."""
    x = L.embed(params["embed"], tokens)
    if cfg.frontend == "vision" and prefix_emb is not None:
        px = prefix_emb.to(x.dtype) @ params["mm_proj"]
        x = torch.cat([px, x], dim=1)
    return x


def forward(cfg: ModelConfig, params, tokens, prefix_emb=None, *,
            exit_point: Optional[int] = None, impl="auto", remat=False,
            collect_exits=True, moe_dispatch="einsum", seq_parallel=False):
    """Training/eval forward.  Returns (list of (exit_idx, hidden_normed),
    aux_loss): the MoE's load-balancing loss summed over its units (0.0 for
    the dense family).  Hidden states are returned (not logits) so callers
    fuse the vocab projection with their loss or confidence computation; a
    VLM's cover its P prefix positions too.  ``seq_parallel``: see
    :func:`_seq_shard`."""
    B = tokens.shape[0]
    x = _embed_inputs(cfg, params, tokens, prefix_emb)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    segs = segment_lengths(cfg)
    n_seg = len(segs) if exit_point is None else exit_point + 1
    outs = []
    aux = 0.0
    for si in range(n_seg):
        x, a, _ = _run_segment(cfg, params["segments"][si], x, positions, impl=impl,
                               remat=remat, moe_dispatch=moe_dispatch,
                               seq_parallel=seq_parallel)
        aux = aux + a
        is_last = si == n_seg - 1
        if not is_last and cfg.num_exits and collect_exits:
            outs.append((si, L.rms_norm(x, params["exit_norms"][si], cfg.norm_eps)))
        if is_last:
            norm = params["final_norm"] if exit_point in (None, len(segs) - 1) \
                else params["exit_norms"][si]
            outs.append((si, L.rms_norm(x, norm, cfg.norm_eps)))
    return outs, aux


# ----------------------------------------------------------------------------
# KV cache / decode
# ----------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               device="cuda", quant: bool = False):
    """Zeroed KV cache.  ``quant``: the int8 cache, int8 k/v with bf16
    scales per (position, kv head), whatever ``dtype``."""
    dev = resolve(device)
    kvh, hd = cfg.num_kv_heads, cfg.hd
    cache = []
    for n in segment_lengths(cfg):
        seg = {}
        for nm in attn_names(cfg):
            shape = (n, batch, max_seq, kvh, hd)
            kdt = torch.int8 if quant else dtype
            seg[nm + "_k"] = torch.zeros(shape, dtype=kdt, device=dev)
            seg[nm + "_v"] = torch.zeros(shape, dtype=kdt, device=dev)
            if quant:
                seg[nm + "_k_scale"] = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                                   device=dev)
                seg[nm + "_v_scale"] = torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                                   device=dev)
        cache.append(seg)
    return tuple(cache)


def cache_specs(cfg: ModelConfig, batch_axes, seq_axes="model", quant: bool = False):
    """Spec tree of :func:`init_cache`: batch over ``batch_axes``, the
    sequence over ``seq_axes``."""
    spec = P(None, batch_axes, seq_axes, None, None)
    sspec = P(None, batch_axes, seq_axes, None)
    out = []
    for _ in segment_lengths(cfg):
        seg = {nm + sfx: spec for nm in attn_names(cfg) for sfx in ("_k", "_v")}
        if quant:
            seg.update({nm + sfx: sspec for nm in attn_names(cfg)
                        for sfx in ("_k_scale", "_v_scale")})
        out.append(seg)
    return tuple(out)


def shares_pad_prefix(cfg: ModelConfig, params, cache, prefix_emb=None) -> bool:
    """Whether :func:`prefill` may compute left-padded rows' shared pad
    prefix once (its ``lengths``): only where that is the padded prefill's
    own arithmetic.  Not with experts (an expert's capacity is counted over
    the rows' tokens, so regrouping them changes what is dropped), nor with
    a VLM's prefix (its rows do not start with their pads), nor with an
    int8 cache (a padded prefill attends on the unquantized keys of its own
    block, a packed row would read its pads back quantized) or a cache in
    another dtype than the parameters', nor on DTensors (a mesh)."""
    if cfg.num_experts or prefix_emb is not None:
        return False
    dt = params["embed"].dtype
    leaves = [t for seg in cache for t in seg.values()]
    return (not any(spmd.is_dtensor(t) for t in [params["embed"]] + leaves)
            and not any(k.endswith("_scale") for seg in cache for k in seg)
            and all(t.dtype == dt for t in leaves))


def prefill(cfg: ModelConfig, params, tokens, cache, prefix_emb=None, *,
            impl="kernel", moe_dispatch="einsum", lengths=None):
    """Fills cache positions [0, P + S) (P prefix positions for a VLM given
    ``prefix_emb``); returns (final_hidden_last_tok, cache).

    ``lengths`` (host ints, one per row, where :func:`shares_pad_prefix`):
    the rows' prompt lengths, each row of ``tokens`` [B, S] left-padded to S
    with the same pad token in every row.  The rows' pad prefix is then
    computed once and each row's prompt after it, N = S - min(lengths) +
    sum(lengths) positions in one [1, N] sequence
    (:class:`~repro_torch.models.layers.PadPrefix`) instead of B x S: the
    same cache and hidden states up to the rounding of products at other
    shapes."""
    if lengths is not None and min(lengths) < tokens.shape[1]:
        return _prefill_pad_prefix(cfg, params, tokens, cache, lengths, impl, prefix_emb)
    B = tokens.shape[0]
    x = _embed_inputs(cfg, params, tokens, prefix_emb)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    for si, segp in enumerate(params["segments"]):
        with spans.segment(si, segment_lengths(cfg)[si]) if spans.on() else spans.OFF:
            x, _, _ = _run_segment(cfg, segp, x, positions, impl=impl,
                                   seg_cache=cache[si], cache_pos=0, prefill_mode=True,
                                   moe_dispatch=moe_dispatch)
    h = L.rms_norm(x[:, -1:, :], params["final_norm"], cfg.norm_eps)
    return h, cache


def _prefill_pad_prefix(cfg, params, tokens, cache, lengths, impl, prefix_emb):
    """:func:`prefill` with ``lengths``: one packed sequence through every
    segment, attention by :func:`~repro_torch.models.layers._attend_pad_prefix`."""
    if not shares_pad_prefix(cfg, params, cache, prefix_emb):
        raise ValueError(f"{cfg.name}: this prefill cannot share the pad prefix "
                         "(see shares_pad_prefix)")
    B, S = tokens.shape
    if len(lengths) != B:
        raise ValueError(f"{len(lengths)} lengths for {B} rows")
    pack = L.pad_prefix(lengths, S, tokens.device)
    x = L.embed(params["embed"], tokens.reshape(-1)[pack.take][None])
    segs = segment_lengths(cfg)
    for si, segp in enumerate(params["segments"]):
        with spans.segment(si, segs[si]) if spans.on() else spans.OFF:
            x, _, _ = _run_segment(cfg, segp, x, pack.positions, impl=impl,
                                   seg_cache=cache[si], prefill_mode=True, pack=pack)
    h = L.rms_norm(x[0, pack.last][:, None], params["final_norm"], cfg.norm_eps)
    return h, cache


def decode_step(cfg: ModelConfig, params, cache, tokens, pos, *,
                exit_point: Optional[int] = None,
                with_exit_confidence: bool = False, impl="kernel", mask=None,
                moe_dispatch="einsum"):
    """One decode step.  tokens: [B,1]; pos: the cache position, an int for
    every row or a [B] integer tensor (one per row).  ``mask`` ([B] bool)
    commits the cache writes of the rows it selects only; every other row
    keeps its cache bit for bit (the arena's masked commit).

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
        with spans.segment(si, segs[si]) if spans.on() else spans.OFF:
            x, _, _ = _run_segment(cfg, params["segments"][si], x, positions,
                                   impl=impl, seg_cache=cache[si], cache_pos=pos,
                                   lengths=lengths, write_mask=mask,
                                   moe_dispatch=moe_dispatch)
        is_last = si == n_seg - 1
        if with_exit_confidence and not is_last and cfg.num_exits:
            h = L.rms_norm(x, params["exit_norms"][si], cfg.norm_eps)
            with spans.span("kernel.exit_head") if spans.on() else spans.OFF:
                confs.append(head(h, params["embed"]))
    norm = params["final_norm"] if exit_point in (None, len(segs) - 1) \
        else params["exit_norms"][n_seg - 1]
    h = L.rms_norm(x, norm, cfg.norm_eps)
    return h, cache, confs
