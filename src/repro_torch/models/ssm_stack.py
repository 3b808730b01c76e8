"""Stacks for the attention-free / hybrid families (the counterpart of
``src/repro/models/ssm_stack.py``).

* ``ssm``    — rwkv6-3b: RWKV-6 blocks; recurrent state replaces the KV
  cache (O(1) decode).
* ``hybrid`` — zamba2-2.7b: Mamba-2 blocks with one weight-SHARED
  attention+FFN block applied every ``hybrid_attn_period`` blocks.  Segments
  are aligned to the period so the unit is (period x mamba blocks, shared
  attn).

Early-exit heads sit between segments, exactly as in ``transformer.py``.
Each segment's parameters and state are stacked along a leading
``[n_units]`` axis as in the reference; a Python loop over the units takes
the place of its ``lax.scan``.  The recurrent state is returned as new
tensors, as the reference does; the hybrid's shared-attention KV cache is
written in place, as the dense family's.  ``impl`` selects the scan and the
shared attention: ``"kernel"``, the port's kernels through their wrappers;
any other choice of :func:`repro_torch.models.layers.attention` (``"dense"``,
``"auto"``, ``"flash"``, ...), the reference's plain scan dispatch with that
attention.  ``remat`` checkpoints each unit, as the reference's
``jax.checkpoint`` of its scan body.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import MODEL_AXIS_SIZE, ModelConfig
from repro_torch.device import resolve
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import rwkv6 as R6
from repro_torch.obs import spans
from repro_torch.tree import P


def _round_to(x, m):
    return max(m, int(round(x / m)) * m)


def segment_lengths(cfg: ModelConfig):
    unit = cfg.hybrid_attn_period if cfg.family == "hybrid" else 1
    L_ = cfg.num_layers
    bounds = []
    for li in cfg.exit_layer_indices():
        b = min(max(unit, _round_to(li, unit)), L_ - unit)
        if b not in bounds:
            bounds.append(b)
    edges = [0] + sorted(bounds) + [L_]
    return [b - a for a, b in zip(edges[:-1], edges[1:])]


# ----------------------------------------------------------------------------
# params
# ----------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator=None, dtype=torch.bfloat16,
                device="cuda"):
    """Random parameters drawn from ``generator`` (seed 0 when None); see
    :func:`repro_torch.models.transformer.init_params`."""
    dev = resolve(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    segs = segment_lengths(cfg)
    init_layer = R6.init_layer if cfg.family == "ssm" else M2.init_layer
    params = {
        "embed": L.init_embed(generator, cfg, dtype, dev),
        "segments": tuple(init_layer(generator, cfg, dtype, dev, stack=n)
                          for n in segs),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if cfg.family == "hybrid":
        params["shared_attn"] = L.init_attn(generator, cfg, dtype, dev)
        params["shared_ffn"] = L.init_ffn(generator, cfg, dtype, dev)
    if cfg.num_exits:
        params["exit_norms"] = torch.ones((len(segs) - 1, cfg.d_model),
                                          dtype=dtype, device=dev)
    return params


def param_specs(cfg: ModelConfig):
    segs = segment_lengths(cfg)
    spec_layer = R6.spec_layer if cfg.family == "ssm" else M2.spec_layer
    specs = {
        "embed": L.spec_embed(),
        "segments": tuple(spec_layer(True) for _ in segs),
        "final_norm": P(None),
    }
    if cfg.family == "hybrid":
        specs["shared_attn"] = L.spec_attn(
            False, q_shard=cfg.padded_heads % MODEL_AXIS_SIZE == 0,
            kv_shard=cfg.num_kv_heads % MODEL_AXIS_SIZE == 0)
        specs["shared_ffn"] = L.spec_ffn(False)
    if cfg.num_exits:
        specs["exit_norms"] = P(None, None)
    return specs


# ----------------------------------------------------------------------------
# state ("cache") — the recurrent state that ships at a partition cut
# ----------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               device="cuda"):
    dev = resolve(device)
    f32 = dict(dtype=torch.float32, device=dev)
    segs = []
    for n in segment_lengths(cfg):
        if cfg.family == "ssm":
            segs.append({
                "wkv": torch.zeros((n, batch, cfg.num_heads, cfg.hd, cfg.hd), **f32),
                "last_tm": torch.zeros((n, batch, 1, cfg.d_model), **f32),
                "last_cm": torch.zeros((n, batch, 1, cfg.d_model), **f32),
            })
        else:
            hm, ns = M2.n_heads(cfg), cfg.ssm_state
            segs.append({
                "ssm": torch.zeros((n, batch, hm, ns, M2.DH), **f32),
                "conv": torch.zeros((n, batch, M2.CONV_W - 1, M2.d_inner(cfg) + 2 * ns),
                                    **f32),
            })
    cache = {"segments": tuple(segs)}
    if cfg.family == "hybrid":
        napp = cfg.num_layers // cfg.hybrid_attn_period
        shape = (napp, batch, max_seq, cfg.num_kv_heads, cfg.hd)
        cache["shared_k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["shared_v"] = torch.zeros(shape, dtype=dtype, device=dev)
    return cache


def cache_specs(cfg: ModelConfig, batch_axes, seq_axes="model"):
    """Spec tree of :func:`init_cache`.  RWKV's heads (40) do not divide the
    model axis, so its state shards the key channels; Mamba-2's shards the
    state dim N by the same rule."""
    segs = []
    for _ in segment_lengths(cfg):
        if cfg.family == "ssm":
            segs.append({"wkv": P(None, batch_axes, None, "model", None),
                         "last_tm": P(None, batch_axes, None, None),
                         "last_cm": P(None, batch_axes, None, None)})
        else:
            segs.append({"ssm": P(None, batch_axes, None, "model", None),
                         "conv": P(None, batch_axes, None, "model")})
    out = {"segments": tuple(segs)}
    if cfg.family == "hybrid":
        out["shared_k"] = P(None, batch_axes, seq_axes, None, None)
        out["shared_v"] = P(None, batch_axes, seq_axes, None, None)
    return out


# ----------------------------------------------------------------------------
# segment runners
# ----------------------------------------------------------------------------

def _units(tree, n: int):
    """The ``n`` units of a stacked dict, as views (one ``unbind`` per
    leaf, whose backward stacks the units' grads once)."""
    flat = {k: torch.unbind(v) for k, v in tree.items()}
    return [{k: v[u] for k, v in flat.items()} for u in range(n)]


def _scan_impl(impl: str) -> str:
    """The scan of a stack run with attention ``impl``: the kernel for
    ``"kernel"``, the reference's plain dispatch for every other choice."""
    return "kernel" if impl == "kernel" else "dense"


def _maybe_remat(fn, x, remat):
    return checkpoint(fn, x, use_reentrant=False) if remat else fn(x)


def _run_rwkv_segment(cfg, segp, x, seg_state, *, mode="auto", impl="kernel",
                      remat=False, chunk=16):
    n = seg_state["wkv"].shape[0]
    scan = _scan_impl(impl)
    wkv, last_tm, last_cm = [], [], []
    for lp, st in zip(_units(segp, n), _units(seg_state, n)):
        def body(x, lp=lp, st=st):
            return R6.block(lp, cfg, x, st["wkv"],
                            (st["last_tm"].to(x.dtype), st["last_cm"].to(x.dtype)),
                            mode=mode, impl=scan, chunk=chunk)

        x, s, lasts = _maybe_remat(body, x, remat)
        wkv.append(s)
        last_tm.append(lasts[0].float())
        last_cm.append(lasts[1].float())
    return x, {"wkv": torch.stack(wkv), "last_tm": torch.stack(last_tm),
               "last_cm": torch.stack(last_cm)}


def _run_mamba_segment(cfg, params, segp, x, seg_state, shared_cache, positions,
                       *, mode="auto", impl="kernel", cache_pos=None,
                       prefill_mode=False, write_mask=None, remat=False, chunk=16):
    """Segment of ``n`` mamba blocks; the shared attn block after every
    ``hybrid_attn_period`` blocks.  ``shared_cache``: (k, v) views of this
    segment's applications, [napp_seg, B, T, KV, hd] (written in place, only
    the rows of ``write_mask`` when given), or None (no cache).  ``remat``
    checkpoints each (period blocks, shared block) unit, as the reference's
    ``jax.checkpoint`` of its super-unit."""
    period = cfg.hybrid_attn_period
    n = seg_state["ssm"].shape[0]
    scan = _scan_impl(impl)
    lps, sts = _units(segp, n), _units(seg_state, n)
    ssm, conv = [], []
    for a in range(n // period):
        us = range(a * period, (a + 1) * period)
        kv = None if shared_cache is None else (shared_cache[0][a], shared_cache[1][a])

        def body(x, us=us, kv=kv):
            ss, cs = [], []
            for u in us:
                o, s, c = M2.block(lps[u], cfg, x, sts[u]["ssm"],
                                   sts[u]["conv"].to(x.dtype), mode=mode,
                                   impl=scan, chunk=chunk)
                x = x + o
                ss.append(s)
                cs.append(c.float())
            # weight-shared attention + ffn block
            out, _ = L.attention(params["shared_attn"], cfg, x, positions,
                                 kv_cache=kv, cache_pos=cache_pos, impl=impl,
                                 prefill_mode=prefill_mode, write_mask=write_mask)
            x = x + out
            return x + L.ffn(params["shared_ffn"], cfg, x), ss, cs

        x, ss, cs = _maybe_remat(body, x, remat)
        ssm += ss
        conv += cs
    return x, {"ssm": torch.stack(ssm), "conv": torch.stack(conv)}


# ----------------------------------------------------------------------------
# public API (mirrors transformer.py)
# ----------------------------------------------------------------------------

def _stack_forward(cfg, params, x, cache, *, mode, exit_point=None,
                   collect_exits=True, impl="kernel", cache_pos=None,
                   prefill_mode=False, write_mask=None, remat=False, chunk=16):
    """Run segments [0, exit_point] (all when None).  Segments past the exit
    are not run: their state stays as it was (stale), as in the reference.
    Returns (outs, new_cache); ``outs`` is a list of (segment, normed
    hidden)."""
    B, S, _ = x.shape
    base = 0 if cache_pos is None else cache_pos
    if isinstance(base, torch.Tensor) and base.ndim == 1:
        base = base.to(x.device)[:, None]
    positions = (base + torch.arange(S, device=x.device)[None]).expand(B, S)
    segs = segment_lengths(cfg)
    n_seg = len(segs) if exit_point is None else exit_point + 1
    new_segments = list(cache["segments"])
    outs = []
    app_off = 0
    for si in range(n_seg):
        segp = params["segments"][si]
        with spans.segment(si, segs[si]) if spans.on() else spans.OFF:
            if cfg.family == "ssm":
                x, nst = _run_rwkv_segment(cfg, segp, x, cache["segments"][si],
                                           mode=mode, impl=impl, remat=remat,
                                           chunk=chunk)
            else:
                napp = segs[si] // cfg.hybrid_attn_period
                shared = None
                if "shared_k" in cache:
                    shared = (cache["shared_k"][app_off:app_off + napp],
                              cache["shared_v"][app_off:app_off + napp])
                x, nst = _run_mamba_segment(cfg, params, segp, x, cache["segments"][si],
                                            shared, positions, mode=mode, impl=impl,
                                            cache_pos=cache_pos, prefill_mode=prefill_mode,
                                            write_mask=write_mask, remat=remat,
                                            chunk=chunk)
                app_off += napp
        new_segments[si] = nst
        is_last = si == n_seg - 1
        if not is_last and cfg.num_exits and collect_exits:
            outs.append((si, L.rms_norm(x, params["exit_norms"][si], cfg.norm_eps)))
        if is_last:
            norm = params["final_norm"] if exit_point in (None, len(segs) - 1) \
                else params["exit_norms"][si]
            outs.append((si, L.rms_norm(x, norm, cfg.norm_eps)))
    return outs, dict(cache, segments=tuple(new_segments))


def forward(cfg: ModelConfig, params, tokens, *, exit_point=None,
            collect_exits=True, impl="auto", remat=False, scan_chunk=16):
    """Training/eval forward from a zero state.  Returns (list of (exit_idx,
    hidden_normed), aux_loss = 0.0).  ``impl`` is the hybrid's shared
    attention; the scan is the kernel for ``"kernel"`` and otherwise the
    reference's plain dispatch (``mode="auto"``: chunks of ``scan_chunk``
    where the sequence divides into them, else sequential).  The shared
    attention attends within the sequence, so no KV cache is kept."""
    x = L.embed(params["embed"], tokens)
    state = init_cache(cfg, tokens.shape[0], max_seq=tokens.shape[1],
                       dtype=x.dtype, device=x.device)["segments"]
    outs, _ = _stack_forward(cfg, params, x, {"segments": state}, mode="auto",
                             exit_point=exit_point, collect_exits=collect_exits,
                             impl=impl, prefill_mode=True, remat=remat,
                             chunk=scan_chunk,
                             cache_pos=0 if cfg.family == "hybrid" else None)
    return outs, 0.0


def prefill(cfg: ModelConfig, params, tokens, cache, *, impl="kernel"):
    """Runs the prompt through every segment; the hybrid writes its shared
    attention's KV at [0, S).  Returns (final_hidden_last_tok, cache)."""
    x = L.embed(params["embed"], tokens)
    outs, new_cache = _stack_forward(cfg, params, x, cache, mode="auto",
                                     collect_exits=False, impl=impl,
                                     prefill_mode=True,
                                     cache_pos=0 if cfg.family == "hybrid" else None)
    _, h = outs[-1]
    return h[:, -1:, :], new_cache


def _commit_rows(mask, new, old):
    """The rows of ``mask`` from ``new``, the others from ``old``, along the
    batch axis (axis 1 of every state leaf), as the reference's masked
    commit.  A leaf the step did not run (a segment past the exit) is
    ``old`` itself and stays so."""
    if new is old:
        return old
    return torch.where(mask.view((1, -1) + (1,) * (new.ndim - 2)), new, old)


def decode_step(cfg: ModelConfig, params, cache, tokens, pos, *,
                exit_point=None, impl="kernel", mask=None):
    """One decode step (tokens [B,1]; ``pos`` an int or a [B] tensor) through
    segments [0, exit_point].  Returns (normed_hidden [B,1,D], cache, []):
    these families report no intermediate exit confidences, as the
    reference.  ``mask`` ([B] bool) commits the new state of the rows it
    selects only: the recurrent state through :func:`_commit_rows`, the
    hybrid's shared KV cache in place; every other row keeps its state bit
    for bit (the arena's masked commit)."""
    if isinstance(pos, torch.Tensor) and pos.ndim == 0:
        pos = int(pos)
    x = L.embed(params["embed"], tokens)
    outs, new_cache = _stack_forward(cfg, params, x, cache, mode="sequential",
                                     exit_point=exit_point, collect_exits=False,
                                     impl=impl, cache_pos=pos, write_mask=mask)
    if mask is not None:
        new_cache = dict(new_cache, segments=tuple(
            {k: _commit_rows(mask, n[k], o[k]) for k in n}
            for n, o in zip(new_cache["segments"], cache["segments"])))
    _, h = outs[-1]
    return h, new_cache, []
