"""Shared model primitives of the dense family: RMSNorm, RoPE, GQA attention
(+KV cache), SwiGLU, tied embedding / logits.

Plain functions over parameter dicts of tensors, mirroring
``src/repro/models/layers.py``.  Weights keep the reference's ``[in, out]``
layout, so every projection is ``x @ W`` as there.

``impl`` selects attention: ``"kernel"`` (the default, the serving path)
runs the port's kernels through their wrappers — the CUDA kernels for a
CUDA tensor, their plain versions for a CPU tensor; the wrappers have no
backward and refuse autograd.  The reference's training choices are plain
PyTorch with a backward: ``"dense"`` (its masked dense ``_sdpa``),
``"flash"`` and ``"flash@N"`` (:func:`flash_attention_fused`, blocks of
1024 or N, with the flash backward), ``"flash_novjp"``
(:func:`flash_attention_jnp`, the same blocks under plain autograd) and
``"auto"`` (``"flash"`` when S·T > 1024², ``"dense"`` otherwise).  A cached
decode takes the decode kernel for ``"kernel"`` and ``_sdpa`` for every
other choice, as the reference.

On DTensors (a sharded step, ``launch/steps.py``) DTensor's sharding
propagation lays out the projections and norms; the attention cores, the
embedding lookup and the cache writes run on local shards with explicit
redistributions (:mod:`repro_torch.spmd`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor.experimental import local_map

from repro_torch.config import ModelConfig
from repro_torch import spmd
from repro_torch.tree import P
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.obs import spans

NEG_INF = -1e30
IMPLS = ("kernel", "auto", "flash", "flash_novjp", "dense")
#: flash block size (``"flash@N"`` sets another)
FLASH_BLOCK = 1024


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


def spec_attn(stack: bool = False, q_shard: bool = True, kv_shard: bool = True):
    """Sharding of the attention projections (the reference's): ``q_shard``
    / ``kv_shard`` must be False when the padded query / key head count
    does not divide the 16-way ``model`` axis, so that no head is split
    across ranks.  Replicated K/V is cheap under GQA."""
    pre = (None,) if stack else ()
    qs = P(*pre, "data", "model") if q_shard else P(*pre, "data", None)
    kvs = P(*pre, "data", "model") if kv_shard else P(*pre, "data", None)
    return {
        "wq": qs,
        "wk": kvs,
        "wv": kvs,
        "wo": P(*pre, "model", "data") if q_shard else P(*pre, None, "data"),
        "ln": P(*pre, None),
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


@dataclass(frozen=True)
class PadPrefix:
    """A left-padded batch [B, S] packed so that its prefill computes the
    rows' shared pad prefix once: the first ``prefix`` = S - min(lengths)
    positions of the row padded most, then each row's own L_i positions,
    N = ``prefix`` + sum(lengths) in all.  Attention is causal, so the
    first S - L_i positions of row i are the prefix's first S - L_i.

    ``rows``: (offset in the packed sequence, L_i) of each row; ``take``
    [N]: the index into the flattened [B * S] tokens of each packed
    position; ``positions`` [1, N]: its position in its row; ``src`` [B,
    S]: the packed position whose K/V fills each cache position of each
    row; ``last`` [B]: each row's last packed position."""
    prefix: int
    seq: int
    rows: Tuple[Tuple[int, int], ...]
    take: torch.Tensor
    positions: torch.Tensor
    src: torch.Tensor
    last: torch.Tensor


def pad_prefix(lengths: Sequence[int], S: int, device) -> PadPrefix:
    """The :class:`PadPrefix` of rows of ``lengths`` (host ints, each in [1,
    S]) left-padded to S, its index tensors made on the host and moved to
    ``device`` in one copy."""
    lens = [int(n) for n in lengths]
    if not lens or not all(1 <= n <= S for n in lens):
        raise ValueError(f"prompt lengths {lens} must lie in [1, {S}]")
    B, P = len(lens), S - min(lens)
    pads = [S - n for n in lens]
    offs = (P + np.cumsum([0] + lens[:-1])).tolist()
    most = int(np.argmax(pads))
    t = np.arange(S)
    take = np.concatenate([most * S + t[:P]] + [i * S + t[p:] for i, p in enumerate(pads)])
    positions = np.concatenate([t[:P]] + [t[p:] for p in pads])
    src = np.stack([np.where(t < p, t, o + t - p) for p, o in zip(pads, offs)])
    last = np.array([o + n - 1 for o, n in zip(offs, lens)])
    N = P + sum(lens)
    flat = torch.from_numpy(np.concatenate([take, positions, src.reshape(-1), last])
                            .astype(np.int64)).to(device)
    return PadPrefix(P, S, tuple(zip(offs, lens)), flat[:N], flat[N:2 * N][None],
                     flat[2 * N:2 * N + B * S].view(B, S), flat[2 * N + B * S:])


def _causal(q, k, v, impl):
    """Causal attention of q [1, Sq, H, hd] over k/v [1, T, KV, hd], the
    diagonal aligned bottom right: the flash kernel for ``impl="kernel"``,
    the dense ``_sdpa`` otherwise."""
    if impl == "kernel":
        with spans.span("kernel.flash_attention") if spans.on() else spans.OFF:
            return fa_ops.flash_attention(q, k, v, causal=True)
    Sq, T = q.shape[1], k.shape[1]
    return _sdpa(q, k, v, causal_bias(Sq, T, T - Sq, q.device))


def _attend_pad_prefix(q, k, v, kv_cache, pack: PadPrefix, impl):
    """The packed prefill's attention (:class:`PadPrefix`): q [1, N, H, hd]
    and k/v [1, N, KV, hd] packed, ``kv_cache`` (k, v) [B, T, KV, hd] in
    q's dtype.  Every row's cache positions [0, S) are written first (its
    pads from the prefix, then its own keys and values); then the prefix
    attends causally to itself, and row i's L_i queries to its cache row's
    S keys: query j of the row sits at position S - L_i + j and sees every
    pad key and its own past.  B + 1 attention calls; returns [1, N, H,
    hd]."""
    ck, cv = kv_cache
    S, P = pack.seq, pack.prefix
    ck[:, :S] = k[0, pack.src]
    cv[:, :S] = v[0, pack.src]
    out = [_causal(q[:, :P], k[:, :P], v[:, :P], impl)]
    for i, (off, n) in enumerate(pack.rows):
        out.append(_causal(q[:, off:off + n], ck[i:i + 1, :S], cv[i:i + 1, :S], impl))
    return torch.cat(out, dim=1)


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
    card, so the commit needs no host sync.  ``buf`` is [B, T, ...]: a k/v
    leaf [B, T, KV, hd] (int8 or the model dtype) or an int8 cache's scale
    leaf [B, T, KV]."""
    S, T = val.shape[1], buf.shape[1]
    if spmd.is_dtensor(buf):
        return _write_cache_local(buf, val, cache_pos, mask)
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
            keep = mask.view((-1,) + (1,) * (new.ndim - 1))
            new = torch.where(keep, new, buf[rows, idx])
        buf[rows, idx] = new


def _write_cache_local(buf, val, cache_pos, mask=None):
    """:func:`_write_cache` into a sharded cache: each rank writes the part
    of the new entries that falls in its own shard of the sequence axis,
    and nothing else (a write through DTensor would gather the cache).
    ``val`` is first laid out with ``buf``'s batch split and its other
    dims replicated (a small tensor: the new tokens only)."""
    S, T = val.shape[1], buf.shape[1]
    if S != 1 and not isinstance(cache_pos, int):
        raise ValueError("per-row cache positions take one token per row")
    if isinstance(cache_pos, int) and not (0 <= cache_pos and cache_pos + S <= T):
        raise IndexError(f"cache write [{cache_pos}, {cache_pos + S}) "
                         f"outside a cache of length {T}")
    if isinstance(cache_pos, int) and mask is not None:
        raise ValueError("a masked commit takes [B] cache positions")
    vloc = spmd.follow(val, buf, {0: 0}).to_local()
    bloc = buf.to_local()
    t0, tl = spmd.window(buf, 1)
    if isinstance(cache_pos, int):
        lo, hi = max(cache_pos, t0), min(cache_pos + S, t0 + tl)
        if lo < hi:
            bloc[:, lo - t0:hi - t0] = vloc[:, lo - cache_pos:hi - cache_pos].to(bloc.dtype)
        return
    b0, bl = spmd.window(buf, 0)
    if tl == 0 or bl == 0:
        return
    idx = spmd.replicate(cache_pos).to(bloc.device)
    idx = (idx.to_local() if spmd.is_dtensor(idx) else idx)[b0:b0 + bl]
    keep = (idx >= t0) & (idx < t0 + tl)
    if mask is not None:
        m = spmd.replicate(mask)
        keep = keep & (m.to_local() if spmd.is_dtensor(m) else m)[b0:b0 + bl]
    rows = torch.arange(bl, device=bloc.device)
    li = (idx - t0).clamp(0, tl - 1)
    new = vloc[:, 0].to(bloc.dtype)
    new = torch.where(keep.view((-1,) + (1,) * (new.ndim - 1)), new, bloc[rows, li])
    bloc[rows, li] = new


def _flash_fwd_blocks(q, k, v, *, causal, q_block, kv_block):
    """Blocked online-softmax attention returning (o, lse), the reference's
    ``_flash_fwd_blocks``: q [B,S,H,hd], k/v [B,T,KV,hd]; o [B,S,H,hd] in
    q's dtype, lse [B,S,H] float32.  Scores come from a product in the
    input dtype, cast to float32; a causal block masks key j > query i
    with the finite NEG_INF (every block is computed, none pruned), and the
    running max, sum and output accumulate in float32."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qb, kb = min(q_block, S), min(kv_block, T)
    if S % qb or T % kb:
        raise ValueError(f"flash blocks ({qb}, {kb}) do not divide S={S}, T={T}")
    nq, nk = S // qb, T // kb
    scale = 1.0 / math.sqrt(hd)
    qr = q.reshape(B, nq, qb, KV, G, hd)
    kr = k.reshape(B, nk, kb, KV, hd)
    vr = v.reshape(B, nk, kb, KV, hd)
    outs, lses = [], []
    for qi in range(nq):
        qc = qr[:, qi]                                   # [B,qb,KV,G,hd]
        m = torch.full((B, KV, G, qb), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, KV, G, qb), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KV, G, qb, hd), dtype=torch.float32, device=q.device)
        for kj in range(nk):
            kc, vc = kr[:, kj], vr[:, kj]                # [B,kb,KV,hd]
            s = torch.einsum("bqkgd,btkd->bkgqt", qc, kc).float() * scale
            if causal:
                s = _causal_block_mask(s, qi, kj, qb, kb)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkd->bkgqd", p.to(vc.dtype), vc).float()
            m = m_new
        l = torch.clamp(l, min=1e-30)
        outs.append((acc / l[..., None]).to(q.dtype))   # [B,KV,G,qb,hd]
        lses.append(m + torch.log(l))                     # [B,KV,G,qb]
    o = torch.stack(outs, 1).permute(0, 1, 4, 2, 3, 5).reshape(B, S, H, hd)
    lse = torch.stack(lses, 1).permute(0, 1, 4, 2, 3).reshape(B, S, H)
    return o, lse


def _causal_block_mask(s, qi, kj, qb, kb):
    """Mask key j > query i in the score block (qi, kj) [..., qb, kb]."""
    qpos = qi * qb + torch.arange(qb, device=s.device)
    kpos = kj * kb + torch.arange(kb, device=s.device)
    return torch.where(kpos[None, :] <= qpos[:, None], s, NEG_INF)


def _flash_bwd(q, k, v, o, lse, do, *, causal, q_block, kv_block):
    """The reference's ``_flash_bwd_rule``: each block's probabilities are
    recomputed from lse, ``D = sum(do * o)``, and dq, dk, dv accumulate in
    float32 from float32 products, cast to the inputs' dtypes at the end."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qb, kb = min(q_block, S), min(kv_block, T)
    nq, nk = S // qb, T // kb
    scale = 1.0 / math.sqrt(hd)
    f = torch.float32
    qr = q.reshape(B, nq, qb, KV, G, hd).permute(1, 0, 3, 4, 2, 5).to(f)   # [nq,B,KV,G,qb,hd]
    dor = do.reshape(B, nq, qb, KV, G, hd).permute(1, 0, 3, 4, 2, 5).to(f)
    Dr = torch.sum(do.to(f) * o.to(f), dim=-1)
    Dr = Dr.reshape(B, nq, qb, KV, G).permute(1, 0, 3, 4, 2)               # [nq,B,KV,G,qb]
    lser = lse.reshape(B, nq, qb, KV, G).permute(1, 0, 3, 4, 2)
    kr = k.reshape(B, nk, kb, KV, hd).permute(1, 0, 3, 2, 4).to(f)        # [nk,B,KV,kb,hd]
    vr = v.reshape(B, nk, kb, KV, hd).permute(1, 0, 3, 2, 4).to(f)
    dq = 0
    dks, dvs = [], []
    for kj in range(nk):
        kc, vc = kr[kj], vr[kj]
        dk_acc = torch.zeros((B, KV, kb, hd), dtype=f, device=q.device)
        dv_acc = torch.zeros((B, KV, kb, hd), dtype=f, device=q.device)
        dq_blocks = []
        for qi in range(nq):
            qc, doc, Dc, lsec = qr[qi], dor[qi], Dr[qi], lser[qi]
            s = torch.einsum("bkgqd,bktd->bkgqt", qc, kc) * scale
            if causal:
                s = _causal_block_mask(s, qi, kj, qb, kb)
            p = torch.exp(s - lsec[..., None])                             # [B,KV,G,qb,kb]
            dv_acc = dv_acc + torch.einsum("bkgqt,bkgqd->bktd", p, doc)
            dp = torch.einsum("bkgqd,bktd->bkgqt", doc, vc)
            ds = p * (dp - Dc[..., None]) * scale
            dq_blocks.append(torch.einsum("bkgqt,bktd->bkgqd", ds, kc))
            dk_acc = dk_acc + torch.einsum("bkgqt,bkgqd->bktd", ds, qc)
        dq = dq + torch.stack(dq_blocks)                                   # [nq,B,KV,G,qb,hd]
        dks.append(dk_acc)
        dvs.append(dv_acc)
    dq = dq.permute(1, 0, 4, 2, 3, 5).reshape(B, S, H, hd)
    dk = torch.stack(dks).permute(1, 0, 3, 2, 4).reshape(B, T, KV, hd)
    dv = torch.stack(dvs).permute(1, 0, 3, 2, 4).reshape(B, T, KV, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, q_block, kv_block):
        o, lse = _flash_fwd_blocks(q, k, v, causal=causal, q_block=q_block,
                                   kv_block=kv_block)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.blocks = (causal, q_block, kv_block)
        return o

    @staticmethod
    def backward(ctx, do):
        causal, q_block, kv_block = ctx.blocks
        dq, dk, dv = _flash_bwd(*ctx.saved_tensors, do, causal=causal,
                                q_block=q_block, kv_block=kv_block)
        return dq, dk, dv, None, None, None


def flash_attention_fused(q, k, v, causal=True, q_block=FLASH_BLOCK,
                          kv_block=FLASH_BLOCK):
    """Flash attention with a flash *backward* (the reference's custom_vjp,
    here a :class:`torch.autograd.Function`): the forward saves (q, k, v,
    o, lse) and the backward recomputes each block's probabilities from
    them, instead of autograd saving every probability block."""
    return _FlashFused.apply(q, k, v, causal, q_block, kv_block)


def flash_attention_jnp(q, k, v, *, causal=True, q_block=FLASH_BLOCK,
                        kv_block=FLASH_BLOCK):
    """The same blocked attention under plain autograd, which saves every
    probability block for the backward: the reference's function of this
    name, its ``"flash_novjp"`` baseline.  q: [B,S,H,hd]; k/v:
    [B,T,KV,hd]."""
    return _flash_fwd_blocks(q, k, v, causal=causal, q_block=q_block,
                             kv_block=kv_block)[0]


def _resolve_impl(impl: str, S: int, T: int):
    """(impl, flash block) of a non-cached attention: ``"auto"`` is
    ``"flash"`` when S·T > 1024², else ``"dense"``; ``"flash@N"`` is
    ``"flash"`` with blocks of N."""
    if impl == "auto":
        impl = "flash" if S * T > 1024 * 1024 else "dense"
    if impl.startswith("flash@"):
        return "flash", int(impl.split("@", 1)[1])
    return impl, FLASH_BLOCK


def _core(fn, q, k, v, *rest):
    """An attention core ``fn(q, k, v, *rest)``; on DTensors it runs on the
    local batch and head shards (:func:`repro_torch.spmd.local_attention`),
    as the kernels do: DTensor's own strategies for the blocked einsums
    search a plan space that grows past use on a three-axis mesh."""
    if any(spmd.is_dtensor(t) for t in (q, k, v)):
        return spmd.local_attention(fn, q, k, v, *rest)
    return fn(q, k, v, *rest)


def quantize_int8(x):
    """The int8 cache's quantizer: per (position, kv head) scales
    ``max|x| / 127`` (at least 1e-8) over the head dim, values rounded half
    to even and clipped to ±127.  x: [..., hd] -> (int8 [..., hd], bf16
    scales [...]); the scales are bfloat16 whatever x's dtype, as the
    reference's."""
    xf = x.float()
    sc = torch.clamp(xf.abs().amax(-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / sc[..., None]), -127, 127).to(torch.int8)
    return q, sc.to(torch.bfloat16)


def dequantize_int8(q, scale, dtype):
    """int8 values [..., hd] times their scales [...], in float32, cast to
    ``dtype``."""
    return (q.float() * scale.float()[..., None]).to(dtype)


def attention(p, cfg: ModelConfig, x, positions, *, causal=True,
              kv_cache=None, cache_pos=None, lengths=None, cross_kv=None,
              impl="kernel", prefill_mode=False, write_mask=None, pack=None):
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
    - int8 cache: ``kv_cache`` a dict of ``k``/``v`` (int8 [B,T,KV,hd]) and
      ``k_scale``/``v_scale`` (bf16 [B,T,KV]); the new k/v are quantized
      (:func:`quantize_int8`) and written, a prefill attends on the
      unquantized block, and a decode dequantizes the whole cache to q's
      dtype and attends on that.
    - packed prefill: ``pack`` a :class:`PadPrefix` and x its packed
      positions [1, N, D] (``positions`` ``pack.positions``), ``kv_cache``
      (k, v) in x's dtype: fills every row's cache positions [0, S) and
      attends as the left-padded prefill would (:func:`_attend_pad_prefix`).
    - cross attention: ``cross_kv=(k,v)`` [B,T,KV,hd], the encoder memory's
      precomputed keys and values: q is not roped and nothing is masked.
      With ``impl="kernel"`` one query token (a decode step) goes to the
      decode kernel over all T keys, more to the flash kernel unmasked.
    Returns (out [B,S,D], new_cache or None); the cache is written in place
    and returned.

    When ``cfg.padded_heads > cfg.num_heads`` the padding query heads are
    masked to zero before the output projection.
    """
    if impl not in IMPLS and not impl.startswith("flash@"):
        raise ValueError(f"impl must be one of {IMPLS} or flash@N, got {impl!r}")

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
    q = spmd.split_dim(xn @ p["wq"], -1, h).reshape(B, S, h, hd)
    new_cache = None
    if cross_kv is not None:
        k, v = cross_kv
        causal = False
        if impl == "kernel" and S == 1:
            T = k.shape[1]
            if lengths is None:
                lengths = torch.full((B,), T, dtype=torch.int32, device=x.device)
            with spans.span("kernel.decode_attention") if spans.on() else spans.OFF:
                out = fa_ops.decode_attention(q, k, v, lengths)
            out = _mask_pad_heads(out, h)
            return out.reshape(B, S, h * hd) @ p["wo"], None
    else:
        k = spmd.split_dim(xn @ p["wk"], -1, kv_h).reshape(B, S, kv_h, hd)
        v = spmd.split_dim(xn @ p["wv"], -1, kv_h).reshape(B, S, kv_h, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if pack is not None:
        out = _mask_pad_heads(_attend_pad_prefix(q, k, v, kv_cache, pack, impl), h)
        return out.reshape(B, S, h * hd) @ p["wo"], kv_cache
    if kv_cache is not None:
        if isinstance(kv_cache, dict):
            k8, ks = quantize_int8(k)
            v8, vs = quantize_int8(v)
            for name, val in (("k", k8), ("v", v8), ("k_scale", ks), ("v_scale", vs)):
                _write_cache(kv_cache[name], val, cache_pos, write_mask)
            new_cache = kv_cache
        else:
            ck, cv = kv_cache
            _write_cache(ck, k, cache_pos, write_mask)
            _write_cache(cv, v, cache_pos, write_mask)
            new_cache = (ck, cv)
        if not prefill_mode:
            # decode: attend to the filled cache
            if isinstance(kv_cache, dict):
                ck = dequantize_int8(kv_cache["k"], kv_cache["k_scale"], q.dtype)
                cv = dequantize_int8(kv_cache["v"], kv_cache["v_scale"], q.dtype)
            else:
                ck, cv = ck.to(q.dtype), cv.to(q.dtype)
            T = ck.shape[1]
            if impl == "kernel":
                if lengths is None:
                    lengths = decode_lengths(cache_pos, B, x.device)
                with spans.span("kernel.decode_attention") if spans.on() else spans.OFF:
                    out = fa_ops.decode_attention(q, ck, cv, lengths)
            else:
                out = _core(_sdpa, q, ck, cv, _decode_bias(cache_pos, S, T, x.device))
            out = _mask_pad_heads(out, h)
            return out.reshape(B, S, h * hd) @ p["wo"], new_cache
    impl, blk = _resolve_impl(impl, S, k.shape[1])
    if impl == "kernel":
        with spans.span("kernel.flash_attention") if spans.on() else spans.OFF:
            out = fa_ops.flash_attention(q, k, v, causal=causal)
    elif impl == "flash":
        out = _core(lambda q, k, v: flash_attention_fused(q, k, v, causal, blk, blk),
                    q, k, v)
    elif impl == "flash_novjp":
        out = _core(lambda q, k, v: flash_attention_jnp(q, k, v, causal=causal), q, k, v)
    else:
        bias = causal_bias(S, S, device=x.device) if causal else 0.0
        out = _core(_sdpa, q, k, v, bias)
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


def spec_ffn(stack: bool = False):
    pre = (None,) if stack else ()
    return {
        "wg": P(*pre, "data", "model"),
        "wu": P(*pre, "data", "model"),
        "wd": P(*pre, "model", "data"),
        "ln": P(*pre, None),
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


def spec_embed():
    return P("model", "data")


def embed(table, tokens):
    """``table[tokens]``.  On DTensors the lookup runs on each rank's own
    tokens against the whole table (its vocab and width shards gathered):
    the output keeps the tokens' batch and sequence splits."""
    if spmd.is_dtensor(table) or spmd.is_dtensor(tokens):
        table = spmd.follow(table, table if spmd.is_dtensor(table) else tokens, {})
        tokens = (spmd.keep_sharded(tokens, (0, 1)) if spmd.is_dtensor(tokens)
                  else spmd.follow(tokens, table, {}))
        return local_map(lambda t, i: t[i.long()], out_placements=(tokens.placements,),
                         in_placements=(table.placements, tokens.placements),
                         device_mesh=table.device_mesh)(table, tokens)
    return table[tokens.long()]


def logits(table, x):
    """Tied LM head: [B,S,D] @ [V,D]^T -> [B,S,V]."""
    return torch.einsum("bsd,vd->bsv", x, table)
