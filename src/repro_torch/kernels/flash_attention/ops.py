"""Wrappers for the flash-attention kernels, in the model layout.

``flash_attention`` (prefill) takes q [B, S, H, hd] and k/v [B, T, KV, hd];
``decode_attention`` takes q [B, 1, H, hd], k/v [B, T, KV, hd] (any 16-byte
aligned strides with a unit last stride: a view into the segment cache) and
lengths [B].

A CPU tensor goes to the plain version in :mod:`.ref` (transposed to its
head-major layout and back).  A CUDA tensor goes to the kernel in
``csrc/flash_attention.cu`` / ``csrc/decode_attention.cu``, or the wrapper
raises: there is no fallback.  Each launch adds one to :data:`LAUNCHES`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

#: kernel launches since the last reset (see repro_torch.kernels)
LAUNCHES = {"flash_attention": 0, "decode_attention": 0}
HEAD_DIMS = (64, 128)


def flash_attention(q, k, v, *, causal: bool = True):
    """q: [B, S, H, hd]; k/v: [B, T, KV, hd] -> [B, S, H, hd] (q's dtype)."""
    if q.device.type == "cpu":
        return ref.attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal).transpose(1, 2)
    build.require_cuda(q, k, v)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    build.require(k.shape == (B, T, KV, hd) and v.shape == k.shape,
                  f"k/v must be [B, T, KV, hd] = {(B, T, KV, hd)}")
    build.require(q.dtype == k.dtype == v.dtype, "q, k, v must share a dtype")
    build.require(H % KV == 0, f"H={H} is not a multiple of KV={KV}")
    build.require(hd in HEAD_DIMS, f"head dim {hd} not in {HEAD_DIMS}")
    build.require(not causal or S <= T, "causal attention needs S <= T")
    build.require(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
                  "flash_attention takes contiguous q, k, v")
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.require_aligned(name, t)
    o = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lib = build.library()
    build.check(lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, S, T, H, KV, hd, int(causal), build.dtype_code(q), build.stream(q)),
        "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o


def decode_attention(q, k, v, lengths):
    """q: [B, 1, H, hd]; k/v: [B, T, KV, hd]; lengths: [B] int32 ->
    [B, 1, H, hd].  Row ``b`` attends over its first ``lengths[b]`` keys; a
    zero-length row returns zeros."""
    B, S, H, hd = q.shape
    build.require(S == 1, f"decode attention is single-query: got S={S}")
    if q.device.type == "cpu":
        return ref.decode_attention(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), lengths).transpose(1, 2)
    build.require_cuda(q, k, v, lengths)
    T, KV = k.shape[1], k.shape[2]
    build.require(k.shape == (B, T, KV, hd) and v.shape == k.shape,
                  f"k/v must be [B, T, KV, hd] = {(B, T, KV, hd)}")
    build.require(q.dtype == k.dtype == v.dtype, "q, k, v must share a dtype")
    build.require(H % KV == 0 and H // KV <= 32,
                  f"H={H} must be a multiple of KV={KV}, at most 32 per group")
    build.require(hd in HEAD_DIMS, f"head dim {hd} not in {HEAD_DIMS}")
    build.require(q.is_contiguous(), "decode_attention takes a contiguous q")
    build.require_aligned("k", k)
    build.require_aligned("v", v)
    build.require(lengths.shape == (B,) and lengths.dtype == torch.int32,
                  "lengths must be int32 [B]")
    lengths = lengths.contiguous()
    o = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    ks, vs = k.stride(), v.stride()
    lib = build.library()
    build.check(lib.decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        o.data_ptr(), B, T, H, KV, hd, ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
        build.dtype_code(q), build.stream(q)), "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return o
