"""Wrappers for the flash-attention kernels, in the model layout.

``flash_attention`` (prefill) takes q [B, S, H, hd] and k/v [B, T, KV, hd];
``decode_attention`` takes q [B, 1, H, hd], k/v [B, T, KV, hd] (any 16-byte
aligned strides with a unit last stride: a view into the segment cache) and
lengths [B].

A CPU tensor goes to the plain version in :mod:`.ref` (transposed to its
head-major layout and back).  A CUDA tensor goes to the kernel in
``csrc/flash_attention.cu`` / ``csrc/decode_attention.cu``, or the wrapper
raises: there is no fallback.  Each launch adds one to :data:`LAUNCHES`.
Neither has a backward: under grad mode both refuse inputs that require
grad, on the CPU too (:func:`build.refuse_autograd`).

Head dims are :data:`HEAD_DIMS`; both kernels are instantiated for each
(64 and 128 for the dense models, 80 for zamba2's shared attention, 16 for
the smoke configs the simulator builds and 32 for the reference's own
kernel tests), and any other head dim raises.  The bf16 prefill reads q, k
and v through TMA tensor maps, whose strides must be whole 16 bytes: a row
of a head is ``hd * 2`` bytes (160 at hd 80, 32 at hd 16) and the sequence
stride ``hd * 2 * H``, which :func:`build.require_aligned` checks with the
base address.

Decode attention splits the cache's keys across blocks
(:func:`decode_splits`, from the capacity T alone, never from ``lengths``)
and merges the splits in the same launch; its scratch comes from
``torch.empty`` and its ticket counters from a buffer per (device, stream)
zeroed once, at first use (:func:`_tickets`), so a call is one launch and
calls on two streams never share a counter.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (16, 32, 64, 80, 128)
#: kernel launches since the last reset (see repro_torch.kernels)
LAUNCHES = {"flash_attention": 0, "decode_attention": 0}
#: keys per split of decode attention: one tile (kBK) of decode_attention.cu
SPLIT_KEYS = 64
#: ticket counters of the decode merge per (device, stream), zero between calls
_TICKETS = {}


def decode_splits(T: int) -> int:
    """Blocks the decode kernel splits a T-long cache row's keys across."""
    return max(1, -(-T // SPLIT_KEYS))


def _tickets(device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 ticket counters for launches on ``stream`` of
    ``device``, zeroed when first allocated; the kernel's merging block
    resets each counter it used."""
    t = _TICKETS.get((device, stream))
    if t is None or t.numel() < n:
        t = _TICKETS[device, stream] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


def flash_attention(q, k, v, *, causal: bool = True):
    """q: [B, S, H, hd]; k/v: [B, T, KV, hd] -> [B, S, H, hd] (q's dtype)."""
    build.refuse_autograd("flash_attention", q, k, v)
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
    build.refuse_autograd("decode_attention", q, k, v)
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
    n_split = decode_splits(T)
    stream = build.stream(q)
    part = tickets = None
    if n_split > 1:
        part = torch.empty((B, H, n_split, hd + 2), dtype=torch.float32, device=q.device)
        tickets = _tickets(q.device, stream, B * KV)
    ks, vs = k.stride(), v.stride()
    lib = build.library()
    build.check(lib.decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), o.data_ptr(),
        None if part is None else part.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        B, T, H, KV, hd, n_split, ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
        build.dtype_code(q), stream), "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return o
