"""Wrapper for the fused exit-head kernel.

A CPU tensor goes to the plain version in :mod:`.ref`.  A CUDA tensor goes
to the kernel in ``csrc/exit_head.cu``, or the wrapper raises: there is no
fallback.  The kernel splits the vocab into :func:`exit_head_plan`'s chunks
of whole 128-row tiles, one block each (bf16 on the tensor cores fed by
TMA, f32 on the CUDA cores), and the block that finishes last merges the
chunks in the same launch: each call launches once and adds one to
:data:`LAUNCHES`.  Its ticket counters come from a buffer per (device,
stream) zeroed once, at first use (:func:`_tickets`), and every call leaves
them zero.  The kernel has no backward: under grad mode the wrapper refuses
inputs that require grad, on the CPU too (:func:`build.refuse_autograd`).

On DTensors (a sharded step) the kernel runs inside ``local_map`` on local
shards: the rows (batch and sequence) stay split, the hidden width and the
embedding's vocab and width are redistributed to ``Replicate`` first (the
vocab merge and the dot products span them).
"""
from __future__ import annotations

import torch

from torch.distributed.tensor.experimental import local_map

from repro_torch import spmd
from repro_torch.kernels import build
from repro_torch.kernels.exit_head import ref

#: kernel launches since the last reset (see repro_torch.kernels)
LAUNCHES = {"exit_confidence": 0}
#: vocab rows a tile: the two 64-row wgmma halves of exit_head.cu's kTile
TILE = 128
#: ticket counters of the in-launch merge per (device, stream), zero between calls
_TICKETS = {}
#: streaming multiprocessors per device index
_SMS = {}


def exit_head_plan(V: int, sms: int):
    """(tile, n_chunks): the vocab in tiles of :data:`TILE` rows, split into
    ``min(tiles, 2 * sms)`` chunks, two blocks an SM in one wave."""
    return TILE, min(-(-V // TILE), 2 * sms)


def chunk_tiles(c: int, V: int, n_chunks: int):
    """Tiles [t0, t1) of chunk ``c``: contiguous runs in order, the first
    ``tiles % n_chunks`` one tile longer (``chunk_tiles`` in exit_head.cu)."""
    q, r = divmod(-(-V // TILE), n_chunks)
    t0 = c * q + min(c, r)
    return t0, t0 + q + (c < r)


def _sms(device) -> int:
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def _tickets(device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 ticket counters for launches on ``stream`` of
    ``device``, zeroed when first allocated; the kernel's merging block
    resets each counter it used."""
    t = _TICKETS.get((device, stream))
    if t is None or t.numel() < n:
        t = _TICKETS[device, stream] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


def exit_confidence(h, emb):
    """h: [B, S, D] exit-normed hidden; emb: [V, D].
    Returns dict(token [B,S] i32, conf [B,S] f32, entropy [B,S] f32) — the
    contract of :func:`repro_torch.kernels.exit_head.ref.exit_confidence`."""
    build.refuse_autograd("exit_confidence", h, emb)
    if spmd.is_dtensor(h) or spmd.is_dtensor(emb):
        return _on_mesh(h, emb)
    if h.device.type == "cpu":
        return ref.exit_confidence(h, emb)
    build.require_cuda(h, emb)
    B, S, D = h.shape
    V = emb.shape[0]
    build.require(emb.shape == (V, D), f"emb must be [V, {D}]")
    build.require(h.dtype == emb.dtype, "h and emb must share a dtype")
    build.require(D % 8 == 0, f"D={D} must be a multiple of 8 (16-byte rows for TMA)")
    build.require(emb.is_contiguous() and emb.data_ptr() % 16 == 0,
                  "emb must be contiguous and 16-byte aligned")
    rows = B * S
    h2 = h.reshape(rows, D).contiguous()
    if h2.data_ptr() % 16:
        h2 = h2.clone()
    dev = h.device
    _, n_chunks = exit_head_plan(V, _sms(dev))
    stream = build.stream(h)
    # one allocation: the [rows, n_chunks] partials (m, Z, W, argmax bits),
    # then token, conf and entropy
    buf = torch.empty(rows * (4 * n_chunks + 3), dtype=torch.float32, device=dev)
    out = buf[rows * 4 * n_chunks:].view(3, rows)
    tok = out[0].view(torch.int32)
    lib = build.library()
    build.check(lib.exit_head_fwd(
        h2.data_ptr(), emb.data_ptr(), rows, D, V, n_chunks, buf.data_ptr(),
        _tickets(dev, stream, rows).data_ptr(), tok.data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), build.dtype_code(h), stream), "exit_confidence")
    LAUNCHES["exit_confidence"] += 1
    return {"token": tok.reshape(B, S), "conf": out[1].reshape(B, S),
            "entropy": out[2].reshape(B, S)}


def _on_mesh(h, emb):
    """:func:`exit_confidence` on the local rows of a DTensor ``h`` with the
    whole embedding on every rank, through ``local_map``."""
    if not spmd.is_dtensor(h):
        h = spmd.follow(h, emb, {})
    h = spmd.keep_sharded(h, (0, 1))
    emb = spmd.follow(emb, h, {})

    def local(hl, el):
        out = exit_confidence(hl, el)
        return out["token"], out["conf"], out["entropy"]

    tok, conf, ent = local_map(local, out_placements=(h.placements,) * 3,
                               in_placements=(h.placements, emb.placements),
                               device_mesh=h.device_mesh)(h, emb)
    return {"token": tok, "conf": conf, "entropy": ent}
