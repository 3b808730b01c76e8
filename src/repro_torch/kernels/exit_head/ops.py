"""Wrapper for the fused exit-head kernel.

A CPU tensor goes to the plain version in :mod:`.ref`.  A CUDA tensor goes
to the two-pass kernel in ``csrc/exit_head.cu`` (vocab chunks, then a
per-row merge), or the wrapper raises: there is no fallback.  Each call
launches the kernel once and adds one to :data:`LAUNCHES`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.exit_head import ref

#: kernel launches since the last reset (see repro_torch.kernels)
LAUNCHES = {"exit_confidence": 0}
#: vocab rows per pass-1 block: 128256 / 256 -> 501 blocks over 132 SMs
CHUNK = 256


def exit_confidence(h, emb):
    """h: [B, S, D] exit-normed hidden; emb: [V, D].
    Returns dict(token [B,S] i32, conf [B,S] f32, entropy [B,S] f32) — the
    contract of :func:`repro_torch.kernels.exit_head.ref.exit_confidence`."""
    if h.device.type == "cpu":
        return ref.exit_confidence(h, emb)
    build.require_cuda(h, emb)
    B, S, D = h.shape
    V = emb.shape[0]
    build.require(emb.shape == (V, D), f"emb must be [V, {D}]")
    build.require(h.dtype == emb.dtype, "h and emb must share a dtype")
    vec = 16 // emb.element_size()
    build.require(D % vec == 0, f"D={D} must be a multiple of {vec}")
    build.require(emb.is_contiguous() and emb.data_ptr() % 16 == 0,
                  "emb must be contiguous and 16-byte aligned")
    rows = B * S
    h2 = h.reshape(rows, D).contiguous()
    n_chunks = -(-V // CHUNK)
    dev = h.device
    part = torch.empty((3, rows, n_chunks), dtype=torch.float32, device=dev)
    arg = torch.empty((rows, n_chunks), dtype=torch.int32, device=dev)
    tok = torch.empty(rows, dtype=torch.int32, device=dev)
    conf = torch.empty(rows, dtype=torch.float32, device=dev)
    ent = torch.empty(rows, dtype=torch.float32, device=dev)
    lib = build.library()
    build.check(lib.exit_head_fwd(
        h2.data_ptr(), emb.data_ptr(), rows, D, V, CHUNK,
        part[0].data_ptr(), part[1].data_ptr(), part[2].data_ptr(),
        arg.data_ptr(), tok.data_ptr(), conf.data_ptr(), ent.data_ptr(),
        build.dtype_code(h), build.stream(h)), "exit_confidence")
    LAUNCHES["exit_confidence"] += 1
    return {"token": tok.reshape(B, S), "conf": conf.reshape(B, S),
            "entropy": ent.reshape(B, S)}
