"""Diagonal-decay linear-attention scan — the shared recurrence of RWKV-6 and
Mamba-2 (SSD), the counterpart of ``src/repro/models/linear_scan.py``:

    S_t = diag(w_t) @ S_{t-1} + k_t v_t^T          (state:  [dk, dv])
    o_t = q_t @ (S_{t-1} + diag(u) k_t v_t^T)      (rwkv: pre-update + bonus)
    o_t = q_t @ S_t                                 (mamba2: post-update)

Two plain implementations with the reference's semantics:
  * ``scan_sequential`` — a loop over time (the kernel's plain version,
    :func:`repro_torch.kernels.ssm_scan.ref.ssm_scan`).
  * ``scan_chunked``    — the reference's chunk-parallel ratio-trick
    formulation, kept as it is so that the dense path stays the
    reference's: like the reference it overflows once a chunk's cumulative
    log-decay falls below f32's range (log_w near -8 over a 16-step chunk);
    the kernel path steps the recurrence and does not.

``linear_scan(impl=)`` picks the path: ``"kernel"`` the port's CUDA kernel
through its wrapper (its plain version for a CPU tensor), at any S;
``"dense"`` the reference's ``mode="auto"`` dispatch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.kernels.ssm_scan.ref import MIN_LOG_W
from repro_torch.kernels.ssm_scan.ref import ssm_scan as scan_sequential

IMPLS = ("kernel", "dense")


def scan_chunked(q, k, v, log_w, state, u=None, chunk: int = 16):
    """Chunk-parallel twin of :func:`scan_sequential` (same outputs).

    Within a chunk of length C the output decomposes into
      inter: (q_t * P_{t-1}) @ S_chunk_in
      intra: [(q_t * P_{t-1}) @ (k_s / P_s)^T masked s<t  (+ diag bonus)] @ v
    where P_t = prod_{tau<=t} w_tau.
    """
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    C = chunk
    N = S // C
    qf = q.float().reshape(B, N, C, H, dk)
    kf = k.float().reshape(B, N, C, H, dk)
    vf = v.float().reshape(B, N, C, H, dv)
    lw = torch.clamp(log_w.float(), min=MIN_LOG_W).reshape(B, N, C, H, dk)
    dev = q.device
    strict = torch.tril(torch.ones((C, C), device=dev), -1)
    incl = torch.tril(torch.ones((C, C), device=dev))
    eye = torch.eye(C, device=dev)
    s = state.float()
    outs = []
    for n in range(N):
        qc, kc, vc, lwc = qf[:, n], kf[:, n], vf[:, n], lw[:, n]   # [B,C,H,*]
        logP = torch.cumsum(lwc, dim=1)                             # log P_t
        P = torch.exp(logP)
        k_ = kc / P
        if u is not None:
            # rwkv: pre-update state -> coeff P_{t-1}, strict mask, diag bonus u
            q_ = qc * torch.exp(logP - lwc)
            A = torch.einsum("bthk,bshk->bhts", q_, k_)
            A = A * strict[None, None]
            diag = torch.einsum("bthk,hk,bthk->bth", qc, u.float(), kc)   # [B,C,H]
            A = A + eye[None, None] * diag.permute(0, 2, 1)[:, :, :, None]
        else:
            # mamba2: post-update state -> coeff P_t, inclusive mask
            q_ = qc * P
            A = torch.einsum("bthk,bshk->bhts", q_, k_)
            A = A * incl[None, None]
        intra = torch.einsum("bhts,bshv->bthv", A, vc)
        inter = torch.einsum("bthk,bhkv->bthv", q_, s)
        # state update: S' = diag(P_C) S + sum_s diag(P_C / P_s) k_s v_s
        kP = kc * torch.exp(logP[:, -1:, :, :] - logP)
        s = P[:, -1][..., None] * s + torch.einsum("bshk,bshv->bhkv", kP, vc)
        outs.append(intra + inter)
    o = torch.stack(outs, dim=1).reshape(B, S, H, dv)
    return o.to(v.dtype), s


def linear_scan(q, k, v, log_w, state, u=None, *, mode: str = "auto",
                chunk: int = 16, impl: str = "kernel"):
    """``impl="kernel"``: the SSM scan kernel's wrapper at any S (decode's
    S=1 included), as the reference's ``use_kernel=True``.  ``impl="dense"``:
    sequential for short, ragged or decode inputs, chunked otherwise
    (``mode`` forces either)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "kernel":
        return ssm_ops.ssm_scan(q, k, v, log_w, state, u=u)
    S = q.shape[1]
    if mode == "sequential" or (mode == "auto" and (S < chunk or S % chunk)):
        return scan_sequential(q, k, v, log_w, state, u=u)
    return scan_chunked(q, k, v, log_w, state, u=u, chunk=chunk)
