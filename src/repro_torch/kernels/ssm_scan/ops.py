"""Wrapper for the SSM scan kernel, in the model layout (the contract of
``src/repro/kernels/ssm_scan/ops.py``): q/k/log_w [B,S,H,dk], v [B,S,H,dv],
state [B,H,dk,dv], u [H,dk] or None.

A CPU tensor goes to the plain version in :mod:`.ref`.  A CUDA tensor goes
to the kernel in ``csrc/ssm_scan.cu``, or the wrapper raises: there is no
fallback.  The kernel reads q, k, v and log_w through their strides, so the
``[B,S,H,*]`` layout folds into its ``(b, h)`` blocks without copies, and
the Mamba-2 block's stride-0 broadcasts (B and C over heads, the decay over
state channels) are read in place.  Each launch adds one to
:data:`LAUNCHES`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssm_scan import ref

#: kernel launches since the last reset (see repro_torch.kernels)
LAUNCHES = {"ssm_scan": 0}
#: key (state row) widths the kernel is built for
KEY_DIMS = (16, 32, 64, 128)


def ssm_scan(q, k, v, log_w, state, u=None):
    """Returns (o [B,S,H,dv] in v's dtype, final state [B,H,dk,dv] f32);
    see :func:`repro_torch.kernels.ssm_scan.ref.ssm_scan`."""
    if q.device.type == "cpu":
        return ref.ssm_scan(q, k, v, log_w, state, u=u)
    build.require_cuda(q, k, v, log_w, state, *(() if u is None else (u,)))
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    build.require(k.shape == q.shape and log_w.shape == q.shape,
                  f"k and log_w must be [B, S, H, dk] = {tuple(q.shape)}")
    build.require(v.shape == (B, S, H, dv), f"v must be [B, S, H, dv] = {(B, S, H, dv)}")
    build.require(state.shape == (B, H, dk, dv),
                  f"state must be [B, H, dk, dv] = {(B, H, dk, dv)}")
    build.require(u is None or u.shape == (H, dk), f"u must be [H, dk] = {(H, dk)}")
    build.require(q.dtype == k.dtype == v.dtype, "q, k, v must share a dtype")
    build.require(dk in KEY_DIMS, f"key dim {dk} not in {KEY_DIMS}")
    lw = log_w.float()
    s0 = state.float().contiguous()
    uu = None if u is None else u.float().contiguous()
    o = torch.empty((B, S, H, dv), dtype=v.dtype, device=v.device)
    s_out = torch.empty((B, H, dk, dv), dtype=torch.float32, device=v.device)
    lib = build.library()
    build.check(lib.ssm_scan_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), s0.data_ptr(),
        0 if uu is None else uu.data_ptr(), o.data_ptr(), s_out.data_ptr(),
        B, S, H, dk, dv, *q.stride(), *k.stride(), *v.stride(), *lw.stride(),
        build.dtype_code(q), build.stream(q)), "ssm_scan")
    LAUNCHES["ssm_scan"] += 1
    return o, s_out
