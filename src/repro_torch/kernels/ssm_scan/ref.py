"""Plain PyTorch version of the SSM scan kernel (the counterpart of
``src/repro/kernels/ssm_scan/ref.py``): the sequential recurrence of the
reference's ``scan_sequential``, step by step over time, in the model
layout.  :mod:`repro_torch.models.linear_scan` takes its ``scan_sequential``
from here."""
from __future__ import annotations

import torch

# clamp on the per-step log-decay (the reference's MIN_LOG_W)
MIN_LOG_W = -8.0


def ssm_scan(q, k, v, log_w, state, u=None):
    """q/k/log_w: [B,S,H,dk]; v: [B,S,H,dv]; state: [B,H,dk,dv].

        S_t = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(max(log_w_t, -8))
        o_t = q_t (S_{t-1} + diag(u) k_t v_t^T)     (``u`` given: RWKV)
        o_t = q_t S_t                               (``u`` None: Mamba-2)

    Returns (o [B,S,H,dv] in v's dtype, final state [B,H,dk,dv] float32).
    ``u`` is the per-head bonus [H,dk].  It computes in float32, or in
    float64 (and returns the state in float64) when q is float64."""
    S = q.shape[1]
    acc = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf = q.to(acc), k.to(acc), v.to(acc)
    w = torch.exp(torch.clamp(log_w.to(acc), min=MIN_LOG_W))
    s = state.to(acc)
    uf = None if u is None else u.to(acc)[None, :, :, None]
    outs = []
    for t in range(S):
        qt, kt, vt, wt = qf[:, t], kf[:, t], vf[:, t], w[:, t]
        kv = kt[..., :, None] * vt[..., None, :]           # [B,H,dk,dv]
        if uf is not None:
            o = torch.einsum("bhk,bhkv->bhv", qt, s + uf * kv)
            s = wt[..., None] * s + kv
        else:
            s = wt[..., None] * s + kv
            o = torch.einsum("bhk,bhkv->bhv", qt, s)
        outs.append(o)
    if outs:
        o = torch.stack(outs, dim=1)
    else:
        o = vf.new_zeros(vf.shape)
    return o.to(v.dtype), s
