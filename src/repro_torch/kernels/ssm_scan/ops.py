"""Wrapper for the SSM scan kernels, in the model layout (the contract of
``src/repro/kernels/ssm_scan/ops.py``): q/k/log_w [B,S,H,dk], v [B,S,H,dv],
state [B,H,dk,dv], u [H,dk] or None.

A CPU tensor goes to the plain version in :mod:`.ref`.  A CUDA tensor goes
to one of the two kernels of ``csrc/ssm_scan.cu``, chosen by :func:`route`
from the dtype and the shape alone, or the wrapper raises: there is no
fallback, and a launch that fails is never retried on the other kernel.

* ``chunked`` (``ssm_scan_chunked_fwd``): bfloat16 with dk = dv = 64 and
  S >= :data:`CHUNK`, the served prefill.  It reads q, k, v and log_w with
  TMA, which needs a unit channel stride, 16-byte aligned rows and other
  strides in whole 16 bytes.  The model's inputs meet that as they are: the
  Mamba-2 block's B and C broadcast over heads (stride 0, mapped as a single
  head) and its per-head decay broadcast over channels (read from its
  ``[B, S, H]`` source, which a kernel of its own takes).  An input that
  does not is copied first, in the layout the kernels take
  (:func:`tma_operands`): a contiguous copy of q, k, v or a per-channel
  log_w; a per-head decay with its heads padded to a multiple of 4 (a box
  of TMA is 16 bytes wide), or, under 4 heads or in the RWKV mode, expanded
  over the channels.
* ``stepped`` (``ssm_scan_fwd``): every other call, float32 (held at f32
  tolerances, which the tensor cores' TF32 would break), decode (S 1),
  short prompts and other widths.  It reads q, k, v and log_w through their
  strides, stride-0 broadcasts in place, without copies.

Each launch adds one to ``LAUNCHES["ssm_scan"]`` and one to the count of
its kernel, ``LAUNCHES["ssm_scan.chunked"]`` or ``["ssm_scan.stepped"]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssm_scan import ref

#: kernel launches since the last reset (see repro_torch.kernels): all, and
#: by kernel
LAUNCHES = {"ssm_scan": 0, "ssm_scan.chunked": 0, "ssm_scan.stepped": 0}
#: key (state row) widths the stepped kernel is built for
KEY_DIMS = (16, 32, 64, 128)
#: tokens a chunk of the chunked kernel (kC in csrc/ssm_scan.cu); a bf16
#: scan of fewer tokens is one ragged chunk, and goes to the stepped kernel
CHUNK = 16
#: the chunked kernel's (dk, dv)
CHUNKED_DIMS = (64, 64)


def route(q: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a CUDA call runs: ``"chunked"`` for bf16 at
    :data:`CHUNKED_DIMS` and S >= :data:`CHUNK`, else ``"stepped"``."""
    if (q.dtype == torch.bfloat16 and (q.shape[-1], v.shape[-1]) == CHUNKED_DIMS
            and q.shape[1] >= CHUNK):
        return "chunked"
    return "stepped"


def _tma_ready(t: torch.Tensor, broadcast_dim=None) -> bool:
    """``t`` can back a TMA map as it is: 16-byte aligned, unit last stride,
    every other stride in whole 16 bytes and non-zero, except a stride 0 on
    ``broadcast_dim``."""
    es = t.element_size()
    return (t.data_ptr() % 16 == 0 and t.stride(-1) == 1
            and all(st * es % 16 == 0 and (st != 0 or i == broadcast_dim)
                    for i, st in enumerate(t.stride()[:-1])))


def _dense(t: torch.Tensor) -> torch.Tensor:
    return t.clone(memory_format=torch.contiguous_format)


def tma_operands(q, k, v, lw, rwkv):
    """q, k, v and log_w (float32) as the chunked kernels read them, copied
    only where TMA cannot read them in place (see the module docstring).
    Returns (q, k, v, w, w_strides): ``w`` is log_w, or, in the Mamba-2 mode
    (``rwkv`` false), the ``[B, S, H]`` source of a per-head decay, whose
    strides end in 0 for the channels."""
    q, k = (t if _tma_ready(t, broadcast_dim=2) else _dense(t) for t in (q, k))
    v = v if _tma_ready(v) else _dense(v)
    B, S, H, _ = lw.shape
    if lw.stride(-1) == 0 and H >= 4 and not rwkv:
        w = lw[..., 0]
        if not _tma_ready(w):
            pad = torch.zeros((B, S, -(-H // 4) * 4), dtype=lw.dtype, device=lw.device)
            pad[..., :H] = w
            w = pad[..., :H]
        return q, k, v, w, (*w.stride(), 0)
    w = lw if _tma_ready(lw) else _dense(lw)
    return q, k, v, w, w.stride()


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
    kind = route(q, v)
    if kind == "chunked":
        q, k, v, lw, w_strides = tma_operands(q, k, v, lw, rwkv=u is not None)
        fn = lib.ssm_scan_chunked_fwd
    else:
        w_strides = lw.stride()
        fn = lib.ssm_scan_fwd
    build.check(fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(), s0.data_ptr(),
        0 if uu is None else uu.data_ptr(), o.data_ptr(), s_out.data_ptr(),
        B, S, H, dk, dv, *q.stride(), *k.stride(), *v.stride(), *w_strides,
        build.dtype_code(q), build.stream(q)), f"ssm_scan ({kind})")
    LAUNCHES["ssm_scan"] += 1
    LAUNCHES[f"ssm_scan.{kind}"] += 1
    return o, s_out
