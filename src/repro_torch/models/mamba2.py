"""Mamba-2 (SSD) block and the zamba2 hybrid pattern (arXiv:2411.15242); the
counterpart of ``src/repro/models/mamba2.py``.

SSD recurrence per head (headdim ``dh=64``, state N = cfg.ssm_state):
    a_t = exp(dt_t * A_h)    (A_h < 0, scalar per head)
    S_t = a_t S_{t-1} + (dt_t x_t) B_t^T ;   y_t = S_t C_t + D_h x_t
which maps onto the shared diagonal-decay scan with q=C, k=B,
v=dt*x, per-head scalar decay broadcast over state channels.  The
broadcasts are stride-0 views; the scan kernel reads them in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import resolve
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.models.linear_scan import linear_scan
from repro_torch.tree import P

DH = 64      # mamba2 head dim
CONV_W = 4   # causal depthwise conv width


def d_inner(cfg: ModelConfig) -> int:
    return 2 * cfg.d_model


def n_heads(cfg: ModelConfig) -> int:
    return d_inner(cfg) // DH


def init_layer(generator, cfg: ModelConfig, dtype, device, stack: int = 0):
    d = cfg.d_model
    di, n, hm = d_inner(cfg), cfg.ssm_state, n_heads(cfg)
    pre = (stack,) if stack else ()

    def mk(shape, fan):
        return dense_init(generator, pre + shape, dtype, fan, device)

    def full(shape, value, dt=dtype):
        return torch.full(pre + shape, value, dtype=dt, device=device)

    return {
        "ln": full((d,), 1.0),
        # fused in_proj -> [z, x, B, C, dt]
        "w_in": mk((d, 2 * di + 2 * n + hm), d),
        "conv": mk((CONV_W, di + 2 * n), CONV_W),
        "A_log": full((hm,), 0.0, torch.float32),      # A = -exp(A_log)
        "D": full((hm,), 1.0, torch.float32),
        "dt_bias": full((hm,), 0.0, torch.float32),
        "w_out": mk((di, d), di),
        "gn": full((di,), 1.0),
    }


def spec_layer(stack: bool = False):
    pre = (None,) if stack else ()
    return {
        "ln": P(*pre, None),
        # the fused in_proj width (2*di + 2n + hm) is not 16-divisible: shard
        # the d_model (input) dim instead
        "w_in": P(*pre, "data", None),
        "conv": P(*pre, None, "model"),
        "A_log": P(*pre, None), "D": P(*pre, None), "dt_bias": P(*pre, None),
        "w_out": P(*pre, "model", "data"),
        "gn": P(*pre, "model"),
    }


def _split_in(cfg, h):
    di, n, hm = d_inner(cfg), cfg.ssm_state, n_heads(cfg)
    z, x, B_, C_, dt = torch.split(h, [di, di, n, n, hm], dim=-1)
    return z, x, B_, C_, dt


def _causal_conv(x, w, conv_state=None):
    """Depthwise causal conv, width CONV_W. x: [B,S,C]; w: [CONV_W, C].
    conv_state: [B, CONV_W-1, C] trailing context (decode)."""
    if conv_state is not None:
        x = torch.cat([conv_state.to(x.dtype), x], dim=1)
    else:
        x = F.pad(x, (0, 0, CONV_W - 1, 0))
    new_state = x[:, -(CONV_W - 1):, :]
    L_ = x.shape[1]
    out = 0
    for i in range(CONV_W):
        out = out + x[:, i: L_ - (CONV_W - 1 - i), :] * w[i]
    return out, new_state


def block(p, cfg: ModelConfig, x, state, conv_state=None, *, mode="auto",
          impl="kernel", chunk=16):
    """x: [B,S,D]; state: [B,Hm,N,DH] f32 (k-dim=N, v-dim=DH).
    Returns (out, new_state, new_conv_state)."""
    B, S, D = x.shape
    di, n, hm = d_inner(cfg), cfg.ssm_state, n_heads(cfg)
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    z, xi, Bc, Cc, dt = _split_in(cfg, xn @ p["w_in"])
    conv_in = torch.cat([xi, Bc, Cc], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, p["conv"], conv_state)
    conv_out = F.silu(conv_out)
    xi, Bc, Cc = torch.split(conv_out, [di, n, n], dim=-1)
    # softplus as jax.nn.softplus: log(1 + e^x) with no linear cut-over
    dt = torch.logaddexp(dt.float() + p["dt_bias"], torch.zeros((), device=x.device))
    A = -torch.exp(p["A_log"])                                         # [Hm]
    log_w = (dt * A)[..., None].expand(B, S, hm, n)                    # per-channel
    xh = xi.reshape(B, S, hm, DH) * dt[..., None].to(xi.dtype)         # v = dt*x
    k = Bc[:, :, None, :].expand(B, S, hm, n).to(xi.dtype)
    q = Cc[:, :, None, :].expand(B, S, hm, n).to(xi.dtype)
    y, new_state = linear_scan(q, k, xh, log_w, state, u=None, mode=mode,
                               chunk=chunk, impl=impl)                 # [B,S,Hm,DH]
    y = y + xi.reshape(B, S, hm, DH) * p["D"][:, None].to(xi.dtype)
    y = y.reshape(B, S, di)
    y = rms_norm(y, p["gn"], cfg.norm_eps) * F.silu(z)
    return y @ p["w_out"], new_state, new_conv


def init_state(cfg: ModelConfig, batch: int, device="cuda"):
    hm, n, device = n_heads(cfg), cfg.ssm_state, resolve(device)
    return {
        "ssm": torch.zeros((cfg.num_layers, batch, hm, n, DH), device=device),
        "conv": torch.zeros((cfg.num_layers, batch, CONV_W - 1, d_inner(cfg) + 2 * n),
                            device=device),
    }


def state_specs(batch_axes):
    return {
        "ssm": P(None, batch_axes, None, "model", None),
        "conv": P(None, batch_axes, None, "model"),
    }
