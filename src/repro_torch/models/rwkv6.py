"""RWKV-6 "Finch" — attention-free RNN with data-dependent decay
(arXiv:2404.05892), adapted to the shared diagonal-decay linear scan; the
counterpart of ``src/repro/models/rwkv6.py``.

Per layer: time-mix (token shift, r/k/v/g projections, data-dependent decay
w_t = exp(-exp(w0 + tanh(x @ A) @ B)), wkv state recurrence with bonus u) and
channel-mix (squared-relu MLP with receptance gate).  ``impl`` selects the
scan (see :func:`repro_torch.models.linear_scan.linear_scan`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import resolve
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.models.linear_scan import linear_scan
from repro_torch.tree import P

LORA_R = 64


def init_layer(generator, cfg: ModelConfig, dtype, device, stack: int = 0):
    d, f = cfg.d_model, cfg.d_ff
    pre = (stack,) if stack else ()

    def mk(shape, fan, dt=dtype):
        return dense_init(generator, pre + shape, dt, fan, device)

    def full(shape, value, dt=dtype):
        return torch.full(pre + shape, value, dtype=dt, device=device)

    return {
        "ln1": full((d,), 1.0),
        "ln2": full((d,), 1.0),
        "mu": full((5, d), 0.5),                       # shift-mix for r,k,v,g,w
        "wr": mk((d, d), d),
        "wk": mk((d, d), d),
        "wv": mk((d, d), d),
        "wg": mk((d, d), d),
        "wo": mk((d, d), d),
        "w0": full((d,), -6.0, torch.float32),          # base log-log decay
        "wA": mk((d, LORA_R), d),
        "wB": mk((LORA_R, d), LORA_R),
        "u": mk((cfg.num_heads, cfg.hd), cfg.hd, torch.float32),
        "gn": full((d,), 1.0),
        "cm_mu": full((2, d), 0.5),
        "cm_k": mk((d, f), d),
        "cm_v": mk((f, d), f),
        "cm_r": mk((d, d), d),
    }


def spec_layer(stack: bool = False):
    pre = (None,) if stack else ()
    d2 = P(*pre, "data", "model")
    return {
        "ln1": P(*pre, None), "ln2": P(*pre, None), "mu": P(*pre, None, None),
        "wr": d2, "wk": d2, "wv": d2, "wg": d2,
        "wo": P(*pre, "model", "data"),
        "w0": P(*pre, None), "wA": P(*pre, "data", None), "wB": P(*pre, None, "data"),
        "u": P(*pre, None, None), "gn": P(*pre, None),
        "cm_mu": P(*pre, None, None),
        "cm_k": d2, "cm_v": P(*pre, "model", "data"), "cm_r": P(*pre, "data", "model"),
    }


def _shift(x, last):
    """Token shift: returns x_{t-1} per position; ``last`` is [B,1,D] carry
    (previous token of the preceding chunk / step)."""
    return torch.cat([last, x[:, :-1]], dim=1)


def time_mix(p, cfg: ModelConfig, x, state, last, *, mode="auto", impl="kernel",
             chunk=16):
    """x: [B,S,D]; state: [B,H,hd,hd] f32; last: [B,1,D] previous token.
    Returns (out, new_state, new_last)."""
    B, S, D = x.shape
    H, hd = cfg.num_heads, cfg.hd
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    xx = _shift(xn, last)
    mu = p["mu"]
    xr, xk, xv, xg, xw = (xn + (xx - xn) * mu[i] for i in range(5))
    r = (xr @ p["wr"]).reshape(B, S, H, hd)
    k = (xk @ p["wk"]).reshape(B, S, H, hd)
    v = (xv @ p["wv"]).reshape(B, S, H, hd)
    g = F.silu(xg @ p["wg"])
    # data-dependent decay (the Finch hallmark), in f32
    ddw = torch.tanh(xw @ p["wA"]) @ p["wB"]
    log_w = -torch.exp(torch.clamp(p["w0"] + ddw.float(), -20.0, 3.0))
    log_w = log_w.reshape(B, S, H, hd)
    o, new_state = linear_scan(r, k, v, log_w, state, u=p["u"], mode=mode,
                               chunk=chunk, impl=impl)
    # group norm over heads (population variance, as jnp.var)
    og = o.reshape(B, S, H, hd)
    og = (og - og.mean(-1, keepdim=True)) * torch.rsqrt(
        og.var(-1, keepdim=True, unbiased=False) + cfg.norm_eps)
    o = og.reshape(B, S, D).to(x.dtype) * p["gn"] * g
    return o @ p["wo"], new_state, xn[:, -1:, :]


def channel_mix(p, cfg: ModelConfig, x, last):
    xn = rms_norm(x, p["ln2"], cfg.norm_eps)
    xx = _shift(xn, last)
    xk = xn + (xx - xn) * p["cm_mu"][0]
    xr = xn + (xx - xn) * p["cm_mu"][1]
    k = torch.square(F.relu(xk @ p["cm_k"]))
    return torch.sigmoid(xr @ p["cm_r"]) * (k @ p["cm_v"]), xn[:, -1:, :]


def block(p, cfg: ModelConfig, x, state, lasts, *, mode="auto", impl="kernel",
          chunk=16):
    """One RWKV layer.  ``lasts`` = (last_tm, last_cm) each [B,1,D]."""
    tm, new_state, l1 = time_mix(p, cfg, x, state, lasts[0], mode=mode, impl=impl,
                                 chunk=chunk)
    x = x + tm
    cm, l2 = channel_mix(p, cfg, x, lasts[1])
    return x + cm, new_state, (l1, l2)


def init_state(cfg: ModelConfig, batch: int, device="cuda"):
    """Recurrent state shipped at a partition cut (see DESIGN.md §4)."""
    L_, d, device = cfg.num_layers, cfg.d_model, resolve(device)
    return {
        "wkv": torch.zeros((L_, batch, cfg.num_heads, cfg.hd, cfg.hd), device=device),
        "last_tm": torch.zeros((L_, batch, 1, d), device=device),
        "last_cm": torch.zeros((L_, batch, 1, d), device=device),
    }


def state_specs(batch_axes):
    """Sharding of :func:`init_state`: heads (40) do not divide the 16-way
    model axis, so the key channels are sharded instead."""
    return {
        "wkv": P(None, batch_axes, None, "model", None),
        "last_tm": P(None, batch_axes, None, None),
        "last_cm": P(None, batch_axes, None, None),
    }
