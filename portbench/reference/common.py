"""Blocks the reference's families share, in float32 (TF32 off).

Positions that a decode step's exit left out of a layer do not enter it: a
layer runs over the positions whose depth reaches it, and in attention their
keys and values are zero, as the zero-initialised cache the step never wrote
holds them.

A left-padded row starts with pad tokens (id 0) at positions 0, 1, ...; causal
attention keeps them from seeing what follows, so every row's pad positions
carry the same keys and values.  :class:`Prefix` holds them, worked out once
over the longest pad, for every row to read.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def exact_matmul():
    """Float32 products in float32: no TF32 on the tensor cores."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim`` (its
    largest magnitude at 448), back in float32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Matmul:
    """``x @ w`` for activations ``[n, in]`` and weights ``[in, out]``: in float32,
    or, for the control, both operands rounded to float8 e4m3 first (a scale per
    activation row and per weight column), the product taken in float32."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.precision = precision

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if self.precision == "fp8":
            return fp8(x, -1) @ fp8(w, 0)
        return x @ w


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w.float()


def rope(x, pos, theta):
    """Split-half rotary embedding; x [n, H, hd], pos [n] absolute positions."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, qpos, K, V, chunk=1024):
    """q [n, H, hd] at positions ``qpos``; K, V [N, KV, hd] for every position (zero
    where the layer did not run).  Query at position t attends keys 0..t."""
    n, H, hd = q.shape
    KV = K.shape[1]
    G = H // KV
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(hd)
    for i in range(0, n, chunk):
        qc, pc = q[i:i + chunk], qpos[i:i + chunk]
        T = int(pc.max()) + 1
        s = torch.einsum("qkgd,tkd->kgqt", qc.reshape(-1, KV, G, hd), K[:T]) * scale
        keep = torch.arange(T, device=q.device)[None, :] <= pc[:, None]
        s = s.masked_fill(~keep, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[i:i + chunk] = torch.einsum("kgqt,tkd->qkgd", p, V[:T]).reshape(-1, H, hd)
    return out


def attention(cfg, p, h, act, N, mm, head=None, keep=None):
    """Pre-norm GQA attention over the active positions ``act`` of a row of ``N``;
    returns the block's output (the residual is the caller's).  ``head``: (keys,
    values) of the row's first positions, which ``act`` leaves out; ``keep``: a
    list that receives this layer's (keys, values) of ``act``."""
    H, KV, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    n = h.shape[0]
    hn = rms_norm(h, p["ln"], cfg["norm_eps"])
    q = rope(mm(hn, p["wq"]).view(n, H, hd), act, cfg["rope_theta"])
    k = rope(mm(hn, p["wk"]).view(n, KV, hd), act, cfg["rope_theta"])
    v = mm(hn, p["wv"]).view(n, KV, hd)
    if keep is not None:
        keep.append((k, v))
    K = torch.zeros((N, KV, hd), dtype=torch.float32, device=h.device)
    V = torch.zeros_like(K)
    if head is not None:
        P = head[0].shape[0]
        K[:P], V[:P] = head
    K[act], V[act] = k, v
    o = causal_attention(q, act, K, V)
    return mm(o.reshape(n, H * hd), p["wo"])


def swiglu(cfg, p, h, mm):
    hn = rms_norm(h, p["ln"], cfg["norm_eps"])
    return mm(F.silu(mm(hn, p["wg"])) * mm(hn, p["wu"]), p["wd"])


def unit(tree, u):
    """Unit ``u`` of a stacked parameter dict, in float32."""
    return {k: unit(v, u) if isinstance(v, dict) else v[u].float() for k, v in tree.items()}


def as_f32(tree):
    return {k: as_f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


class Row:
    """One request as the reference runs it: ``tokens`` [N] (the padded prompt,
    then each token fed to a decode step), ``depth`` [N] (segments each position
    ran), ``picks``: (position, depth) of every token picked, in order; ``pad``:
    the pad positions at its head."""

    def __init__(self, tokens, depth, picks, pad=0):
        self.tokens, self.depth, self.picks, self.pad = tokens, depth, picks, pad


class Prefix:
    """Keys and values, layer by layer, of ``n`` pad positions at full depth: the
    head of every left-padded row with at most ``n`` pad positions."""

    def __init__(self, n: int, kv):
        self.n, self.kv = n, kv

    def head(self, layer: int, pad: int):
        k, v = self.kv[layer]
        return k[:pad], v[:pad]


def head_logits(cfg, params, x, seg, n_seg, embed_f32, mm):
    """Logits over the padded vocab of hidden rows ``x`` leaving after segment
    ``seg``: the final norm after the last, that exit's norm otherwise."""
    norm = params["final_norm"] if seg == n_seg - 1 else params["exit_norms"][seg]
    return mm(rms_norm(x, norm, cfg["norm_eps"]), embed_f32.T)
