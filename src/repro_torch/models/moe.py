"""Top-1 Mixture-of-Experts FFN (llama4-*), the counterpart of
``src/repro/models/moe.py``.

Tokens are grouped by batch row ([G, S] with G = B), each group routed on
its own: a float32 router picks one expert a token (the first on a tie, as
``jnp.argmax``), each expert takes at most C = max(4, ⌊S · capacity_factor
· experts_per_tok / E⌋) tokens of a group in token order, and a token past
its expert's capacity is dropped (its output is exactly 0).  Two dispatches
compute the same function: ``"einsum"``, the dense one-hot dispatch and
combine products of the reference (GShard), and ``"gather"``, which
scatters each kept token into its expert's slab and gathers the outputs
back.  Both run the experts as batched products over [E, G, C, ·]: the
reference computes them outside any Pallas kernel, so here they are
``torch.einsum`` (cuBLAS on the card).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.layers import dense_init, rms_norm
from repro_torch.tree import P

DISPATCH_MODES = ("einsum", "gather")


def init_moe(generator, cfg: ModelConfig, dtype, device, stack: int = 0):
    """The router stays float32 in any model dtype, as the reference's."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    pre = (stack,) if stack else ()
    return {
        "router": dense_init(generator, pre + (d, e), torch.float32, d, device),
        "wg": dense_init(generator, pre + (e, d, f), dtype, d, device),
        "wu": dense_init(generator, pre + (e, d, f), dtype, d, device),
        "wd": dense_init(generator, pre + (e, f, d), dtype, f, device),
        "ln": torch.ones(pre + (d,), dtype=dtype, device=device),
    }


def spec_moe(stack: bool = False):
    pre = (None,) if stack else ()
    return {
        "router": P(*pre, "data", None),
        "wg": P(*pre, "model", "data", None),
        "wu": P(*pre, "model", "data", None),
        "wd": P(*pre, "model", None, "data"),
        "ln": P(*pre, None),
    }


def _capacity(tokens_per_group: int, cfg: ModelConfig) -> int:
    c = int(tokens_per_group * cfg.capacity_factor * cfg.experts_per_tok / cfg.num_experts)
    return max(4, c)


def route(p, cfg: ModelConfig, x):
    """Router probabilities [B, S, E] (float32) of x [B, S, D], and the
    normed input the experts take."""
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    logits = torch.einsum("gsd,de->gse", xn.float(), p["router"])
    return torch.softmax(logits, dim=-1), xn


def _experts(p, xe):
    """SwiGLU of every expert over its slab xe [E, G, C, D] -> [E, G, C, D]."""
    h = F.silu(torch.einsum("egcd,edf->egcf", xe, p["wg"]))
    h = h * torch.einsum("egcd,edf->egcf", xe, p["wu"])
    return torch.einsum("egcf,efd->egcd", h, p["wd"])


def moe_ffn(p, cfg: ModelConfig, x, *, dispatch_mode: str = "einsum"):
    """x: [B, S, D] -> (out [B, S, D], aux): the Switch load-balancing loss
    E · Σ_e f_e p_e in float32 (f_e the share of tokens routed to e, p_e the
    mean router probability of e)."""
    if dispatch_mode not in DISPATCH_MODES:
        raise ValueError(f"dispatch_mode must be one of {DISPATCH_MODES}, "
                         f"got {dispatch_mode!r}")
    B, S, D = x.shape
    E = cfg.num_experts
    probs, g = route(p, cfg, x)                                   # [G,S,E]
    expert_idx = torch.argmax(probs, dim=-1)                      # [G,S]
    top_p = torch.gather(probs, -1, expert_idx[..., None])[..., 0]

    onehot = F.one_hot(expert_idx, E).float()                     # [G,S,E]
    me = onehot.mean(dim=(0, 1))
    ce = probs.mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)

    C = _capacity(S, cfg)
    pos = torch.cumsum(onehot, dim=1) * onehot                    # 1-based slot
    slot = (pos - 1.0).amax(dim=-1).to(torch.int64)               # [G,S]
    keep = (slot < C) & (pos.amax(dim=-1) > 0)
    if dispatch_mode == "gather":
        return _moe_gather(p, cfg, g, expert_idx, top_p, slot, keep, C), aux

    # a slot past C is dropped (jax.nn.one_hot gives zeros out of range)
    slot_oh = F.one_hot(slot.clamp(max=C - 1), C).float() * keep[..., None]
    dispatch = (onehot[..., None] * slot_oh[..., None, :]).to(x.dtype)   # [G,S,E,C]
    combine = dispatch * top_p[..., None, None].to(x.dtype)
    xe = torch.einsum("gsec,gsd->egcd", dispatch, g)
    ye = _experts(p, xe)
    out = torch.einsum("gsec,egcd->gsd", combine, ye)
    return out.reshape(B, S, D), aux


def _moe_gather(p, cfg: ModelConfig, g, expert_idx, top_p, slot, keep, C):
    """Gather dispatch: each kept token is scattered to row ``e * C +
    slot`` of a [G, E * C + 1, D] slab (dropped tokens to the last row,
    which no expert reads), the experts run on their contiguous slabs, and
    each kept token gathers its row back, times its router probability."""
    G, S, D = g.shape
    E = cfg.num_experts
    dest = torch.where(keep, expert_idx * C + slot, E * C)        # [G,S]
    slab = torch.zeros((G, E * C + 1, D), dtype=g.dtype, device=g.device)
    slab.scatter_add_(1, dest[..., None].expand(G, S, D), g)
    xe = slab[:, :E * C].reshape(G, E, C, D).transpose(0, 1)      # [E,G,C,D]
    ye = _experts(p, xe).transpose(0, 1).reshape(G, E * C, D)
    idx = dest.clamp(max=E * C - 1)
    out = torch.gather(ye, 1, idx[..., None].expand(G, S, D))
    return out * (keep[..., None] * top_p[..., None]).to(g.dtype)
