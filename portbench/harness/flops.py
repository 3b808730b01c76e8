"""Operations and bytes of the work, counted from shapes alone.

Kernel calls (one per call of a wrapper in ``repro_torch.kernels.*.ops``): the
operations the call's arguments ask for, and each input byte read once and each
output byte written once, whatever a kernel reads again.  The counts follow the
arguments (shapes, ``lengths``, causal), never a kernel's grid or name, so a
redesign of a kernel does not move its yardstick.

Model tokens: the forward operations a request needs, at the depth each of its
positions ran (``serve_mfu``'s numerator).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple


def causal_pairs(S: int, T: int) -> int:
    """(query, key) pairs of causal attention with the diagonal aligned bottom
    right: query i sees keys j <= i + T - S."""
    off = T - S
    return sum(min(T, i + off + 1) for i in range(S))


def flash_attention(B, S, T, H, KV, hd, causal, elt) -> Tuple[float, float]:
    pairs = causal_pairs(S, T) if causal else S * T
    flops = 4.0 * B * H * hd * pairs                 # q k^T and p v, 2 each
    nbytes = elt * (2.0 * B * S * H * hd + 2.0 * B * T * KV * hd)
    return flops, nbytes


def decode_attention(B, H, KV, hd, lengths: Sequence[int], elt) -> Tuple[float, float]:
    keys = float(sum(lengths))
    flops = 4.0 * H * hd * keys
    nbytes = elt * (2.0 * B * H * hd + 2.0 * KV * hd * keys) + 4.0 * B
    return flops, nbytes


def ssm_scan(B, S, H, dk, dv, in_bytes: float, elt, bonus: bool) -> Tuple[float, float]:
    """The diagonal-decay recurrence S_t = w_t S_{t-1} + k_t v_t^T with o_t = q_t S_t:
    3 dk dv for the update (decay, outer product, sum) and 2 dk dv for the output,
    2 dk dv more with RWKV's bonus.  ``in_bytes``: the distinct bytes of q, k, v and
    log_w (a stride-0 broadcast is one read of its source); the state is read and
    written once in float32, the output written once."""
    flops = (7.0 if bonus else 5.0) * B * S * H * dk * dv
    nbytes = in_bytes + 2 * 4.0 * B * H * dk * dv + elt * B * S * H * dv
    return flops, nbytes


def exit_head(rows, D, V, elt) -> Tuple[float, float]:
    """The vocab projection of ``rows`` hidden rows, its argmax, confidence and
    entropy: 2 D V a row (the reductions are V each, left out)."""
    return 2.0 * rows * D * V, elt * (V * D + rows * D) + 12.0 * rows


def distinct_bytes(shape, stride, elt) -> float:
    n = 1
    for size, st in zip(shape, stride):
        if st:
            n *= size
    return float(n * elt)


# ---------------------------------------------------------------- model tokens

def layer_matmul_params(cfg: dict) -> Dict[str, float]:
    """Weights a token multiplies by, per kind of block."""
    d, H, KV, hd = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    attn = d * H * hd + 2 * d * KV * hd + H * hd * d
    ffn = 3 * d * cfg["d_ff"]
    out = {"attn": float(attn), "ffn": float(ffn)}
    if cfg["family"] == "hybrid":
        di, n = 2 * d, cfg["ssm_state"]
        hm = di // cfg["ssm_head_dim"]
        out["mamba"] = float(d * (2 * di + 2 * n + hm) + di * d)
    return out


def token_flops_linear(cfg: dict, layers: int) -> Tuple[float, float]:
    """(a, b): the forward operations of one token through the first ``layers``
    layers are ``a + b * ctx`` when it attends over ``ctx`` keys.  The hybrid's
    layers are Mamba-2 blocks, and its shared attention block runs after every
    ``hybrid_attn_period`` of them."""
    p = layer_matmul_params(cfg)
    per_ctx = 4.0 * cfg["num_heads"] * cfg["head_dim"]
    if cfg["family"] == "dense":
        return layers * 2 * (p["attn"] + p["ffn"]), layers * per_ctx
    d, n, P = cfg["d_model"], cfg["ssm_state"], cfg["ssm_head_dim"]
    di = 2 * d
    conv = 2.0 * cfg["conv_width"] * (di + 2 * n)
    scan = 5.0 * (di // P) * n * P
    apps = layers // cfg["hybrid_attn_period"]
    return (layers * (2 * p["mamba"] + conv + scan) + apps * 2 * (p["attn"] + p["ffn"]),
            apps * per_ctx)


def head_flops(cfg: dict) -> float:
    return 2.0 * cfg["d_model"] * cfg["vocab_size"]


def request_flops(cfg: dict, prompt_len: int, decode_layers: Sequence[int]) -> float:
    """What one request needs: its unpadded prompt at full depth (position i attends
    over i + 1 keys) with the last position's head, then each served decode token at
    the depth its step ran."""
    a, b = token_flops_linear(cfg, cfg["num_layers"])
    L = prompt_len
    f = L * a + b * L * (L + 1) / 2 + head_flops(cfg)
    for k, lay in enumerate(decode_layers):
        a, b = token_flops_linear(cfg, lay)
        f += a + b * (L + k + 1) + head_flops(cfg)
    return f
