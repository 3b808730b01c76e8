"""The port's plain kernel versions (what each wrapper runs for a CPU
tensor) against the JAX package's oracles and its Pallas kernels run in
interpret mode, over the shape sweeps of tests/test_kernels.py.  The CUDA
kernels themselves are held against these plain versions on the card by
chip_smoke.py.

Tolerances: 2e-5 for attention, 1e-5 for the f32 exit head and 3e-4 for the
scan (those of tests/test_kernels.py), 5e-2 in bf16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.exit_head import ops as ref_eh_ops
from repro.kernels.exit_head import ref as ref_eh
from repro.kernels.flash_attention import ops as ref_fa_ops
from repro.kernels.flash_attention import ref as ref_fa
from repro.kernels.ssm_scan import ops as ref_ss_ops
from repro.kernels.ssm_scan import ref as ref_ss
from repro.models import layers as ref_layers
from repro_torch.kernels import launch_counts
from repro_torch.kernels.exit_head import ops as eh_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssm_scan import ops as ss_ops

ATOL = {"attn": 2e-5, "head": 1e-5, "scan": 3e-4, "bf16": 5e-2}


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a, jnp.float32).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------ flash attention
@pytest.mark.parametrize("B,H,KV,S,hd,causal", [
    (1, 4, 2, 256, 64, True), (2, 8, 8, 128, 32, True),
    (1, 4, 1, 256, 64, False), (2, 2, 2, 64, 128, True),
])
def test_flash_attention_matches_reference(B, H, KV, S, hd, causal):
    q, k, v = _rand(S + H, (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))
    before = launch_counts()["flash_attention"]
    got = _np(fa_ops.flash_attention(_t(q), _t(k), _t(v), causal=causal))
    assert launch_counts()["flash_attention"] == before   # CPU: no launch
    want = _np(ref_fa.attention(_j(q).transpose(0, 2, 1, 3), _j(k).transpose(0, 2, 1, 3),
                                _j(v).transpose(0, 2, 1, 3), causal=causal
                                ).transpose(0, 2, 1, 3))
    pallas = _np(ref_fa_ops.flash_attention(_j(q), _j(k), _j(v), causal=causal,
                                            block_q=64, block_k=64))
    np.testing.assert_allclose(got, want, rtol=ATOL["attn"], atol=ATOL["attn"])
    np.testing.assert_allclose(got, pallas, rtol=ATOL["attn"], atol=ATOL["attn"])


def test_flash_attention_bf16():
    B, H, S, hd = 1, 2, 128, 64
    q, k, v = _rand(9, (B, S, H, hd), (B, S, H, hd), (B, S, H, hd))
    got = _np(fa_ops.flash_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                                     _t(v, torch.bfloat16)))
    want = _np(ref_fa_ops.flash_attention(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                                          _j(v, jnp.bfloat16), block_q=64, block_k=64))
    np.testing.assert_allclose(got, want, rtol=ATOL["bf16"], atol=ATOL["bf16"])


@pytest.mark.parametrize("S", [12, 77, 1])
def test_flash_attention_ragged_against_dense(S):
    """A prompt length that divides into no tile (serve prompts are 12 long)
    against the reference model's dense masked attention."""
    B, H, KV, hd = 2, 8, 2, 64
    q, k, v = _rand(S, (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))
    got = _np(fa_ops.flash_attention(_t(q), _t(k), _t(v), causal=True))
    want = _np(ref_layers._sdpa(_j(q), _j(k), _j(v), ref_layers.causal_bias(S, S)))
    np.testing.assert_allclose(got, want, rtol=ATOL["attn"], atol=ATOL["attn"])


# ------------------------------------------------------------ decode attention
@pytest.mark.parametrize("B,H,KV,T,hd", [
    (3, 4, 2, 256, 64), (2, 8, 8, 128, 32), (1, 2, 1, 64, 128), (4, 32, 8, 77, 64),
])
def test_decode_attention_matches_reference(B, H, KV, T, hd):
    """Ragged per-row lengths with a zero-length row, read through a strided
    view of a [n_units, B, T, KV, hd] cache as the model does."""
    q, kc, vc = _rand(T + H, (B, 1, H, hd), (2, B, T, KV, hd), (2, B, T, KV, hd))
    lengths = np.random.default_rng(T).integers(1, T + 1, B).astype(np.int32)
    lengths[-1] = 0
    got = fa_ops.decode_attention(_t(q), _t(kc)[1], _t(vc)[1],
                                  torch.from_numpy(lengths))
    assert not got[-1].any()                              # zero-length row
    want = ref_fa.decode_attention(_j(q).transpose(0, 2, 1, 3),
                                   _j(kc[1]).transpose(0, 2, 1, 3),
                                   _j(vc[1]).transpose(0, 2, 1, 3),
                                   jnp.asarray(lengths)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), _np(want), rtol=ATOL["attn"], atol=ATOL["attn"])
    if T % 64 == 0:
        pallas = ref_fa_ops.decode_attention(_j(q), _j(kc[1]), _j(vc[1]),
                                             jnp.asarray(lengths), block_k=64)
        np.testing.assert_allclose(_np(got), _np(pallas), rtol=ATOL["attn"],
                                   atol=ATOL["attn"])


def test_decode_attention_bf16():
    B, H, T, hd = 2, 4, 128, 64
    q, k, v = _rand(5, (B, 1, H, hd), (B, T, H, hd), (B, T, H, hd))
    lengths = np.asarray([7, 128], np.int32)
    got = fa_ops.decode_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                                  _t(v, torch.bfloat16), torch.from_numpy(lengths))
    want = ref_fa_ops.decode_attention(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                                       _j(v, jnp.bfloat16), jnp.asarray(lengths),
                                       block_k=64)
    np.testing.assert_allclose(_np(got), _np(want), rtol=ATOL["bf16"], atol=ATOL["bf16"])


def test_decode_attention_matches_causal_last_row():
    """Decoding position L-1 with lengths=[L] equals the last row of the
    causal prefill: the decode path prices exactly the step prefill ends on."""
    B, H, T, hd = 1, 2, 64, 32
    q, k, v = _rand(11, (B, T, H, hd), (B, T, H, hd), (B, T, H, hd))
    full = fa_ops.flash_attention(_t(q), _t(k), _t(v))
    got = fa_ops.decode_attention(_t(q)[:, -1:].contiguous(), _t(k), _t(v),
                                  torch.tensor([T], dtype=torch.int32))
    np.testing.assert_allclose(_np(got), _np(full[:, -1:]), rtol=ATOL["attn"],
                               atol=ATOL["attn"])


# ---------------------------------------------------------------- exit head
@pytest.mark.parametrize("B,S,D,V", [
    (2, 4, 64, 1000), (1, 7, 128, 313), (3, 1, 32, 2048), (1, 1, 16, 17),
])
def test_exit_head_matches_reference(B, S, D, V):
    h, emb = _rand(B * S + D + V, (B, S, D), (V, D))
    got = eh_ops.exit_confidence(_t(h), _t(emb))
    want = ref_eh.exit_confidence(_j(h), _j(emb))
    pallas = ref_eh_ops.exit_confidence(_j(h), _j(emb), tile_rows=8, tile_v=128)
    for other in (want, pallas):
        assert np.array_equal(got["token"].numpy(), np.asarray(other["token"]))
        for key in ("conf", "entropy"):
            np.testing.assert_allclose(_np(got[key]), _np(other[key]),
                                       rtol=ATOL["head"], atol=ATOL["head"])
    assert got["token"].dtype == torch.int32


def test_exit_head_bf16():
    B, S, D, V = 2, 4, 64, 1000
    h, emb = _rand(3, (B, S, D), (V, D))
    hb, eb = _t(h, torch.bfloat16), _t(emb, torch.bfloat16)
    got = eh_ops.exit_confidence(hb, eb)
    want = ref_eh.exit_confidence(_j(h, jnp.bfloat16), _j(emb, jnp.bfloat16))
    for key in ("conf", "entropy"):
        np.testing.assert_allclose(_np(got[key]), _np(want[key]),
                                   rtol=ATOL["bf16"], atol=ATOL["bf16"])
    # bf16 logits tie often: each side's token must carry the top logit
    logits = np.einsum("bsd,vd->bsv", _np(hb), _np(eb))
    top = logits.max(-1)
    for tok in (got["token"].numpy(), np.asarray(want["token"])):
        picked = np.take_along_axis(logits, tok[..., None].astype(np.int64), -1)[..., 0]
        np.testing.assert_allclose(picked, top, rtol=0, atol=ATOL["bf16"] * np.abs(top).max())


def test_exit_head_ties_take_first_index():
    """Exact ties (integer-valued rows, so every dot product is exact) go to
    the first index in every implementation."""
    rng = np.random.default_rng(0)
    D, V = 16, 700
    emb = rng.integers(-3, 4, (V, D)).astype(np.float32)
    emb[650] = emb[3] = np.full(D, 2.0, np.float32)
    emb[400] = emb[3]
    h = np.full((1, 2, D), 1.0, np.float32)
    got = eh_ops.exit_confidence(_t(h), _t(emb))
    want = ref_eh.exit_confidence(_j(h), _j(emb))
    pallas = ref_eh_ops.exit_confidence(_j(h), _j(emb), tile_rows=8, tile_v=128)
    assert got["token"].tolist() == [[3, 3]]
    assert np.asarray(want["token"]).tolist() == [[3, 3]]
    assert np.asarray(pallas["token"]).tolist() == [[3, 3]]


# ---------------------------------------------------------------- ssm scan
@pytest.mark.parametrize("rwkv", [True, False], ids=["rwkv", "mamba2"])
@pytest.mark.parametrize("B,S,H,dk,dv", [
    (2, 64, 3, 8, 16), (1, 32, 2, 64, 64), (1, 128, 4, 16, 64),
])
def test_ssm_scan_matches_reference(B, S, H, dk, dv, rwkv):
    """The sweep of tests/test_kernels.py in both modes, against the
    reference's sequential oracle and its Pallas kernel in interpret mode."""
    q, k, v, lw, st0, u = _rand(S + dk, (B, S, H, dk), (B, S, H, dk), (B, S, H, dv),
                                (B, S, H, dk), (B, H, dk, dv), (H, dk))
    lw, st0, u = -np.exp(lw * 0.5), st0 * 0.1, (u * 0.1 if rwkv else None)
    before = launch_counts()["ssm_scan"]
    o, s1 = ss_ops.ssm_scan(_t(q), _t(k), _t(v), _t(lw), _t(st0),
                            u=None if u is None else _t(u))
    assert launch_counts()["ssm_scan"] == before         # CPU: no launch
    assert o.dtype == torch.float32 and s1.dtype == torch.float32
    ju = None if u is None else _j(u)
    want = ref_ss.ssm_scan(_j(q), _j(k), _j(v), _j(lw), _j(st0), u=ju)
    pallas = ref_ss_ops.ssm_scan(_j(q), _j(k), _j(v), _j(lw), _j(st0), u=ju, chunk=16)
    for wo, ws in (want, pallas):
        np.testing.assert_allclose(_np(o), _np(wo), rtol=ATOL["scan"], atol=ATOL["scan"])
        np.testing.assert_allclose(_np(s1), _np(ws), rtol=ATOL["scan"], atol=ATOL["scan"])


def test_ssm_scan_bf16_and_broadcast_views():
    """bf16 q/k/v with f32 decay and state, and the Mamba-2 block's stride-0
    views (B and C broadcast over heads, the decay over state channels):
    output in v's dtype, state in f32, against the reference's oracle."""
    B, S, H, N, DH = 1, 20, 3, 16, 16
    bc, cc, x, dt = _rand(4, (B, S, N), (B, S, N), (B, S, H, DH), (B, S, H))
    lw = -np.exp(dt * 0.5)
    k = _t(bc, torch.bfloat16)[:, :, None].expand(B, S, H, N)
    q = _t(cc, torch.bfloat16)[:, :, None].expand(B, S, H, N)
    w = _t(lw)[..., None].expand(B, S, H, N)
    o, s1 = ss_ops.ssm_scan(q, k, _t(x, torch.bfloat16), w, torch.zeros(B, H, N, DH))
    assert o.dtype == torch.bfloat16 and s1.dtype == torch.float32
    wo, ws = ref_ss.ssm_scan(
        jnp.broadcast_to(_j(cc, jnp.bfloat16)[:, :, None], (B, S, H, N)),
        jnp.broadcast_to(_j(bc, jnp.bfloat16)[:, :, None], (B, S, H, N)),
        _j(x, jnp.bfloat16), jnp.broadcast_to(_j(lw)[..., None], (B, S, H, N)),
        jnp.zeros((B, H, N, DH)))
    np.testing.assert_allclose(_np(o), _np(wo), rtol=ATOL["bf16"], atol=ATOL["bf16"])
    np.testing.assert_allclose(_np(s1), _np(ws), rtol=ATOL["scan"], atol=ATOL["scan"])


def test_ssm_scan_plain_version_widens_float64():
    """The plain scan computes in float32 for float32 and bfloat16 inputs and
    in float64 for float64 ones (a more precise path to measure the float32
    paths against)."""
    q, k, v, lw, st0, u = _rand(9, (1, 24, 2, 16), (1, 24, 2, 16), (1, 24, 2, 8),
                                (1, 24, 2, 16), (1, 2, 16, 8), (2, 16))
    lw = -np.exp(lw * 0.5)
    args32 = [_t(a) for a in (q, k, v, lw, st0, u)]
    o32, s32 = ss_ops.ssm_scan(*args32[:5], u=args32[5])
    o64, s64 = ss_ops.ssm_scan(*(a.double() for a in args32[:5]), u=args32[5].double())
    assert o32.dtype == s32.dtype == torch.float32
    assert o64.dtype == s64.dtype == torch.float64
    assert not torch.equal(o64.float(), o32)
    np.testing.assert_allclose(_np(o32), o64.numpy(), rtol=ATOL["scan"], atol=ATOL["scan"])
    np.testing.assert_allclose(_np(s32), s64.numpy(), rtol=ATOL["scan"], atol=ATOL["scan"])
