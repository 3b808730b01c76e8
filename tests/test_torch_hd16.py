"""Head dims 16 and 32 in the port against the JAX package on the CPU.

Every smoke config, which the simulator always builds, has 4 heads of 16
(``get_smoke_config``), and the reference's own kernel tests run its Pallas
kernels at 32.  Here, at both head dims and at the smoke stacks' G 2 and
G 1: the port's plain attention (what its wrappers run on the CPU) against
the jnp oracles and the Pallas kernels in interpret mode, at the attention
tolerance 2e-5 of ``tests/test_kernels.py``; and the emulated arithmetic
of the card's kernels (``tests/test_torch_attention_design.py``): the bf16
flash kernel running its hd-64 layout on columns that TMA fills with zeros
past the head dim, scaled by 1 / sqrt(hd) of the true head dim, and the
decode kernel's split and merge."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as ref_fa_ops
from repro.kernels.flash_attention import ref as ref_fa
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from test_torch_attention_design import (BF16_RTOL, _bf16, _oracle, _share,
                                         emulate_decode_split, emulate_flash_bf16)

ATTN_TOL = 2e-5       # the attention kernels' tolerance of tests/test_kernels.py
HEAD_DIMS = (16, 32)


def _np(x):
    return np.asarray(x.detach().float()) if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _heads_first(a):
    return jnp.asarray(a).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b", "rwkv6-3b",
                                  "llama4-scout-17b-a16e", "granite-3-2b"])
def test_the_smoke_configs_head_dim_is_a_kernel_head_dim(arch):
    cfg = get_smoke_config(arch)
    assert cfg.hd == 16 and cfg.hd in fa_ops.HEAD_DIMS
    assert set(HEAD_DIMS) <= set(fa_ops.HEAD_DIMS)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("B,H,KV,S,T,causal", [
    (1, 4, 2, 6, 6, True),          # the arena spec's 6-token prefill, G 2
    (1, 4, 4, 6, 6, True),          # zamba2's smoke stack, G 1
    (2, 4, 2, 128, 128, True),
    (1, 4, 2, 64, 192, True),       # T > S: the diagonal aligned bottom-right
    (1, 4, 4, 64, 192, False),
])
def test_flash_attention_matches_pallas(hd, B, H, KV, S, T, causal):
    """The port's plain prefill attention against the jnp oracle and the
    Pallas kernel (interpret mode; its blocks must divide S and T, so the
    6-token prefill and causal T > S, where its diagonal is top-left, are
    held against the oracle alone)."""
    q, k, v = _rand(S + T + H + hd, (B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd))
    got = _np(fa_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal))
    want = _np(ref_fa.attention(_heads_first(q), _heads_first(k), _heads_first(v),
                                causal=causal).transpose(0, 2, 1, 3))
    np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    if S % 64 == 0 and T % 64 == 0 and not (causal and T > S):
        pallas = _np(ref_fa_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                                jnp.asarray(v), causal=causal,
                                                block_q=64, block_k=64))
        np.testing.assert_allclose(got, pallas, rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("B,H,KV,T,lens", [
    (8, 4, 2, 64, [7, 0, 16, 64, 1, 12, 63, 9]),    # the arena's 8 slots, one empty
    (4, 4, 4, 192, [192, 0, 64, 65]),    # full, zero-length, on a block edge, past it
    (2, 4, 2, 64, [30, 64]),
])
def test_decode_attention_matches_pallas(hd, B, H, KV, T, lens):
    """The port's plain decode attention against the jnp oracle and the
    Pallas decode kernel (interpret mode, 64-key blocks), reading k/v
    through a view of a stacked cache as the model does."""
    q, kc, vc = _rand(T + B + hd, (B, 1, H, hd), (2, B, T, KV, hd), (2, B, T, KV, hd))
    lengths = np.asarray(lens, np.int32)
    got = fa_ops.decode_attention(torch.from_numpy(q), torch.from_numpy(kc)[1],
                                  torch.from_numpy(vc)[1], torch.from_numpy(lengths))
    if 0 in lens:
        assert not got[lens.index(0)].any()                # exactly zero
    want = ref_fa.decode_attention(_heads_first(q), _heads_first(kc[1]),
                                   _heads_first(vc[1]), jnp.asarray(lengths))
    pallas = ref_fa_ops.decode_attention(jnp.asarray(q), jnp.asarray(kc[1]),
                                         jnp.asarray(vc[1]), jnp.asarray(lengths),
                                         block_k=64)
    np.testing.assert_allclose(_np(got), _np(want).transpose(0, 2, 1, 3),
                               rtol=ATTN_TOL, atol=ATTN_TOL)
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("S,T,KV", [(6, 6, 2), (6, 6, 4), (77, 77, 2), (100, 300, 2)])
def test_flash_bf16_padded_design(hd, S, T, KV):
    """The bf16 kernel's hd-64 layout at hd 16 and 32: zero columns past hd
    add exact zeros to Q K^T, P V's extra columns come out zero and are
    never stored, and the scale is that of the true head dim; the result
    equals the unpadded arithmetic exactly and is within 2e-5 + |plain| /
    128 of the f32 oracle."""
    q, k, v = (_bf16(a) for a in _rand(S + T + hd, (1, 4, S, hd), (1, KV, T, hd),
                                       (1, KV, T, hd)))
    q_p, k_p, v_p = (torch.nn.functional.pad(x, (0, 64 - hd)) for x in (q, k, v))
    padded = emulate_flash_bf16(q_p, k_p, v_p, scale=1.0 / math.sqrt(hd))
    assert torch.equal(padded[..., hd:], torch.zeros_like(padded[..., hd:]))
    got = padded[..., :hd]
    assert torch.equal(got, emulate_flash_bf16(q, k, v))
    plain = _oracle(ref_fa.attention, q, k, v, causal=True)
    assert _share(got, plain, BF16_RTOL) <= 1.0
    wrong = emulate_flash_bf16(q_p, k_p, v_p)[..., :hd]     # 1 / sqrt(64)
    assert _share(wrong, plain, BF16_RTOL) > 1.0


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("KV", [2, 4])
@pytest.mark.parametrize("T,lens", [
    (17, [10, 0, 17, 5]),               # the serial cache: one split
    (32, [7, 0, 32, 31]),               # the arena's length: one split
    (200, [64, 65, 128, 0]),            # on a split boundary, one past it, zero
    (200, [129, 207, 5, 200]),          # past T clamps to T
])
def test_decode_split_design(hd, KV, T, lens):
    """The decode kernel's split and merge at hd 16 (lanes 16-31 own no
    column) and 32, against the oracle at 2e-5; a zero-length row is
    exactly zero."""
    B, H = 4, 4
    q, k, v = (torch.from_numpy(a) for a in _rand(T + hd + KV, (B, H, 1, hd),
                                                   (B, KV, T, hd), (B, KV, T, hd)))
    lengths = np.asarray(lens, np.int32)
    got = emulate_decode_split(q, k, v, lengths)
    plain = _oracle(ref_fa.decode_attention, q, k, v, torch.from_numpy(lengths))
    assert _share(got, plain, 0.0) <= 1.0
    for b, n in enumerate(lens):
        if n == 0:
            assert torch.equal(got[b], torch.zeros_like(got[b]))
