"""Head dim 80, zamba2-2.7b's shared attention, in the port against the JAX
package on the CPU.

zamba2-2.7b's weight-shared attention has 32 heads of 80
(``src/repro/configs/zamba2_2_7b.py``), where the smoke configs use 16.
The smoke zamba2 at head_dim=80 is held against the reference model in
``tests/test_torch_ssm.py`` (its ``"zamba2-2.7b-hd80"`` case).  Here: the
port's plain attention (what its wrappers run on the CPU) at hd 80 against
the Pallas kernels in interpret mode, as the JAX package's own kernel tests
run them, and against the jnp oracles, at the attention tolerance 2e-5."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as ref_fa_ops
from repro.kernels.flash_attention import ref as ref_fa
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import Model

ARCH, HD = "zamba2-2.7b", 80
ATTN_TOL = 2e-5       # the attention kernels' tolerance of tests/test_kernels.py


def _np(x):
    return np.asarray(x.detach().float()) if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def test_the_shared_attention_runs_at_head_dim_80():
    cfg = dataclasses.replace(get_smoke_config(ARCH), head_dim=HD)
    model = Model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), dtype=torch.float32,
                               device="cpu")
    assert cfg.hd == HD and HD in fa_ops.HEAD_DIMS
    assert params["shared_attn"]["wq"].shape == (cfg.d_model, cfg.num_heads * HD)
    cache = model.init_cache(2, 10, dtype=torch.float32, device="cpu")
    assert cache["shared_k"].shape == (cfg.num_layers // cfg.hybrid_attn_period, 2, 10,
                                       cfg.num_kv_heads, HD)


# ------------------------------------------------ the kernels' plain versions
def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _heads_first(a):
    return jnp.asarray(a).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("B,H,KV,S,T,causal", [
    (1, 4, 2, 128, 128, True),
    (2, 4, 4, 64, 64, True),
    (1, 4, 2, 64, 192, True),       # T > S: the diagonal aligned bottom-right
    (1, 4, 2, 64, 192, False),
])
def test_flash_attention_at_hd80_matches_pallas(B, H, KV, S, T, causal):
    """The port's plain prefill attention at hd 80 against the jnp oracle
    and the Pallas kernel (interpret mode, 64-row blocks).  The Pallas
    kernel masks key j for query i when j > i (kernel.py:44-46), its
    diagonal aligned top-left; the model and both plain versions align it
    bottom-right (j > i + T - S), which differs only for causal T > S, so
    that case is held against the oracle alone."""
    q, k, v = _rand(S + T + H, (B, S, H, HD), (B, T, KV, HD), (B, T, KV, HD))
    got = _np(fa_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal))
    want = _np(ref_fa.attention(_heads_first(q), _heads_first(k), _heads_first(v),
                                causal=causal).transpose(0, 2, 1, 3))
    np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    if not (causal and T > S):
        pallas = _np(ref_fa_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                                jnp.asarray(v), causal=causal,
                                                block_q=64, block_k=64))
        np.testing.assert_allclose(got, pallas, rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("B,H,KV,T,lens", [
    (4, 4, 4, 192, [192, 0, 64, 65]),       # full, zero-length, on a block edge, past it
    (3, 8, 2, 128, [1, 127, 0]),
    (2, 4, 1, 64, [30, 64]),
])
def test_decode_attention_at_hd80_matches_pallas(B, H, KV, T, lens):
    """The port's plain decode attention at hd 80 against the jnp oracle and
    the Pallas decode kernel (interpret mode, 64-key blocks) with ragged
    lengths and a zero-length row, reading k/v through a view of a
    [napp, B, T, KV, hd] shared cache as the model does."""
    q, kc, vc = _rand(T + B, (B, 1, H, HD), (2, B, T, KV, HD), (2, B, T, KV, HD))
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
