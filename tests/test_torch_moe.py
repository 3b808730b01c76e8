"""The port's top-1 MoE FFN (``repro_torch.models.moe``) against the JAX
package's on the same parameters and inputs, at smoke size in float32:
both dispatch modes, tokens past their expert's capacity, a router tie,
and the float32 router of a bfloat16 model.  Outputs are held at 1e-5 and
the Switch aux loss at 1e-6.  The whole models (scout, maverick, a narrow
scout whose heads pad) are held in ``test_torch_families.py``; the kernels'
CPU routing at scout's attention shape (hd 128, 48 padded heads over 8 kv
heads, G = 6) is here."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke
from repro.kernels.flash_attention import ref as ref_fa
from repro.models import Model as RefModel
from repro.models import moe as RMOE
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import Model
from repro_torch.models import moe as MOE
from repro_torch.models.convert import params_from_numpy

ARCH = "llama4-scout-17b-a16e"
OUT_TOL, AUX_TOL = 1e-5, 1e-6
ATTN_TOL = 2e-5


def _pair(seed=0, change=None):
    rcfg, cfg = ref_get_smoke(ARCH), get_smoke_config(ARCH)
    if change:
        rcfg, cfg = dataclasses.replace(rcfg, **change), dataclasses.replace(cfg, **change)
    rp = RMOE.init_moe(jax.random.key(seed), rcfg, jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, rp)
    p = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    return rcfg, cfg, rp, p


def _x(B, S, D, seed=1, scale=0.3):
    return (np.random.default_rng(seed).standard_normal((B, S, D)) * scale).astype(np.float32)


def _run(rcfg, cfg, rp, p, x, mode):
    ry, raux = RMOE.moe_ffn(rp, rcfg, jnp.asarray(x), dispatch_mode=mode)
    y, aux = MOE.moe_ffn(p, cfg, torch.from_numpy(x), dispatch_mode=mode)
    return np.asarray(ry), float(raux), y.numpy(), float(aux)


@pytest.mark.parametrize("mode", ["einsum", "gather"])
@pytest.mark.parametrize("B,S", [(2, 16), (3, 1), (1, 40)])
def test_moe_ffn_matches_reference(mode, B, S):
    rcfg, cfg, rp, p = _pair()
    ry, raux, y, aux = _run(rcfg, cfg, rp, p, _x(B, S, cfg.d_model), mode)
    np.testing.assert_allclose(y, ry, rtol=OUT_TOL, atol=OUT_TOL)
    assert abs(aux - raux) <= AUX_TOL


def test_dispatch_modes_agree():
    """As the reference's own test (tests/test_layers.py): einsum against
    gather on the same inputs."""
    _, cfg, _, p = _pair()
    x = torch.from_numpy(_x(2, 16, cfg.d_model))
    y1, a1 = MOE.moe_ffn(p, cfg, x, dispatch_mode="einsum")
    y2, a2 = MOE.moe_ffn(p, cfg, x, dispatch_mode="gather")
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-4, atol=2e-4)
    assert float(a1) == pytest.approx(float(a2), rel=1e-5)


def test_capacity_per_row():
    """Groups are batch rows: C = max(4, floor(S * 1.25 / E)) per row, 4
    at decode."""
    cfg = get_config(ARCH)
    assert MOE._capacity(1000, cfg) == 78 == RMOE._capacity(1000, cfg)
    assert MOE._capacity(1, cfg) == 4 == RMOE._capacity(1, cfg)


@pytest.mark.parametrize("mode", ["einsum", "gather"])
def test_tokens_past_capacity_are_dropped_as_the_reference(mode):
    """64 tokens a row, 4 experts (C = 20) and a router skewed to expert 0:
    the tokens past its 20 slots give exactly 0, at the reference's
    positions, and the kept ones match."""
    rcfg, cfg, rp, p = _pair()
    bias = np.zeros((cfg.d_model, cfg.num_experts), np.float32)
    bias[:, 0] = 0.5
    rp = dict(rp, router=rp["router"] + jnp.asarray(bias))
    p = dict(p, router=p["router"] + torch.from_numpy(bias))
    x = np.abs(_x(2, 64, cfg.d_model, seed=2))           # positive: expert 0 wins
    ry, raux, y, aux = _run(rcfg, cfg, rp, p, x, mode)
    rdrop = np.all(ry == 0, axis=-1)
    drop = np.all(y == 0, axis=-1)
    assert MOE._capacity(64, cfg) == 20
    assert rdrop.sum() >= 2 * (64 - 3 * 20)             # expert 0 overflows in each row
    np.testing.assert_array_equal(drop, rdrop)
    np.testing.assert_allclose(y, ry, rtol=OUT_TOL, atol=OUT_TOL)
    assert abs(aux - raux) <= AUX_TOL


@pytest.mark.parametrize("mode", ["einsum", "gather"])
def test_router_tie_goes_to_the_first_expert(mode):
    """Experts 1 and 2 route identically (equal router columns) and differ
    in their weights: each token goes to expert 1, as ``jnp.argmax``
    picks."""
    rcfg, cfg, rp, p = _pair()
    router = np.array(rp["router"])
    router[:, 2] = router[:, 1]
    router[:, 1] += 10.0 * np.abs(router).max()           # 1 and 2 beat 0 and 3 ...
    router[:, 2] = router[:, 1]                           # ... and tie exactly
    rp = dict(rp, router=jnp.asarray(router))
    p = dict(p, router=torch.from_numpy(router))
    x = np.abs(_x(1, 4, cfg.d_model, seed=3))          # 4 tokens: within C = 4
    probs, _ = MOE.route(p, cfg, torch.from_numpy(x))
    assert torch.equal(probs[..., 1], probs[..., 2])
    assert torch.all(torch.argmax(probs, -1) == 1)
    ry, _, y, _ = _run(rcfg, cfg, rp, p, x, mode)
    np.testing.assert_allclose(y, ry, rtol=OUT_TOL, atol=OUT_TOL)
    xn = MOE.rms_norm(torch.from_numpy(x), p["ln"], cfg.norm_eps)
    e1 = (torch.nn.functional.silu(xn @ p["wg"][1]) * (xn @ p["wu"][1])) @ p["wd"][1]
    np.testing.assert_allclose(y, (probs[..., 1:2] * e1).numpy(), rtol=OUT_TOL,
                               atol=OUT_TOL)


def test_bf16_params_keep_a_float32_router():
    cfg = get_smoke_config(ARCH)
    params = Model(cfg).init_params(torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                                    device="cpu")
    moe = params["segments"][0]["moe"]
    assert moe["router"].dtype == torch.float32 and moe["wg"].dtype == torch.bfloat16
    rparams = RefModel(ref_get_smoke(ARCH)).init_params(jax.random.key(0),
                                                        dtype=jnp.bfloat16)
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    conv = params_from_numpy(cfg, tree, dtype=torch.bfloat16, device="cpu")
    seg = conv["segments"][0]["moe"]
    assert seg["router"].dtype == torch.float32 and seg["wd"].dtype == torch.bfloat16
    assert np.array_equal(seg["router"].numpy(), tree["segments"][0]["moe"]["router"])
    y, aux = MOE.moe_ffn({k: v[0] for k, v in seg.items()}, cfg,
                         torch.randn(2, 5, cfg.d_model).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _heads_first(a):
    return jnp.asarray(a).transpose(0, 2, 1, 3)


def test_wrappers_take_scouts_attention_shape_on_the_cpu():
    """hd 128, 48 query heads over 8 kv heads (G = 6, not a power of two):
    both wrappers accept the shape, run their plain versions on the CPU
    (no launch counted) and match the reference's oracles."""
    cfg = get_config(ARCH)
    H, KV, hd = cfg.padded_heads, cfg.num_kv_heads, cfg.hd
    assert (H, KV, hd, H // KV) == (48, 8, 128, 6)
    before = launch_counts()
    q, k, v = _rand(11, (1, 24, H, hd), (1, 24, KV, hd), (1, 24, KV, hd))
    got = fa_ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    want = ref_fa.attention(_heads_first(q), _heads_first(k), _heads_first(v),
                            causal=True).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATTN_TOL, atol=ATTN_TOL)
    q1, kc, vc = _rand(12, (2, 1, H, hd), (2, 40, KV, hd), (2, 40, KV, hd))
    lengths = np.array([40, 17], np.int32)
    got = fa_ops.decode_attention(torch.from_numpy(q1), torch.from_numpy(kc),
                                  torch.from_numpy(vc), torch.from_numpy(lengths))
    want = ref_fa.decode_attention(_heads_first(q1), _heads_first(kc), _heads_first(vc),
                                   jnp.asarray(lengths)).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATTN_TOL, atol=ATTN_TOL)
    assert launch_counts() == before


@pytest.mark.parametrize("arch", [ARCH, "llama4-maverick-400b-a17b"])
def test_serve_refuses_what_the_card_cannot_hold(arch):
    """On the card the launcher serves the full config in bf16: scout's
    201 GB and maverick's 787 GB of weights are refused up front, naming
    their bytes against the card's 80 GB, before any weight is made; the
    smoke config serves on the CPU."""
    from repro_torch.launch import serve
    cfg = get_config(arch)
    why = serve.refusal(cfg, True, 80 * 10**9)
    assert why is not None and f"{2 * cfg.param_count() / 1e9:.1f} GB" in why
    assert "80.0 GB" in why
    assert serve.refusal(cfg, False, 0) is None
    assert serve.refusal(get_config("llava-next-mistral-7b"), True, 80 * 10**9) is None
    stats = serve.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                        "--new-tokens", "2"])
    assert len(stats.tokens) == 2
