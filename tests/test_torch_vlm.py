"""The VLM prefix and the int8 KV cache of the port against the JAX
package, at smoke size on the CPU.

The VLM (llava-next-mistral-7b) puts ``prefix_emb @ mm_proj`` in front of
the text; the whole model with its 8 prefix embeddings is held in
``test_torch_families.py``, and here the text backbone alone (no prefix:
what the serving engine runs, as the reference's).

The int8 cache (``init_cache(quant=True)``) stores k/v as int8 with bf16
scales per (position, kv head).  Its bytes and scales are held equal to
the reference's after prefill and after decode: through the whole float32
model, and through one attention layer in float32 and bfloat16 on the
same inputs (a whole bfloat16 model feeds its later layers k/v that the
two frameworks' bf16 products round apart, so their bytes may differ by a
step there, as the k/v they quantize do); its decode within rel 0.05 of
the unquantized cache's (the reference's own bound,
``tests/test_perf_features.py``); its bytes under 0.6 of the unquantized
bf16 cache's; and a value exactly halfway between two int8 steps rounds
to even, as ``jnp.round``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke
from repro.models import Model as RefModel
from repro_torch import tree as T
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import Model
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy

ARCH = "llava-next-mistral-7b"
HIDDEN_TOL = 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def pair():
    rcfg, cfg = ref_get_smoke(ARCH), get_smoke_config(ARCH)
    rmodel, model = RefModel(rcfg), Model(cfg)
    rparams = rmodel.init_params(jax.random.key(0), dtype=jnp.float32)
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, rparams),
                               device="cpu")
    return rmodel, rparams, model, params


def _np(x):
    return np.asarray(x.detach().float()) if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(np.int32)


def _prefix(B, P, seed=4):
    return np.random.default_rng(seed).standard_normal((B, P, 1024)).astype(np.float32)


def _int8_caches_equal(rcache, cache):
    rl, pl = T.leaves_with_paths(rcache), T.leaves_with_paths(cache)
    assert [k for k, _ in rl] == [k for k, _ in pl]
    for (key, r), (_, p) in zip(rl, pl):
        r = np.asarray(r)
        if key.endswith("_scale"):
            assert p.dtype == torch.bfloat16 and str(r.dtype) == "bfloat16", key
            assert np.array_equal(p.float().numpy(), r.astype(np.float32)), key
        else:
            assert p.dtype == torch.int8 and r.dtype == np.int8, key
            assert np.array_equal(p.numpy(), r), key


def test_int8_cache_bytes_and_scales_equal_the_reference(pair):
    """Float32 models: after a prefill with the 8-embedding prefix and
    after two decode steps (the second at exit 0), every int8 value and
    bf16 scale equals the reference's."""
    rmodel, rparams, model, params = pair
    B, S = 2, 6
    P = model.cfg.num_prefix_tokens
    toks, pre = _tokens(B, S, 0), _prefix(B, P)
    T_ = P + S + 3
    rc = rmodel.init_cache(B, T_, dtype=jnp.float32, quant=True)
    c = model.init_cache(B, T_, dtype=torch.float32, device="cpu", quant=True)
    rh, rc = rmodel.prefill(rparams, jnp.asarray(toks), rc, prefix_emb=jnp.asarray(pre))
    h, c = model.prefill(params, torch.from_numpy(toks), c, prefix_emb=torch.from_numpy(pre))
    _int8_caches_equal(rc, c)
    for step, exit_point in ((0, None), (1, 0)):
        nxt = np.asarray([[3 + step], [9]], np.int32)
        rh, rc, _ = rmodel.decode_step(rparams, rc, jnp.asarray(nxt),
                                       jnp.asarray(P + S + step, jnp.int32),
                                       exit_point=exit_point)
        h, c, _ = model.decode_step(params, c, torch.from_numpy(nxt), P + S + step,
                                    exit_point=exit_point)
        _int8_caches_equal(rc, c)
        np.testing.assert_allclose(_np(h), _np(rh), rtol=HIDDEN_TOL, atol=HIDDEN_TOL)


@pytest.mark.parametrize("impl", ["kernel", "dense"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_attention_layer_cache_equals_the_reference(dtype, impl):
    """One attention layer, its input x the same on both sides: a 6-token
    prefill into an int8 cache, then two decode steps; after each, every
    int8 value and bf16 scale equals the reference's."""
    from repro.models import layers as RL
    jdt, tdt = DTYPES[dtype]
    rcfg, cfg = ref_get_smoke(ARCH), get_smoke_config(ARCH)
    rp = RL.init_attn(jax.random.key(3), rcfg, jdt)
    p = {k: torch.from_numpy(np.array(v, np.float32)).to(tdt) for k, v in rp.items()}
    B, S, T_ = 2, 6, 9
    kvh, hd = cfg.num_kv_heads, cfg.hd
    x = np.random.default_rng(0).standard_normal((B, S + 2, cfg.d_model)).astype(np.float32)
    xj, xt = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    pos = np.broadcast_to(np.arange(S + 2), (B, S + 2))
    rc = {"k": jnp.zeros((B, T_, kvh, hd), jnp.int8), "v": jnp.zeros((B, T_, kvh, hd), jnp.int8),
          "k_scale": jnp.zeros((B, T_, kvh), jnp.bfloat16),
          "v_scale": jnp.zeros((B, T_, kvh), jnp.bfloat16)}
    c = {k: torch.zeros(v.shape, dtype=torch.int8 if v.dtype == jnp.int8 else torch.bfloat16)
         for k, v in rc.items()}
    _, rc = RL.attention(rp, rcfg, xj[:, :S], jnp.asarray(pos[:, :S]), kv_cache=rc,
                         cache_pos=0, prefill_mode=True)
    L.attention(p, cfg, xt[:, :S], torch.from_numpy(pos[:, :S].copy()), kv_cache=c,
                cache_pos=0, prefill_mode=True, impl=impl)
    _int8_caches_equal(rc, c)
    for t in (S, S + 1):
        rout, rc = RL.attention(rp, rcfg, xj[:, t:t + 1], jnp.asarray(pos[:, t:t + 1]),
                                kv_cache=rc, cache_pos=jnp.asarray(t))
        out, _ = L.attention(p, cfg, xt[:, t:t + 1], torch.from_numpy(pos[:, t:t + 1].copy()),
                             kv_cache=c, cache_pos=t, impl=impl)
        _int8_caches_equal(rc, c)
        tol = HIDDEN_TOL if tdt == torch.float32 else 2.0 ** -6
        np.testing.assert_allclose(_np(out), _np(rout), rtol=tol, atol=tol)


@pytest.mark.parametrize("impl", ["kernel", "dense"])
def test_int8_decode_close_to_the_unquantized_cache(impl):
    """The reference's bound: decode's hidden state within rel 0.05 of the
    unquantized cache's, on the same prefill."""
    cfg = get_smoke_config(ARCH)
    model = Model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), dtype=torch.float32,
                               device="cpu")
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(B, S, 1))
    nt = torch.from_numpy(_tokens(B, 1, 2))
    hs = {}
    for quant in (False, True):
        c = model.init_cache(B, S + 4, dtype=torch.float32, device="cpu", quant=quant)
        _, c = model.prefill(params, toks, c, impl=impl)
        hs[quant], _, _ = model.decode_step(params, c, nt, S, impl=impl)
    rel = float((hs[False] - hs[True]).abs().max() / hs[False].abs().max())
    assert 0 < rel < 0.05, rel


def _cache_bytes(cache):
    return sum(t.numel() * t.element_size() for t in T.leaves(cache))


def test_int8_cache_bytes_under_six_tenths():
    """At the full config (32 layers, 8 kv heads of 128): int8 k/v plus
    bf16 scales against the bf16 cache, shapes only (meta tensors)."""
    model = Model(get_config(ARCH))
    full = _cache_bytes(model.init_cache(4, 1024, dtype=torch.bfloat16, device="meta"))
    quant = _cache_bytes(model.init_cache(4, 1024, dtype=torch.bfloat16, device="meta",
                                          quant=True))
    assert quant < 0.6 * full
    assert quant == full // 2 + full // 128         # 1 byte a value + 2 a 128-value row


def test_halfway_values_round_to_even():
    """k/v values exactly halfway between two int8 steps (scale 1: a row's
    max is 127) round half to even, as the reference's ``jnp.round``."""
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]])
    q, sc = L.quantize_int8(x)
    assert sc.dtype == torch.bfloat16 and float(sc) == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, -2, 126]]
    assert np.array_equal(q.numpy(), np.asarray(
        jnp.clip(jnp.round(jnp.asarray(x.numpy())), -127, 127)).astype(np.int8))


def test_halfway_values_in_the_model_cache_match_the_reference():
    """The same halfway values through both models' prefill: one token at
    position 0 (RoPE is the identity there) whose normed embedding is 8
    times a unit vector, and a ``wk`` row that makes k the halfway
    values; the cached int8 k equals the reference's and rounds to even."""
    rcfg, cfg = ref_get_smoke(ARCH), get_smoke_config(ARCH)
    rmodel, model = RefModel(rcfg), Model(cfg)
    tree = jax.tree_util.tree_map(np.array, rmodel.init_params(jax.random.key(0),
                                                               dtype=jnp.float32))
    hd, D = cfg.hd, cfg.d_model
    want = np.resize(np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5], np.float32), hd)
    tree["embed"][7] = 0.0
    tree["embed"][7, 0] = 1024.0                           # rms_norm -> 8 at column 0
    wk = tree["segments"][0]["attn"]["wk"]
    wk[0, 0] = 0.0
    wk[0, 0, :hd] = want / 8.0
    rparams = jax.tree_util.tree_map(jnp.asarray, tree)
    params = params_from_numpy(cfg, tree, device="cpu")
    toks = np.full((1, 1), 7, np.int32)
    rc = rmodel.init_cache(1, 2, dtype=jnp.float32, quant=True)
    c = model.init_cache(1, 2, dtype=torch.float32, device="cpu", quant=True)
    _, rc = rmodel.prefill(rparams, jnp.asarray(toks), rc)
    _, c = model.prefill(params, torch.from_numpy(toks), c)
    got = c[0]["attn_k"][0, 0, 0, 0].numpy()
    assert float(c[0]["attn_k_scale"][0, 0, 0, 0]) == 1.0
    assert np.array_equal(got, np.asarray(rc[0]["attn_k"])[0, 0, 0, 0])
    assert np.array_equal(got[:8], [127, 0, 2, 2, 0, -2, -2, 4])


def test_masked_commit_writes_every_int8_leaf():
    """The arena's masked commit on an int8 cache: rows in the mask get the
    step's int8 values and scales (those of an unmasked step), the row
    outside keeps all four leaves bit for bit."""
    cfg = get_smoke_config(ARCH)
    model = Model(cfg)
    params = model.init_params(torch.Generator().manual_seed(1), dtype=torch.float32,
                               device="cpu")
    B, S = 3, 5
    c = model.init_cache(B, S + 3, dtype=torch.float32, device="cpu", quant=True)
    _, c = model.prefill(params, torch.from_numpy(_tokens(B, S, 3)), c)
    nxt = torch.from_numpy(_tokens(B, 1, 4))
    pos = torch.tensor([S, S + 1, S])
    ref_c = T.tree_map(lambda t: t.clone(), c)
    model.decode_step(params, ref_c, nxt, pos)
    old = T.tree_map(lambda t: t.clone(), c)
    mask = torch.tensor([True, False, True])
    model.decode_step(params, c, nxt, pos, mask=mask)
    leaves = T.leaves_with_paths(c)
    assert {k.rsplit("/", 1)[1] for k, _ in leaves} == {
        "attn_k", "attn_v", "attn_k_scale", "attn_v_scale"}
    for (key, t), o, r in zip(leaves, T.leaves(old), T.leaves(ref_c)):
        assert torch.equal(t[:, 1], o[:, 1]), key
        assert torch.equal(t[:, mask], r[:, mask]), key
        assert not torch.equal(t[:, 0], o[:, 0]), key


def test_text_backbone_without_prefix_matches_reference():
    """The serving engine feeds no prefix, as the reference's: llava then
    runs as its mistral-7b text backbone, positions from 0."""
    rcfg, cfg = ref_get_smoke(ARCH), get_smoke_config(ARCH)
    rmodel, model = RefModel(rcfg), Model(cfg)
    rparams = rmodel.init_params(jax.random.key(0), dtype=jnp.float32)
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, rparams),
                               device="cpu")
    toks = _tokens(2, 7, 5)
    rh, _ = rmodel.prefill(rparams, jnp.asarray(toks), rmodel.init_cache(2, 9, jnp.float32))
    h, c = model.prefill(params, torch.from_numpy(toks),
                         model.init_cache(2, 9, torch.float32, device="cpu"))
    np.testing.assert_allclose(_np(h), _np(rh), rtol=HIDDEN_TOL, atol=HIDDEN_TOL)
    assert torch.all(c[0]["attn_k"][:, :, 7:] == 0)


def test_quant_cache_is_the_transformers_only():
    """The reference's ``init_cache(quant=True)`` quietly builds an
    unquantized cache for the other stacks; the port refuses."""
    with pytest.raises(ValueError, match="int8"):
        Model(get_smoke_config("seamless-m4t-large-v2")).init_cache(
            1, 4, dtype=torch.float32, device="cpu", quant=True)
    with pytest.raises(ValueError, match="int8"):
        Model(get_smoke_config("rwkv6-3b")).init_cache(1, 4, dtype=torch.float32,
                                                       device="cpu", quant=True)
    cache = Model(get_smoke_config("llama4-scout-17b-a16e")).init_cache(1, 4, dtype=torch.float32, device="cpu", quant=True)
    assert cache[0]["attn_k"].dtype == torch.int8
