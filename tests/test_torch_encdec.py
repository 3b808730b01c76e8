"""The port's encoder-decoder (seamless-m4t-large-v2, ``models/encdec.py``)
and its cross-attention against the JAX package, at smoke size on the CPU.

The whole model (prefill, per-exit decode, greedy streams, forward, loss and
grads) is held in ``test_torch_families.py``.  Here: the encoder alone;
cross-attention (q not roped, nothing masked, K/V from the encoder memory)
through the port's plain attention against the reference's Pallas kernels
in interpret mode, non-causal with S != T, as ``test_torch_hd80.py`` holds
hd 80; the attention layer with ``cross_kv`` against the reference's at
prefill (S > 1, the flash route) and at decode (S = 1, the decode route
over all T keys); a cache built for another memory length; and the serving
launcher's refusal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke
from repro.kernels.flash_attention import ops as ref_fa_ops
from repro.kernels.flash_attention import ref as ref_fa
from repro.models import Model as RefModel
from repro.models import encdec as ref_encdec
from repro.models import layers as RL
from repro_torch import tree as T
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models import encdec
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy

ARCH = "seamless-m4t-large-v2"
HIDDEN_TOL = 1e-4
ATTN_TOL = 2e-5       # the attention kernels' tolerance of tests/test_kernels.py


@pytest.fixture(scope="module")
def pair():
    rcfg, cfg = ref_get_smoke(ARCH), get_smoke_config(ARCH)
    rmodel, model = RefModel(rcfg), Model(cfg)
    rparams = rmodel.init_params(jax.random.key(0), dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    return rmodel, rparams, model, params_from_numpy(cfg, tree, device="cpu")


def _np(x):
    return np.asarray(x.detach().float()) if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _close(a, b, tol=HIDDEN_TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _frames(B, n, seed=0):
    return np.random.default_rng(seed).standard_normal((B, n, 1024)).astype(np.float32)


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _heads_first(a):
    return jnp.asarray(a).transpose(0, 2, 1, 3)


def test_params_and_segments(pair):
    rmodel, _, model, params = pair
    cfg = model.cfg
    assert model.segment_lengths() == ref_encdec.segment_lengths(rmodel.cfg)
    assert params["encoder"]["attn"]["wq"].shape[0] == cfg.num_encoder_layers == 2
    assert set(params["segments"][0]) == {"attn", "xattn", "ffn"}
    assert params["audio_proj"].shape == (encdec.AUDIO_DIM, cfg.d_model)


def test_convert_rejects_a_wrong_encoder_depth(pair):
    rmodel, rparams, model, _ = pair
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    bad = dict(tree, encoder=jax.tree_util.tree_map(lambda a: a[:1], tree["encoder"]))
    with pytest.raises(ValueError, match="encoder"):
        params_from_numpy(model.cfg, bad, device="cpu")


@pytest.mark.parametrize("impl", ["kernel", "dense"])
def test_encode_matches(pair, impl):
    rmodel, rparams, model, params = pair
    fr = _frames(2, 11)
    want = ref_encdec.encode(rmodel.cfg, rparams, jnp.asarray(fr))
    _close(encdec.encode(model.cfg, params, torch.from_numpy(fr), impl=impl), want)


@pytest.mark.parametrize("B,H,KV,S,T,hd", [
    (2, 4, 4, 12, 40, 64),      # the seamless layout: G = 1, S 12 over T 40
    (1, 16, 16, 12, 100, 64),   # its 16/16 heads of 64
    (2, 8, 2, 24, 48, 128),     # G = 4 at hd 128
])
def test_noncausal_cross_attention_matches_pallas(B, H, KV, S, T, hd):
    """Non-causal S != T (the cross-attention of a prefill) through the
    port's wrapper, which runs its plain version on the CPU, against the
    jnp oracle and the Pallas kernel in interpret mode."""
    q, k, v = _rand(S + T + H, (B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd))
    before = launch_counts()
    got = _np(fa_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=False))
    assert launch_counts() == before
    want = _np(ref_fa.attention(_heads_first(q), _heads_first(k), _heads_first(v),
                                causal=False).transpose(0, 2, 1, 3))
    np.testing.assert_allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL)
    pallas = _np(ref_fa_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), causal=False,
                                            block_q=S, block_k=T // 2))
    np.testing.assert_allclose(got, pallas, rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("T", [40, 100])
def test_decode_over_the_whole_memory_matches_pallas(T):
    """A decode step's cross-attention: one query over all T keys
    (``lengths`` = T, fixed), against the Pallas decode kernel."""
    B, H, KV, hd = 2, 16, 16, 64
    q, k, v = _rand(T, (B, 1, H, hd), (B, T, KV, hd), (B, T, KV, hd))
    lengths = np.full((B,), T, np.int32)
    before = launch_counts()
    got = _np(fa_ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), torch.from_numpy(lengths)))
    assert launch_counts() == before
    pallas = _np(ref_fa_ops.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             jnp.asarray(lengths), block_k=T // 2))
    np.testing.assert_allclose(got, pallas, rtol=ATTN_TOL, atol=ATTN_TOL)
    full = _np(fa_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), causal=False))
    np.testing.assert_allclose(got, full, rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("impl", ["kernel", "dense"])
@pytest.mark.parametrize("S", [1, 12])
def test_cross_attention_layer_matches_reference(pair, impl, S):
    """``attention(cross_kv=)`` against the reference's: q unroped at any
    position, no mask; S = 1 takes the decode route, S = 12 the flash
    route (both their plain versions on the CPU)."""
    rmodel, rparams, model, params = pair
    cfg = model.cfg
    p = {k: v[0] for k, v in params["segments"][0]["xattn"].items()}
    rp = {k: v[0] for k, v in rparams["segments"][0]["xattn"].items()}
    x, k, v = _rand(S, (2, S, cfg.d_model), (2, 10, cfg.num_kv_heads, cfg.hd),
                    (2, 10, cfg.num_kv_heads, cfg.hd))
    pos = np.broadcast_to(np.arange(5, 5 + S), (2, S)).copy()
    want, _ = RL.attention(rp, rmodel.cfg, jnp.asarray(x), jnp.asarray(pos),
                           cross_kv=(jnp.asarray(k), jnp.asarray(v)))
    got, cache = L.attention(p, cfg, torch.from_numpy(x), torch.from_numpy(pos),
                             cross_kv=(torch.from_numpy(k), torch.from_numpy(v)), impl=impl)
    assert cache is None
    _close(got, want)


@pytest.mark.parametrize("enc_len", [7, 13])
def test_cache_built_for_another_memory_length(pair, enc_len):
    """A cache built with ``enc_len`` != the frames' length (10): the
    prefill's cross caches take the memory's length, as the reference's
    prefill replaces them, with no row of the old cross cache left; the
    decode that follows matches."""
    rmodel, rparams, model, params = pair
    B, S, n = 2, 5, 10
    toks = np.random.default_rng(1).integers(0, 256, (B, S)).astype(np.int32)
    fr = _frames(B, n, seed=2)
    rc = rmodel.init_cache(B, S + 3, dtype=jnp.float32, enc_len=enc_len)
    c = model.init_cache(B, S + 3, dtype=torch.float32, device="cpu", enc_len=enc_len)
    for t in c["cross_k"] + c["cross_v"]:
        t.fill_(7.0)                        # stale rows would show
    rh, rc = rmodel.prefill(rparams, jnp.asarray(toks), rc, frames=jnp.asarray(fr))
    h, c = model.prefill(params, torch.from_numpy(toks), c, frames=torch.from_numpy(fr))
    _close(h, rh)
    for key in ("cross_k", "cross_v"):
        for r, t in zip(rc[key], c[key]):
            assert tuple(t.shape) == r.shape and t.shape[2] == n
            assert not torch.any(t == 7.0)
            _close(t, r)
    nxt = np.asarray([[3], [4]], np.int32)
    rh, rc, _ = rmodel.decode_step(rparams, rc, jnp.asarray(nxt), jnp.asarray(S, jnp.int32))
    h, c, confs = model.decode_step(params, c, torch.from_numpy(nxt), S,
                                    with_exit_confidence=True)
    assert confs == []
    _close(h, rh)
    for r, t in zip(T.leaves(rc["self"]), T.leaves(c["self"])):
        _close(t, r)


def test_serve_refuses_the_encoder_decoder():
    """The serving engine feeds no frames (nor does the reference's): the
    launcher refuses seamless before it makes any weight."""
    with pytest.raises(SystemExit, match="encoder-decoder"):
        serve.main(["--arch", ARCH, "--device", "cpu"])
    assert "encoder-decoder" in serve.refusal(get_config(ARCH), True, 80 * 10**9)
