"""The MoE, VLM and enc-dec families of the port against the JAX package,
on the reference's own parameters (``params_from_numpy``), at smoke size in
float32: llama4-scout (a MoE unit every layer), llama4-maverick (the pair
unit attn0, ffn, attn1, moe), llava (8 prefix embeddings in front of the
text), seamless (2 encoder layers, cross-attention in the decoder) and a
narrow scout with 40/8 heads, whose query heads pad to 48 (the smoke
configs' 4 heads never pad).

Each family: prefill hidden states and caches, per-exit decode (with the
exit heads' confidences), greedy token streams, ``Model.forward`` at every
exit, and ``Model.loss`` with its grads.  ``impl="kernel"`` reaches the
kernels' plain versions on the CPU, ``"dense"`` the reference's dense
path.  Hidden states are held at 1e-4 (``HIDDEN_TOL``), losses at 1e-5 and
grads at 1e-4 of each leaf's largest value, as ``test_torch_train.py``."""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke
from repro.models import Model as RefModel
from repro_torch import tree as T
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.exit_head import ops as eh_ops
from repro_torch.models import Model
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy

HIDDEN_TOL = 1e-4
LOSS_TOL = 1e-5
STEPS = 6
ENC_LEN = 10          # seamless: encoder frames
log = logging.getLogger(__name__)

CASES = {
    "scout": ("llama4-scout-17b-a16e", {}),
    "maverick": ("llama4-maverick-400b-a17b", {}),
    "llava": ("llava-next-mistral-7b", {}),
    "seamless": ("seamless-m4t-large-v2", {}),
    "scout-40h": ("llama4-scout-17b-a16e", dict(num_heads=40, num_kv_heads=8)),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files side by side on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Fam:
    def __init__(self, name):
        arch, change = CASES[name]
        rcfg, cfg = ref_get_smoke(arch), get_smoke_config(arch)
        if change:
            rcfg = dataclasses.replace(rcfg, **change)
            cfg = dataclasses.replace(cfg, **change)
        self.rmodel, self.model, self.cfg = RefModel(rcfg), Model(cfg), cfg
        self.rparams = self.rmodel.init_params(jax.random.key(0), dtype=jnp.float32)
        self.tree = jax.tree_util.tree_map(np.asarray, self.rparams)
        self.params = params_from_numpy(cfg, self.tree, device="cpu")
        self.P = cfg.num_prefix_tokens if cfg.frontend == "vision" else 0

    def extras(self, B, seed=9):
        """The family's non-token inputs, numpy, by the name Model takes."""
        rng = np.random.default_rng(seed)
        if self.cfg.is_encdec:
            return {"frames": rng.standard_normal((B, ENC_LEN, 1024)).astype(np.float32)}
        if self.P:
            return {"prefix_emb": rng.standard_normal((B, self.P, 1024)).astype(np.float32)}
        return {}

    def caches(self, B, T):
        kw = {"enc_len": ENC_LEN} if self.cfg.is_encdec else {}
        return (self.rmodel.init_cache(B, T, dtype=jnp.float32, **kw),
                self.model.init_cache(B, T, dtype=torch.float32, device="cpu", **kw))

    def prefill(self, toks, impl="kernel"):
        """Both sides' prefill of ``toks`` with room for STEPS more tokens:
        (ref h, ref cache, h, cache, next position)."""
        B, S = toks.shape
        T_ = self.P + S + STEPS + 1
        rc, c = self.caches(B, T_)
        ex = self.extras(B)
        rh, rc = self.rmodel.prefill(self.rparams, jnp.asarray(toks), rc,
                                     **{k: jnp.asarray(v) for k, v in ex.items()})
        h, c = self.model.prefill(self.params, torch.from_numpy(toks), c, impl=impl,
                                  **{k: torch.from_numpy(v) for k, v in ex.items()})
        return rh, rc, h, c, self.P + S


@pytest.fixture(scope="module", params=sorted(CASES))
def fam(request):
    return Fam(request.param)


def _np(x):
    return np.asarray(x.detach().float()) if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x, jnp.float32))


def _close(a, b, tol=HIDDEN_TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _tokens(B, S, seed):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(np.int32)


def _caches_close(rcache, cache):
    rl, pl = T.leaves_with_paths(rcache), T.leaves_with_paths(cache)
    assert [k for k, _ in rl] == [k for k, _ in pl]
    for (key, r), (_, p) in zip(rl, pl):
        assert tuple(p.shape) == r.shape, key
        _close(p, r)


def _clone(cache):
    return T.tree_map(lambda t: t.clone(), cache)


def test_params_convert_with_the_reference_structure(fam):
    rleaves = T.leaves_with_paths(fam.tree)
    pleaves = T.leaves_with_paths(fam.params)
    assert [k for k, _ in rleaves] == [k for k, _ in pleaves]
    for (key, r), (_, p) in zip(rleaves, pleaves):
        assert p.shape == r.shape and p.dtype == torch.float32, key
        assert np.array_equal(p.numpy(), r), key
    assert fam.model.segment_lengths() == fam.rmodel.stack.segment_lengths(fam.rmodel.cfg)


@pytest.mark.parametrize("impl", ["kernel", "dense"])
def test_prefill_matches(fam, impl):
    rh, rc, h, c, _ = fam.prefill(_tokens(2, 6, 0), impl)
    _close(h, rh)
    _caches_close(rc, c)


@pytest.mark.parametrize("impl", ["kernel", "dense"])
def test_decode_step_per_exit_matches(fam, impl):
    _, rc, _, c, pos = fam.prefill(_tokens(2, 5, 1), impl)
    nxt = np.asarray([[5], [17]], np.int32)
    for exit_point in list(range(fam.model.num_segments - 1)) + [None]:
        rh, rc2, rconf = fam.rmodel.decode_step(
            fam.rparams, rc, jnp.asarray(nxt), jnp.asarray(pos, jnp.int32),
            exit_point=exit_point, with_exit_confidence=True)
        h, c2, conf = fam.model.decode_step(fam.params, _clone(c), torch.from_numpy(nxt),
                                            pos, exit_point=exit_point,
                                            with_exit_confidence=True, impl=impl)
        _close(h, rh)
        _caches_close(rc2, c2)
        assert len(conf) == len(rconf)
        for a, b in zip(conf, rconf):
            assert np.array_equal(_np(a["token"]), np.asarray(b["token"]))
            _close(a["conf"], b["conf"], 1e-5)
            _close(a["entropy"], b["entropy"], 1e-5)


def _margin(logits_row):
    top2 = np.sort(logits_row)[-2:]
    return float(top2[1] - top2[0])


@pytest.mark.parametrize("exit_point", [None, 0])
def test_greedy_streams_match(fam, exit_point):
    """Greedy decoding for STEPS tokens, each side feeding back its own
    tokens; a token may differ only where the reference's top-2 logit
    margin is below HIDDEN_TOL (a rounding tie), logged, and the streams
    are compared no further."""
    rh, rc, h, c, pos = fam.prefill(_tokens(3, 5, 3))
    for step in range(STEPS):
        rlogits = np.asarray(fam.rmodel.logits(fam.rparams, rh))[:, -1]
        rtok = rlogits.argmax(-1).astype(np.int32)
        tok = eh_ops.exit_confidence(h, fam.params["embed"])["token"][:, -1].numpy()
        if not np.array_equal(rtok, tok):
            for i in np.nonzero(rtok != tok)[0]:
                m = _margin(rlogits[i])
                log.warning("token flip at step %d row %d: ref %d port %d, "
                            "ref top-2 margin %.3g", step, i, rtok[i], tok[i], m)
                assert m < HIDDEN_TOL, (step, i, m)
            return
        rh, rc, _ = fam.rmodel.decode_step(fam.rparams, rc, jnp.asarray(rtok[:, None]),
                                           jnp.asarray(pos + step, jnp.int32),
                                           exit_point=exit_point)
        h, c, _ = fam.model.decode_step(fam.params, c, torch.from_numpy(tok[:, None]),
                                        pos + step, exit_point=exit_point)
        _close(h, rh)


def test_forward_matches(fam):
    toks = _tokens(2, 9, 2)
    ex = fam.extras(2)
    stack = fam.rmodel.stack
    if fam.cfg.is_encdec:
        routs, _ = stack.forward(fam.rmodel.cfg, fam.rparams, jnp.asarray(toks),
                                 jnp.asarray(ex["frames"]))
    else:
        routs, raux = stack.forward(fam.rmodel.cfg, fam.rparams, jnp.asarray(toks),
                                    prefix_emb=(jnp.asarray(ex["prefix_emb"])
                                                if fam.P else None))
    outs = fam.model.forward(fam.params, torch.from_numpy(toks),
                             **{k: torch.from_numpy(v) for k, v in ex.items()})
    assert [i for i, _ in routs] == [i for i, _ in outs]
    for (_, a), (_, b) in zip(routs, outs):
        assert tuple(b.shape) == a.shape
        _close(b, a)


def test_loss_and_grads_match(fam):
    """``Model.loss`` with remat and flash blocks of 16 (32 positions: the
    VLM's 8 prefix rows and 24 text tokens, the enc-dec's 32 decoder
    tokens over 16 frames), and its grads, per leaf within 1e-4 of the
    leaf's largest value + 1e-6.  The MoE adds 0.01 of its aux loss."""
    B, S = 2, 32 - fam.P
    toks = _tokens(B, S + 1, 4)
    rng = np.random.default_rng(5)
    batch = {"tokens": toks}
    if fam.cfg.is_encdec:
        batch["frames"] = rng.standard_normal((B, 16, 1024)).astype(np.float32)
    if fam.P:
        batch["prefix_emb"] = rng.standard_normal((B, fam.P, 1024)).astype(np.float32)
    fn = jax.jit(jax.value_and_grad(lambda p: fam.rmodel.loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, remat=True,
        attn_impl="flash@16"), has_aux=True))
    (want, rmetrics), rgrads = fn(fam.rparams)
    params = T.tree_map(lambda p: p.detach().clone().requires_grad_(), fam.params)
    loss, metrics = fam.model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                   remat=True, attn_impl="flash@16")
    loss.backward()
    assert abs(float(loss.detach()) - float(want)) <= LOSS_TOL
    aux = torch.as_tensor(metrics["aux"]).detach()
    assert abs(float(aux) - float(rmetrics["aux"])) <= LOSS_TOL
    np.testing.assert_allclose(metrics["exit_ce"].detach().numpy(),
                               np.asarray(rmetrics["exit_ce"]), rtol=0, atol=LOSS_TOL)
    want_grads = dict(T.leaves_with_paths(jax.tree_util.tree_map(np.asarray, rgrads)))
    for key, p in T.leaves_with_paths(params):
        w = want_grads[key]
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        tol = 1e-4 * float(np.abs(w).max()) + 1e-6
        err = float(np.abs(g - w).max())
        assert err <= tol, f"{fam.cfg.name} {key}: max |diff| {err:.3e} > {tol:.3e}"


def _pad_heads(cfg):
    h, kv = cfg.padded_heads, cfg.num_kv_heads
    return (np.arange(h) % (h // kv)) >= cfg.num_heads // kv


@pytest.mark.parametrize("impl", ["kernel", "dense"])
def test_padded_heads_output_exactly_zero(impl):
    """The narrow scout's 8 padding query heads (48 = 8 groups of 6, 5
    live) come out exactly 0 from attention, at prefill and at decode, so
    ``wo`` sees zeros there; their ``wq`` columns get exactly zero grads."""
    fam = Fam("scout-40h")
    cfg = fam.cfg
    assert (cfg.num_heads, cfg.padded_heads, cfg.num_kv_heads) == (40, 48, 8)
    pad = _pad_heads(cfg)
    assert pad.sum() == 8
    hd, h = cfg.hd, cfg.padded_heads
    p = {k: v[0] for k, v in fam.params["segments"][0]["attn"].items()}
    p["wo"] = torch.eye(h * hd)            # attention's output before wo
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32))
    pos = torch.arange(7)[None].expand(2, 7)
    out, _ = L.attention(p, cfg, x, pos, impl=impl)
    out = out.reshape(2, 7, h, hd)
    assert torch.all(out[:, :, pad] == 0) and torch.any(out[:, :, ~pad] != 0)
    ck = torch.zeros((2, 9, cfg.num_kv_heads, hd))
    cv = torch.zeros_like(ck)
    L.attention(p, cfg, x[:, :6], pos[:, :6], kv_cache=(ck, cv), cache_pos=0,
                prefill_mode=True, impl=impl)
    out, _ = L.attention(p, cfg, x[:, 6:], pos[:, 6:], kv_cache=(ck, cv), cache_pos=6,
                         impl=impl)
    out = out.reshape(2, 1, h, hd)
    assert torch.all(out[:, :, pad] == 0) and torch.any(out[:, :, ~pad] != 0)

    params = T.tree_map(lambda t: t.detach().clone().requires_grad_(), fam.params)
    toks = torch.from_numpy(_tokens(2, 9, 7))
    loss, _ = fam.model.loss(params, {"tokens": toks}, remat=False, attn_impl="dense")
    loss.backward()
    for seg in params["segments"]:
        g = seg["attn"]["wq"].grad.reshape(-1, cfg.d_model, h, hd)
        assert torch.all(g[:, :, pad] == 0) and torch.any(g[:, :, ~pad] != 0)
