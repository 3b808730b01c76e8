"""The port's dense early-exit transformer against the JAX package's on the
reference's own parameters (carried over by ``params_from_numpy``), smoke
llama3.2-1b in float32: prefill hidden states and caches, per-exit decode,
and greedy token streams.  Both ``impl`` values run: ``"kernel"`` reaches the
kernels' plain versions on the CPU, ``"dense"`` the reference's dense path."""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke
from repro.models import Model as RefModel
from repro_torch.configs import get_smoke_config
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy

ARCH = "llama3.2-1b"
TOL = 2e-5
STEPS = 8
log = logging.getLogger(__name__)


@pytest.fixture(scope="module")
def pair():
    rcfg, cfg = ref_get_smoke(ARCH), get_smoke_config(ARCH)
    rmodel, model = RefModel(rcfg), Model(cfg)
    rparams = rmodel.init_params(jax.random.key(0), dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    params = params_from_numpy(cfg, tree, device="cpu")
    return rmodel, rparams, tree, model, params


def _np(x):
    return np.asarray(x.detach().float()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _tokens(B=2, S=6, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(np.int32)


def _clone(cache):
    return tuple({k: v.clone() for k, v in seg.items()} for seg in cache)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def test_segments_match_reference(pair):
    rmodel, _, _, model, _ = pair
    assert model.segment_lengths() == rmodel.stack.segment_lengths(rmodel.cfg) == [1, 2, 1]


def test_params_round_trip(pair):
    _, _, tree, _, params = pair
    rleaves, rdef = jax.tree_util.tree_flatten(tree)
    pleaves, pdef = jax.tree_util.tree_flatten(params)
    assert rdef == pdef
    assert len(rleaves) == len(pleaves)
    for r, p in zip(rleaves, pleaves):
        assert p.shape == r.shape and p.dtype == torch.float32
        assert np.array_equal(p.numpy(), r)


def test_convert_rejects_wrong_depth(pair):
    _, _, tree, model, _ = pair
    bad = dict(tree, segments=tree["segments"][:2])
    with pytest.raises(ValueError):
        params_from_numpy(model.cfg, bad, device="cpu")


@pytest.mark.parametrize("impl", ["kernel", "dense"])
def test_prefill_matches(pair, impl):
    rmodel, rparams, _, model, params = pair
    toks = _tokens()
    T = toks.shape[1] + 5
    rh, rcache = rmodel.prefill(rparams, jnp.asarray(toks),
                                rmodel.init_cache(2, T, dtype=jnp.float32))
    h, cache = model.prefill(params, torch.from_numpy(toks),
                             model.init_cache(2, T, dtype=torch.float32, device="cpu"),
                             impl=impl)
    _close(h, rh)
    for rseg, seg in zip(rcache, cache):
        assert set(rseg) == set(seg)
        for key in seg:
            assert tuple(seg[key].shape) == rseg[key].shape
            _close(seg[key], rseg[key])


@pytest.mark.parametrize("impl", ["kernel", "dense"])
@pytest.mark.parametrize("exit_point", [0, 1, 2, None])
def test_decode_step_per_exit_matches(pair, impl, exit_point):
    rmodel, rparams, _, model, params = pair
    toks = _tokens(seed=1)
    S, T = toks.shape[1], toks.shape[1] + 4
    _, rcache = rmodel.prefill(rparams, jnp.asarray(toks),
                               rmodel.init_cache(2, T, dtype=jnp.float32))
    _, cache = model.prefill(params, torch.from_numpy(toks),
                             model.init_cache(2, T, dtype=torch.float32, device="cpu"))
    nxt = np.asarray([[5], [17]], np.int32)
    rh, rc2, rconf = rmodel.decode_step(rparams, rcache, jnp.asarray(nxt),
                                        jnp.asarray(S, jnp.int32), exit_point=exit_point,
                                        with_exit_confidence=True)
    h, c2, conf = model.decode_step(params, _clone(cache), torch.from_numpy(nxt), S,
                                    exit_point=exit_point, with_exit_confidence=True,
                                    impl=impl)
    _close(h, rh)
    for rseg, seg in zip(rc2, c2):
        for key in seg:
            _close(seg[key], rseg[key])
    assert len(conf) == len(rconf)
    for a, b in zip(conf, rconf):
        assert np.array_equal(_np(a["token"]), np.asarray(b["token"]))
        _close(a["conf"], b["conf"], 1e-5)
        _close(a["entropy"], b["entropy"], 1e-5)
    # a [B] position tensor is the same step as the scalar
    hv, cv, _ = model.decode_step(params, _clone(cache), torch.from_numpy(nxt),
                                  torch.tensor([S, S]), exit_point=exit_point, impl=impl)
    _close(hv, h, 1e-6)
    for seg, segv in zip(c2, cv):
        for key in seg:
            _close(segv[key], seg[key], 1e-6)


def test_forward_matches(pair):
    rmodel, rparams, _, model, params = pair
    toks = _tokens(S=9, seed=2)
    from repro.models import transformer as ref_tf
    routs, _ = ref_tf.forward(rmodel.cfg, rparams, jnp.asarray(toks))
    outs = model.forward(params, torch.from_numpy(toks))
    assert [i for i, _ in routs] == [i for i, _ in outs]
    for (_, a), (_, b) in zip(routs, outs):
        _close(b, a)


def _margin(logits_row):
    top2 = np.sort(logits_row)[-2:]
    return float(top2[1] - top2[0])


@pytest.mark.parametrize("exit_point", [None, 0])
def test_greedy_streams_match(pair, exit_point):
    """Greedy decoding for STEPS tokens, each side feeding back its own
    tokens.  A differing token is only allowed where the reference's top-2
    logit margin is below TOL (a rounding tie); it is logged, and the
    streams are compared no further since they then diverge by design."""
    rmodel, rparams, _, model, params = pair
    toks = _tokens(B=3, S=5, seed=3)
    B, S = toks.shape
    T = S + STEPS + 1
    rh, rcache = rmodel.prefill(rparams, jnp.asarray(toks),
                                rmodel.init_cache(B, T, dtype=jnp.float32))
    h, cache = model.prefill(params, torch.from_numpy(toks),
                             model.init_cache(B, T, dtype=torch.float32, device="cpu"))
    from repro_torch.kernels.exit_head import ops as eh_ops
    for step in range(STEPS):
        rlogits = np.asarray(rmodel.logits(rparams, rh))[:, -1]
        rtok = rlogits.argmax(-1).astype(np.int32)
        tok = eh_ops.exit_confidence(h, params["embed"])["token"][:, -1].numpy()
        if not np.array_equal(rtok, tok):
            for i in np.nonzero(rtok != tok)[0]:
                m = _margin(rlogits[i])
                log.warning("token flip at step %d row %d: ref %d port %d, "
                            "ref top-2 margin %.3g", step, i, rtok[i], tok[i], m)
                assert m < TOL, (step, i, m)
            return
        rh, rcache, _ = rmodel.decode_step(rparams, rcache, jnp.asarray(rtok[:, None]),
                                           jnp.asarray(S + step, jnp.int32),
                                           exit_point=exit_point)
        h, cache, _ = model.decode_step(params, cache, torch.from_numpy(tok[:, None]),
                                        S + step, exit_point=exit_point)
        _close(h, rh, 1e-4)


def test_cache_write_past_end_is_an_error(pair):
    _, _, _, model, params = pair
    cache = model.init_cache(1, 4, dtype=torch.float32, device="cpu")
    with pytest.raises(IndexError):
        model.decode_step(params, cache, torch.zeros((1, 1), dtype=torch.int32), 4)


def test_other_families_refuse():
    from repro_torch.configs import get_config
    for arch in ("rwkv6-3b", "llama4-scout-17b-a16e", "seamless-m4t-large-v2"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Model(get_config(arch))


def test_entry_points_default_to_cuda(pair):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda default is valid here")
    _, _, _, model, _ = pair
    with pytest.raises(RuntimeError, match="cuda"):
        model.init_params()
    with pytest.raises(RuntimeError, match="cuda"):
        model.init_cache(1, 4)
