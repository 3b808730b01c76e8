"""The port's SSM and hybrid stacks (rwkv6-3b, zamba2-2.7b) against the JAX
package's on the reference's own parameters (carried over by
``params_from_numpy``), smoke configs in float32: the parameter tree,
prefill hidden states and every state leaf, per-exit decode and greedy
token streams.  Both ``impl`` values run: ``"kernel"`` reaches the scan
kernel's plain version (and the attention kernels' plain versions) on the
CPU, ``"dense"`` the reference's dense paths.  zamba2-2.7b also runs at its
real head dim 80 (``"zamba2-2.7b-hd80"``: the smoke config with
``head_dim=80`` in both packages, where the smoke configs use 16), and its
prefill also against the reference through its Pallas flash kernel, in
interpret mode."""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_get_smoke
from repro.models import Model as RefModel
from repro.models import mamba2 as ref_m2
from repro.models import rwkv6 as ref_r6
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import launch_counts
from repro_torch.models import Model
from repro_torch.models import mamba2, rwkv6
from repro_torch.models.convert import params_from_numpy

#: smoke configs; "-hd80" sets head_dim=80 in both packages
ARCHS = ("rwkv6-3b", "zamba2-2.7b", "zamba2-2.7b-hd80")
HYBRIDS = ("zamba2-2.7b", "zamba2-2.7b-hd80")
TOL = 2e-4           # the reference's chunked-against-sequential scan tolerance
STEPS = 6
log = logging.getLogger(__name__)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch, _, hd = request.param.partition("-hd")
    rcfg, cfg = ref_get_smoke(arch), get_smoke_config(arch)
    if hd:
        rcfg = dataclasses.replace(rcfg, head_dim=int(hd))
        cfg = dataclasses.replace(cfg, head_dim=int(hd))
    rmodel, model = RefModel(rcfg), Model(cfg)
    rparams = rmodel.init_params(jax.random.key(0), dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    params = params_from_numpy(cfg, tree, device="cpu")
    return rmodel, rparams, tree, model, params


def _np(x):
    return np.asarray(x.detach().float()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _tokens(B=2, S=6, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(np.int32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _clone(cache):
    return jax.tree_util.tree_map(lambda t: t.clone(), cache)


def _close_caches(cache, rcache, tol=TOL):
    rleaves, rdef = jax.tree_util.tree_flatten(rcache)
    leaves, pdef = jax.tree_util.tree_flatten(cache)
    assert rdef == pdef
    for a, b in zip(leaves, rleaves):
        assert tuple(a.shape) == b.shape
        _close(a, b, tol)


def _prefill_both(rmodel, rparams, model, params, toks, T, impl="kernel",
                  attn_impl="auto"):
    B = toks.shape[0]
    rh, rcache = rmodel.prefill(rparams, jnp.asarray(toks),
                                rmodel.init_cache(B, T, dtype=jnp.float32),
                                attn_impl=attn_impl)
    h, cache = model.prefill(params, torch.from_numpy(toks),
                             model.init_cache(B, T, dtype=torch.float32, device="cpu"),
                             impl=impl)
    return rh, rcache, h, cache


def test_segments_match_reference(pair):
    rmodel, _, _, model, _ = pair
    assert model.segment_lengths() == rmodel.stack.segment_lengths(rmodel.cfg)


def test_params_round_trip(pair):
    """Same tree, same values; the decay, bonus and Mamba-2 scalars stay
    float32 when the rest is bfloat16."""
    _, _, tree, model, params = pair
    rleaves, rdef = jax.tree_util.tree_flatten(tree)
    pleaves, pdef = jax.tree_util.tree_flatten(params)
    assert rdef == pdef
    for r, p in zip(rleaves, pleaves):
        assert p.shape == r.shape and p.dtype == torch.float32
        assert np.array_equal(p.numpy(), r)
    bf = params_from_numpy(model.cfg, tree, dtype=torch.bfloat16, device="cpu")
    f32 = {"w0", "u", "A_log", "D", "dt_bias"}
    for seg in bf["segments"]:
        for key, leaf in seg.items():
            assert leaf.dtype == (torch.float32 if key in f32 else torch.bfloat16), key
    # the port's own init draws the same tree
    own = model.init_params(torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                            device="cpu")
    assert jax.tree_util.tree_structure(own) == jax.tree_util.tree_structure(bf)
    for a, b in zip(jax.tree_util.tree_leaves(own), jax.tree_util.tree_leaves(bf)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_convert_rejects_wrong_depth(pair):
    _, _, tree, model, _ = pair
    with pytest.raises(ValueError):
        params_from_numpy(model.cfg, dict(tree, segments=tree["segments"][:1]), device="cpu")
    seg0 = jax.tree_util.tree_map(lambda a: a[:-1], tree["segments"][0])
    with pytest.raises(ValueError):
        params_from_numpy(model.cfg, dict(tree, segments=(seg0,) + tree["segments"][1:]),
                          device="cpu")


def test_init_state_shapes_match_reference(pair):
    rmodel, _, _, model, _ = pair
    rmod, mod = (ref_r6, rwkv6) if model.cfg.family == "ssm" else (ref_m2, mamba2)
    ref_state = rmod.init_state(rmodel.cfg, 3)
    state = mod.init_state(model.cfg, 3, device="cpu")
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: v.shape for k, v in ref_state.items()}
    assert all(v.dtype == torch.float32 and not v.any() for v in state.values())


@pytest.mark.parametrize("impl", ["kernel", "dense"])
@pytest.mark.parametrize("S", [6, 16])
def test_prefill_matches(pair, impl, S):
    """S 6 runs the reference's sequential scan, S 16 its chunked one; the
    port's kernel path steps the recurrence at both."""
    rmodel, rparams, _, model, params = pair
    toks = _tokens(S=S)
    before = launch_counts()
    rh, rcache, h, cache = _prefill_both(rmodel, rparams, model, params, toks, S + 4, impl)
    assert launch_counts() == before            # the CPU path launches nothing
    _close(h, rh)
    _close_caches(cache, rcache)


@pytest.mark.parametrize("pair", HYBRIDS, indirect=True)
def test_prefill_matches_the_pallas_reference(pair):
    """The reference's shared attention through its Pallas flash kernel
    (interpret mode, as the JAX package's own kernel tests run it)."""
    rmodel, rparams, _, model, params = pair
    toks = _tokens(S=16)
    rh, rcache, h, cache = _prefill_both(rmodel, rparams, model, params, toks, 20,
                                         attn_impl="pallas")
    _close(h, rh)
    _close_caches(cache, rcache)


def test_forward_matches(pair):
    rmodel, rparams, _, model, params = pair
    toks = _tokens(S=9, seed=2)
    routs, _ = rmodel.stack.forward(rmodel.cfg, rparams, jnp.asarray(toks))
    outs = model.forward(params, torch.from_numpy(toks))
    assert [i for i, _ in routs] == [i for i, _ in outs]
    for (_, a), (_, b) in zip(routs, outs):
        _close(b, a)


@pytest.mark.parametrize("impl", ["kernel", "dense"])
@pytest.mark.parametrize("exit_point", [0, None])
def test_decode_step_per_exit_matches(pair, impl, exit_point):
    """One decode step right-sized to ``exit_point``: the hidden state and
    every state leaf, including the stale ones of the segments past the
    exit, which are not run."""
    rmodel, rparams, _, model, params = pair
    toks = _tokens(seed=1)
    S = toks.shape[1]
    _, rcache, _, cache = _prefill_both(rmodel, rparams, model, params, toks, S + 4)
    nxt = np.asarray([[5], [17]], np.int32)
    rh, rc2, rconf = rmodel.decode_step(rparams, rcache, jnp.asarray(nxt),
                                        jnp.asarray(S, jnp.int32), exit_point=exit_point,
                                        with_exit_confidence=True)
    h, c2, conf = model.decode_step(params, _clone(cache), torch.from_numpy(nxt), S,
                                    exit_point=exit_point, with_exit_confidence=True,
                                    impl=impl)
    assert conf == [] and list(rconf) == []
    _close(h, rh)
    _close_caches(c2, rc2)
    if exit_point is not None:
        for si in range(exit_point + 1, model.num_segments):
            for key, leaf in c2["segments"][si].items():
                assert torch.equal(leaf, cache["segments"][si][key]), (si, key)
    # a [B] position tensor is the same step as the scalar
    hv, cv, _ = model.decode_step(params, _clone(cache), torch.from_numpy(nxt),
                                  torch.tensor([S, S]), exit_point=exit_point, impl=impl)
    _close(hv, h, 1e-6)
    _close_caches(cv, c2, 1e-6)


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
    rh, rcache, h, cache = _prefill_both(rmodel, rparams, model, params, toks,
                                         S + STEPS + 1)
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
        _close(h, rh)
