"""The port's training path against the reference's on the CPU: the flash
attention with its flash backward, the chunked CE, the joint multi-exit
loss and its grads for the dense, ssm and hybrid families, the train step,
the training CLI, the prefetch loader, BranchyNet joint training of
BranchyAlexNet with the example's step, and the kernel wrappers' refusal
of autograd.

Stated tolerances (float32 throughout; the two sides sum in other orders):
* flash attention forward, lse and grads: rtol = atol = 2e-5, the
  reference's own flash test tolerance;
* CE, joint loss and per-exit CEs: 1e-5 absolute (the values are 2-7);
* grads of a loss: per leaf, |port - reference| <= 1e-4 max|reference| +
  1e-6 element by element;
* three train steps: the loss of each step within 1e-5, and each parameter
  within 2e-5 absolute (|params| <= 3, lr 1e-2: a step moves a parameter
  at most ~lr);
* BranchyAlexNet: the joint loss within 1e-5, grads as above; the
  example's step (AdamW, lr 1e-3) three times, each from the reference's
  state before it: the loss within 1e-5, and every parameter and moment
  within 2 lr of the reference's, all but one in 1000 within 1e-5.  Adam
  divides each gradient by its running RMS, so an element whose gradient
  is near zero takes a step that rounding decides, in either direction:
  up to 2 lr.  (Run free, the two sides part further: after a step or
  two a ReLU or a max-pool window near a tie switches on one side only,
  and the grads of the layers below it differ by several percent.)
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ShapeConfig as RShapeConfig
from repro.configs import get_smoke_config as ref_get_smoke
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import Model as RefModel
from repro.models import alexnet as ref_alex
from repro.models import api as ref_api
from repro.models import layers as RL
from repro.optim import adamw as ref_adamw
from repro_torch import tree as T
from repro_torch.config import ShapeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import PrefetchLoader
from repro_torch.kernels.exit_head import ops as eh_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssm_scan import ops as ss_ops
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model
from repro_torch.models import alexnet
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.models.convert import alexnet_params_from_numpy, params_from_numpy
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update

ROOT = Path(__file__).resolve().parents[1]
ATTN_TOL = 2e-5
LOSS_TOL = 1e-5
ARCHS = ("llama3.2-1b", "rwkv6-3b", "zamba2-2.7b")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files side by side on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a, requires_grad=False):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(requires_grad)


def _grads_close(label, got, want):
    """Per leaf: |got - want| <= 1e-4 max|want| + 1e-6."""
    want = dict(T.leaves_with_paths(want))
    for key, g in T.leaves_with_paths(got):
        w = np.asarray(want[key])
        g = g.detach().numpy()
        assert g.shape == w.shape, (label, key)
        tol = 1e-4 * float(np.abs(w).max()) + 1e-6
        err = float(np.abs(g - w).max())
        assert err <= tol, f"{label} {key}: max |diff| {err:.3e} > {tol:.3e}"


# ------------------------------------------------------------------ flash attention
FLASH_CASES = {
    # tests/test_perf_features.py's shapes: causal GQA at block 32, non-causal at 16
    "causal_gqa": dict(B=2, S=128, H=4, KV=2, hd=32, causal=True, blk=32),
    "noncausal": dict(B=1, S=64, H=2, KV=2, hd=16, causal=False, blk=16),
}


@pytest.fixture(scope="module", params=sorted(FLASH_CASES))
def flash_case(request):
    c = FLASH_CASES[request.param]
    rng = np.random.default_rng(7)
    q = rng.normal(size=(c["B"], c["S"], c["H"], c["hd"])).astype(np.float32)
    k, v = (rng.normal(size=(c["B"], c["S"], c["KV"], c["hd"])).astype(np.float32)
            for _ in range(2))
    ct = rng.normal(size=q.shape).astype(np.float32)
    causal, blk = c["causal"], c["blk"]
    o, lse = RL._flash_fwd_blocks(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, q_block=blk, kv_block=blk)
    grads = jax.grad(lambda q, k, v: jnp.sum(
        RL.flash_attention_fused(q, k, v, causal, blk, blk) * ct),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return c, (q, k, v, ct), (np.asarray(o), np.asarray(lse), [np.asarray(g) for g in grads])


def test_flash_forward_and_lse_match_reference(flash_case):
    c, (q, k, v, _), (o_ref, lse_ref, _) = flash_case
    o, lse = L._flash_fwd_blocks(_t(q), _t(k), _t(v), causal=c["causal"],
                                 q_block=c["blk"], kv_block=c["blk"])
    np.testing.assert_allclose(o.numpy(), o_ref, rtol=ATTN_TOL, atol=ATTN_TOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref, rtol=ATTN_TOL, atol=ATTN_TOL)


@pytest.mark.parametrize("fn", ["fused", "novjp", "dense"])
def test_flash_grads_match_reference(flash_case, fn):
    """The flash backward (and the same blocks under plain autograd, and
    the dense attention) give the reference flash backward's grads."""
    c, (q, k, v, ct), (_, _, g_ref) = flash_case
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    if fn == "fused":
        out = L.flash_attention_fused(qt, kt, vt, c["causal"], c["blk"], c["blk"])
    elif fn == "novjp":
        out = L.flash_attention_jnp(qt, kt, vt, causal=c["causal"], q_block=c["blk"],
                                    kv_block=c["blk"])
    else:
        bias = L.causal_bias(c["S"], c["S"]) if c["causal"] else 0.0
        out = L._sdpa(qt, kt, vt, bias)
    torch.sum(out * _t(ct)).backward()
    for got, want in zip((qt.grad, kt.grad, vt.grad), g_ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=ATTN_TOL, atol=ATTN_TOL)


def test_flash_block_must_divide():
    q = torch.zeros(1, 48, 2, 16)
    with pytest.raises(ValueError, match="divide"):
        L.flash_attention_fused(q, q, q, True, 32, 32)


def test_attention_auto_picks_flash_past_1024_squared(monkeypatch):
    calls = []
    monkeypatch.setattr(L, "flash_attention_fused",
                        lambda *a: calls.append(a[3:]) or L._flash_fwd_blocks(
                            *a[:3], causal=a[3], q_block=a[4], kv_block=a[5])[0])
    cfg = get_smoke_config("llama3.2-1b")
    p = Model(cfg).init_params(dtype=torch.float32, device="cpu")["segments"][0]["attn"]
    p = {k: v[0] for k, v in p.items()}
    for S, impl, want in ((16, "auto", []), (16, "flash@8", [(True, 8, 8)]),
                          (1025, "auto", [(True, 1024, 1024)])):
        calls.clear()
        x = torch.zeros(1, S, cfg.d_model)
        if S > 1024:                              # 1025 does not divide: it must raise
            with pytest.raises(ValueError, match="divide"):
                L.attention(p, cfg, x, torch.arange(S)[None], impl=impl)
        else:
            L.attention(p, cfg, x, torch.arange(S)[None], impl=impl)
        assert calls == want, (S, impl)


# ------------------------------------------------------------------ CE
@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_reference(chunk, masked):
    rng = np.random.default_rng(1)
    h = rng.normal(size=(2, 64, 16)).astype(np.float32)
    emb = rng.normal(size=(40, 16)).astype(np.float32)
    lab = rng.integers(0, 40, (2, 64)).astype(np.int32)
    mask = (rng.random((2, 64)) < 0.7).astype(np.float32) if masked else None
    want, (gh, ge) = jax.value_and_grad(
        lambda h, e: ref_api.softmax_xent(h, e, jnp.asarray(lab),
                                          None if mask is None else jnp.asarray(mask),
                                          chunk=chunk), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(emb))
    ht, et = _t(h, True), _t(emb, True)
    got = api.softmax_xent(ht, et, _t(lab), None if mask is None else _t(mask), chunk=chunk)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= LOSS_TOL
    _grads_close("softmax_xent", {"h": ht.grad, "e": et.grad},
                 {"h": np.asarray(gh), "e": np.asarray(ge)})


# ------------------------------------------------------------------ Model.loss
def _tokens(vocab, B=2, S=33, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def loss_pair(request):
    """(config, port params (f32, from the reference's), tokens, reference
    loss, metrics and grads) at smoke size, the loss taken with remat and
    flash blocks of 16 (so the flash path runs at S 32)."""
    arch = request.param
    rcfg = ref_get_smoke(arch)
    rmodel = RefModel(rcfg)
    rparams = rmodel.init_params(jax.random.key(0), dtype=jnp.float32)
    toks = _tokens(rcfg.vocab_size)
    fn = jax.jit(jax.value_and_grad(lambda p: rmodel.loss(
        p, {"tokens": jnp.asarray(toks)}, remat=True, attn_impl="flash@16"), has_aux=True))
    (loss, metrics), grads = fn(rparams)
    cfg = get_smoke_config(arch)
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, rparams), device="cpu")
    return (cfg, params, toks, float(loss), np.asarray(metrics["exit_ce"]),
            jax.tree_util.tree_map(np.asarray, grads))


def _port_loss_grads(cfg, params, toks, **kw):
    params = T.tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    loss, metrics = Model(cfg).loss(params, {"tokens": _t(toks)}, **kw)
    loss.backward()
    return loss, metrics, T.tree_map(lambda p: p.grad, params)


def test_model_loss_and_grads_match_reference(loss_pair):
    cfg, params, toks, want, want_exit, want_grads = loss_pair
    loss, metrics, grads = _port_loss_grads(cfg, params, toks, remat=True,
                                            attn_impl="flash@16")
    assert abs(float(loss.detach()) - want) <= LOSS_TOL
    np.testing.assert_allclose(metrics["exit_ce"].detach().numpy(), want_exit,
                               rtol=0, atol=LOSS_TOL)
    assert len(want_exit) == len(Model(cfg).segment_lengths())
    _grads_close(cfg.name, grads, want_grads)


def test_remat_equals_no_remat(loss_pair):
    cfg, params, toks = loss_pair[:3]
    on = _port_loss_grads(cfg, params, toks, remat=True, attn_impl="flash@16")
    off = _port_loss_grads(cfg, params, toks, remat=False, attn_impl="flash@16")
    assert torch.equal(on[0], off[0])
    for a, b in zip(T.leaves(on[2]), T.leaves(off[2])):
        assert torch.equal(a, b)


def test_training_through_the_kernels_is_refused(loss_pair):
    cfg, params, toks = loss_pair[:3]
    with pytest.raises(RuntimeError, match="no backward"):
        _port_loss_grads(cfg, params, toks, attn_impl="kernel")


# ------------------------------------------------------------------ train step
TRAIN_KW = dict(peak_lr=1e-2, warmup=1, total_steps=10, remat=True)


def test_train_step_matches_reference():
    """Three steps of ``make_train_step`` against the reference's on its
    host mesh, from the same params and batches."""
    arch = "llama3.2-1b"
    rcfg = ref_get_smoke(arch)
    rmodel = RefModel(rcfg)
    rparams = rmodel.init_params(jax.random.key(0), dtype=jnp.float32)
    batches = [_tokens(rcfg.vocab_size, seed=s) for s in range(3)]
    mesh = make_host_mesh()
    rstep, _ = ref_make_train_step(rmodel, mesh, RShapeConfig("t", 32, 2, "train"),
                                   **TRAIN_KW)
    cfg = get_smoke_config(arch)
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, rparams), device="cpu")
    opt = adamw_init(params)
    step, _ = make_train_step(Model(cfg), None, ShapeConfig("t", 32, 2, "train"),
                              device="cpu", **TRAIN_KW)
    ropt = ref_adamw.adamw_init(rparams)
    with mesh:
        for b in batches:
            rparams, ropt, rmet = rstep(rparams, ropt, {"tokens": jnp.asarray(b)})
            params, opt, met = step(params, opt, {"tokens": _t(b)})
            assert abs(float(met["loss"]) - float(rmet["loss"])) <= LOSS_TOL
            assert abs(float(met["final_ce"]) - float(rmet["final_ce"])) <= LOSS_TOL
    assert int(opt.step) == int(ropt.step) == 3
    want = dict(T.leaves_with_paths(jax.tree_util.tree_map(np.asarray, rparams)))
    for key, p in T.leaves_with_paths(params):
        assert not p.requires_grad and p.grad is None
        np.testing.assert_allclose(p.numpy(), want[key], rtol=0, atol=2e-5, err_msg=key)


def test_train_cli_survives_injected_failure(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
         "--steps", "6", "--batch", "2", "--seq", "17", "--save-every", "2",
         "--inject-failure-at", "3", "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert res.returncode == 0, res.stderr
    assert "[restart] resumed at step 2" in res.stdout
    assert "done: 6 steps" in res.stdout and "restarts=1" in res.stdout
    assert sorted(os.listdir(tmp_path / "ck")) == [f"step_{s:09d}" for s in (2, 4, 6)]


def test_prefetch_loader_keeps_order():
    batches = [{"tokens": np.full((2, 3), i, np.int32), "i": np.int64(i)} for i in range(7)]
    loader = PrefetchLoader(iter(batches), device="cpu", depth=2)
    for i in range(7):
        b = next(loader)
        assert isinstance(b["tokens"], torch.Tensor) and b["tokens"].device.type == "cpu"
        assert int(b["tokens"][0, 0]) == i and int(b["i"]) == i
    loader.close()


# ------------------------------------------------------------------ BranchyAlexNet
def _no_dropout(net, replace):
    """``net`` with every dropout layer's rate set to 0 on its own spec
    instances (``drop_rate`` is a field of the spec, not of the config)."""
    def fix(specs):
        return [replace(s, drop_rate=0.0) if s.kind == "dropout" else s for s in specs]
    net.main = fix(net.main)
    net.sides = [(prefix, fix(side)) for prefix, side in net.sides]
    return net


@pytest.fixture(scope="module")
def alex():
    """Both nets with dropout at rate 0, the same parameters in each (the
    port's draw from seed 0, in the reference's HWIO layout for it), three
    cifar_like batches, and the reference's joint loss and grads and its
    states over three of the example's steps."""
    rnet = _no_dropout(ref_alex.BranchyAlexNet(ref_alex.BranchyAlexNetConfig()),
                       dataclasses.replace)
    net = _no_dropout(alexnet.BranchyAlexNet(alexnet.BranchyAlexNetConfig()),
                      dataclasses.replace)
    params = net.init(torch.Generator().manual_seed(0), device="cpu")
    ref_params = T.tree_map(lambda t: jnp.asarray(t.numpy()), _hwio(params))
    from repro.data.synthetic import cifar_like
    batches = [cifar_like(np.random.default_rng(s), 16, noise=1.4) for s in range(3)]
    vg = jax.jit(jax.value_and_grad(rnet.loss))
    loss, grads = vg(ref_params, tuple(jnp.asarray(a) for a in batches[0]), jax.random.key(1))
    upd = jax.jit(lambda g, opt, p: ref_adamw.adamw_update(g, opt, p, lr=1e-3,
                                                           weight_decay=1e-4))
    states = [(ref_params, ref_adamw.adamw_init(ref_params))]
    losses = []
    for i, (bx, by) in enumerate(batches):        # the example's step
        p, opt = states[-1]
        l, g = vg(p, (jnp.asarray(bx), jnp.asarray(by)), jax.random.key(i))
        states.append(upd(g, opt, p))
        losses.append(float(l))
    return dict(net=net, params=params,
                batches=batches, loss=float(loss), grads=jax.tree_util.tree_map(np.asarray, grads),
                step_losses=losses, states=jax.tree_util.tree_map(np.asarray, states))


def _hwio(tree):
    """The port's OIHW conv grads/params in the reference's HWIO layout."""
    return T.tree_map(lambda t: t.detach().permute(2, 3, 1, 0).contiguous() if t.ndim == 4
                      else t.detach(), tree)


def test_branchy_alexnet_joint_loss_and_grads_match_reference(alex):
    net = alex["net"]
    params = T.tree_map(lambda p: p.detach().clone().requires_grad_(), alex["params"])
    x, y = alex["batches"][0]
    loss = net.loss(params, (_t(x), _t(y)), torch.Generator().manual_seed(0))
    loss.backward()
    assert abs(float(loss.detach()) - alex["loss"]) <= LOSS_TOL
    _grads_close("alexnet", _hwio(T.tree_map(lambda p: p.grad, params)), alex["grads"])


def _held_adam_step(label, got, want, lr):
    """Every element within 2 lr, all but one in 1000 within 1e-5."""
    want = dict(T.leaves_with_paths(want))
    n = far = 0
    for key, t in T.leaves_with_paths(got):
        err = np.abs(t.numpy() - np.asarray(want[key], np.float32))
        assert float(err.max()) <= 2 * lr, (label, key, float(err.max()))
        n, far = n + err.size, far + int((err > 1e-5).sum())
    assert far <= n // 1000, f"{label}: {far} of {n} elements beyond 1e-5"


def test_branchy_alexnet_example_step_matches_reference(alex):
    """The example's step (joint loss, AdamW lr 1e-3, weight decay 1e-4),
    three times, each from the reference's state before it."""
    net, gen = alex["net"], torch.Generator().manual_seed(0)
    for i, (x, y) in enumerate(alex["batches"]):
        rp, ropt = alex["states"][i]
        params = alexnet_params_from_numpy(rp, device="cpu")
        opt = AdamWState(torch.tensor(int(ropt.step), dtype=torch.int32),
                         alexnet_params_from_numpy(ropt.mu, device="cpu"),
                         alexnet_params_from_numpy(ropt.nu, device="cpu"))
        params = T.tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = net.loss(params, (_t(x), _t(y)), gen)
        loss.backward()
        grads = T.tree_map(lambda p: p.grad, params)
        params, opt = adamw_update(grads, opt, params, lr=1e-3, weight_decay=1e-4)
        assert abs(float(loss.detach()) - alex["step_losses"][i]) <= LOSS_TOL
        rp, ropt = alex["states"][i + 1]
        assert int(opt.step) == int(ropt.step) == i + 1
        _held_adam_step(f"step {i}", _hwio((params, opt.mu, opt.nu)),
                        (rp, ropt.mu, ropt.nu), 1e-3)


# ------------------------------------------------------------------ repair: wrappers refuse autograd
def _wrapper_calls():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)

    q, k = r(1, 4, 2, 16), r(1, 4, 2, 16)
    return {
        "flash_attention": (lambda a: fa_ops.flash_attention(a, k, k), q),
        "decode_attention": (lambda a: fa_ops.decode_attention(
            a, k, k, torch.tensor([3], dtype=torch.int32)), r(1, 1, 2, 16)),
        "exit_confidence": (lambda a: eh_ops.exit_confidence(a, r(10, 16)), r(1, 2, 16)),
        "ssm_scan": (lambda a: ss_ops.ssm_scan(a, k, k, -torch.ones(1, 4, 2, 16),
                                               torch.zeros(1, 2, 16, 16)), q),
    }


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "exit_confidence", "ssm_scan"])
def test_kernel_wrappers_refuse_autograd(name):
    fn, a = _wrapper_calls()[name]
    fn(a)                                            # no grad asked: runs
    a.requires_grad_()
    with torch.no_grad():
        fn(a)                                        # grad mode off: runs
    with pytest.raises(RuntimeError, match="impl='auto'"):
        fn(a)
