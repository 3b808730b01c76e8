"""The port's training path against the reference's on the CPU: the flash
attention with its flash backward, the chunked CE, the joint multi-exit
loss and its grads for the dense, ssm and hybrid families, the train step
and the training CLI for the dense stack and every family, the step's
donated state and the trainer's cold restart, the prefetch loader, BranchyNet joint training of
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
  at most ~lr); for the families (ssm, hybrid, MoE, VLM, enc-dec) every
  parameter within 2 lr and all but one in 1000 within 2e-5, the Adam rule
  of BranchyAlexNet's steps below, and all but one in 32 of each leaf;
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
import importlib.util
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
from repro_torch.launch import train as train_mod
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
#: the dense stack and the five families the trainer takes (``--arch``)
TRAIN_ARCHS = ARCHS + ("llama4-scout-17b-a16e", "llava-next-mistral-7b",
                       "seamless-m4t-large-v2")


def _train_batches(cfg, n):
    """``n`` batches as the trainer builds them (``train.train_batch``):
    tokens [2, 33], with the enc-dec's frames and the VLM's prefix (its
    tokens cut to fill 33 positions), each as numpy."""
    out = []
    for s in range(n):
        b = train_mod.train_batch(cfg, _t(_tokens(cfg.vocab_size, seed=s)), s, 33, "cpu")
        out.append({k: v.numpy() for k, v in b.items()})
    return out


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_matches_reference(arch):
    """Three steps of ``make_train_step`` against the reference's on its
    host mesh, from the same params and batches (the enc-dec's frames and
    the VLM's prefix as the trainer builds them).  llama3.2-1b: every
    parameter within 2e-5.  The families: every parameter within 2 lr,
    all but one element in 1000 within 2e-5 over all leaves and all but
    one in 32 of each leaf (so no leaf, however small, can be updated
    wrongly as a whole).  Adam divides each gradient by its running RMS,
    so an element whose gradients stay within rounding of zero takes a
    step that rounding decides; such elements are scattered through the
    families' leaves (rwkv6-3b: 86 elements over 23 leaves, up to 1.1e-4
    apart, at most 7 of one leaf's 4096 and 1 of a 64-element norm's;
    zamba2-2.7b: 3 elements in 2 leaves)."""
    rcfg = ref_get_smoke(arch)
    rmodel = RefModel(rcfg)
    rparams = rmodel.init_params(jax.random.key(0), dtype=jnp.float32)
    mesh = make_host_mesh()
    rstep, _ = ref_make_train_step(rmodel, mesh, RShapeConfig("t", 32, 2, "train"),
                                   **TRAIN_KW)
    cfg = get_smoke_config(arch)
    batches = _train_batches(cfg, 3)
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, rparams), device="cpu")
    opt = adamw_init(params)
    step, _ = make_train_step(Model(cfg), None, ShapeConfig("t", 32, 2, "train"),
                              device="cpu", **TRAIN_KW)
    ropt = ref_adamw.adamw_init(rparams)
    with mesh:
        for b in batches:
            rparams, ropt, rmet = rstep(rparams, ropt,
                                        {k: jnp.asarray(v) for k, v in b.items()})
            params, opt, met = step(params, opt, {k: _t(v) for k, v in b.items()})
            assert abs(float(met["loss"]) - float(rmet["loss"])) <= LOSS_TOL
            assert abs(float(met["final_ce"]) - float(rmet["final_ce"])) <= LOSS_TOL
    assert int(opt.step) == int(ropt.step) == 3
    for p in T.leaves(params):
        assert not p.requires_grad and p.grad is None
    want = jax.tree_util.tree_map(np.asarray, rparams)
    if arch == "llama3.2-1b":
        want = dict(T.leaves_with_paths(want))
        for key, p in T.leaves_with_paths(params):
            np.testing.assert_allclose(p.numpy(), want[key], rtol=0, atol=2e-5, err_msg=key)
    else:
        _held_adam_step(arch, params, want, TRAIN_KW["peak_lr"], atol=2e-5, per_leaf=32)


@pytest.mark.parametrize("donate", [False, True])
def test_adamw_update_in_slices_equals_whole_leaves(monkeypatch, donate):
    """The update computed UPDATE_SLICE elements at a time (slices within
    leaves here) is bit for bit the update of whole leaves; with
    ``donate`` it is written into the given parameters and moments,
    without it they are left unchanged."""
    from repro_torch.optim import adamw as adamw_mod
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((40, 30), generator=gen).to(torch.bfloat16),
              "b": torch.randn((7,), generator=gen), "s": torch.randn((), generator=gen)}
    grads = T.tree_map(lambda p: torch.randn(p.shape, generator=gen).to(p.dtype), params)
    opt = adamw_init(params)
    opt = AdamWState(opt.step, *(T.tree_map(lambda m: torch.rand(m.shape, generator=gen), t)
                                 for t in (opt.mu, opt.nu)))
    want = adamw_update(grads, opt, params, lr=1e-2)
    keep = T.tree_map(torch.clone, (params, opt))
    ptrs = [t.data_ptr() for t in T.leaves((params, opt.mu, opt.nu))]
    monkeypatch.setattr(adamw_mod, "UPDATE_SLICE", 64)    # 2 rows of w a slice
    got = adamw_update(grads, opt, params, lr=1e-2, donate=donate)
    for a, b in zip(T.leaves(got), T.leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    got_ptrs = [t.data_ptr() for t in T.leaves((got[0], got[1].mu, got[1].nu))]
    if donate:
        assert got_ptrs == ptrs
    else:
        assert not set(got_ptrs) & set(ptrs)
        for a, b in zip(T.leaves(keep), T.leaves((params, opt))):
            assert torch.equal(a, b)


@pytest.fixture
def world_of_one():
    """The host mesh over a gloo world of one process, ended after the
    test if the test started it."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh as host_mesh
    started = not dist.is_initialized()
    yield host_mesh(device="cpu")
    if started:
        dist.destroy_process_group()


def test_train_step_donates_its_state(world_of_one):
    """The step writes the new parameters and moments into the ones it is
    given and returns them (the reference's ``donate_argnums``): mesh-less,
    and on the host mesh, where it writes into each DTensor's local shard
    (on a mesh of one the whole tensors gathered after it are the given
    ones).  Both give the same values bit for bit."""
    cfg = get_smoke_config("llama4-scout-17b-a16e")
    model = Model(cfg)
    shape = ShapeConfig("t", 32, 2, "train")
    params = model.init_params(torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                               device="cpu")
    states = {}
    for mesh in (None, world_of_one):
        state = T.tree_map(torch.clone, (params, adamw_init(params)))
        ptrs = [t.data_ptr() for t in T.leaves((state[0], state[1].mu, state[1].nu))]
        step, _ = make_train_step(model, mesh, shape, device="cpu", **TRAIN_KW)
        for b in _train_batches(cfg, 2):
            p, opt, _ = step(*state, {k: _t(v) for k, v in b.items()})
            state = (T.tree_map(train_mod._whole, p), T.tree_map(train_mod._whole, opt))
        assert [t.data_ptr() for t in T.leaves((state[0], state[1].mu, state[1].nu))] == ptrs
        assert int(state[1].step) == 2
        states[mesh is None] = state
    for a, b in zip(T.leaves(states[True]), T.leaves(states[False])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not any(torch.equal(a, b) for a, b in zip(T.leaves(states[True][0]),
                                                     T.leaves(params))
                   if a.dtype == torch.float32)


def test_trainer_cold_restart_starts_from_the_initial_state(tmp_path):
    """A failure before the first checkpoint restarts the trainer from its
    initial state made anew (the step donated the one it was given): the
    run ends where two steps from the initial state end on the batches
    after the one the failed run took."""
    out = train_mod.train(steps=2, batch=2, seq=17, save_every=10, inject_failure_at=1,
                          ckpt_dir=tmp_path / "ck", device="cpu")
    assert out["info"] == {"restarts": 1, "final_step": 2} and len(out["losses"]) == 3
    cfg = get_smoke_config("llama3.2-1b")
    model = Model(cfg)
    step = train_mod.trainer_step(model, 17, 2, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0), dtype=torch.float32,
                               device="cpu")
    state = (params, adamw_init(params))
    data = train_mod.token_batches(0, 2, 17, cfg.vocab_size)
    next(data)                                     # the failed run's one step
    for i in range(2):
        tokens = torch.from_numpy(next(data))
        p, opt, met = step(*state, train_mod.train_batch(cfg, tokens, i, 17, "cpu"))
        assert float(met["loss"]) == out["losses"][1 + i]
        state = (p, opt)
    for a, b in zip(T.leaves(state), T.leaves((out["params"], out["opt"]))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_cli_survives_injected_failure(tmp_path, arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
         "--arch", arch, "--steps", "6", "--batch", "2", "--seq", "17", "--save-every", "2",
         "--inject-failure-at", "3", "--ckpt-dir", str(tmp_path / "ck")],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert res.returncode == 0, res.stderr
    assert "[restart] resumed at step 2" in res.stdout
    assert "done: 6 steps" in res.stdout and "restarts=1" in res.stdout
    assert sorted(os.listdir(tmp_path / "ck")) == [f"step_{s:09d}" for s in (2, 4, 6)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_phase21",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", TRAIN_ARCHS[1:])
def test_phase21_holds_rehearsed_at_smoke_width(arch):
    """``chip_smoke.py`` phase 21's float32 holds (``train_holds``) on the
    CPU on the smoke config at S 64: remat against none, the chunked scan
    against the sequential one (end to end, and each block's scan on its
    own inputs, forward and backward), and flash against dense with flash
    blocks of 16 (the card's hold takes "auto" past 1024² scores), every
    leaf of the grads within 1e-4 of the leaf's largest + 1e-6, scout's
    router choices equal on both paths."""
    cs = _chip_smoke()
    flash16 = (cs.HOLD_FLASH[0], dict(cs.HOLD_FLASH[1], attn_impl="flash@16"),
               cs.HOLD_FLASH[2])
    holds = [(flash16 if h is cs.HOLD_FLASH else h, 64, None)
             for h, _, _ in cs.TRAIN_HOLDS[arch]]
    out = cs.train_holds(torch, arch, get_smoke_config(arch), holds, dev="cpu")
    assert [(o["hold"], o["S"]) for o in out] == [(h[0], S) for h, S, _ in holds]
    assert all(o["worst"] <= 1.0 and o["flips"] == 0 for o in out)
    for o in out:
        if o["hold"] == cs.HOLD_SCAN[0]:       # every block's scan held on its inputs
            sc = o["scans"]
            assert sc["calls"] == get_smoke_config(arch).num_layers
            assert max(sc["o"], sc["state"], sc["grad"][0]) <= 1.0


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


def _held_adam_step(label, got, want, lr, atol=1e-5, per_leaf=None):
    """Every element within 2 lr, all but one in 1000 within ``atol``, and
    with ``per_leaf`` = n all but one in n of each leaf's elements (a leaf
    of fewer than n elements has none beyond ``atol``)."""
    want = dict(T.leaves_with_paths(want))
    n = far = 0
    for key, t in T.leaves_with_paths(got):
        err = np.abs(t.numpy() - np.asarray(want[key], np.float32))
        assert float(err.max()) <= 2 * lr, (label, key, float(err.max()))
        beyond = int((err > atol).sum())
        n, far = n + err.size, far + beyond
        if per_leaf:
            assert beyond <= err.size // per_leaf, (label, key, beyond, err.size)
    assert far <= n // 1000, f"{label}: {far} of {n} elements beyond {atol}"


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
