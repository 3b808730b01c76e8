"""The port's optimiser, schedule and gradient compression
(``repro_torch.optim``) against the reference's (``repro.optim``) on the
CPU, on the same seeded inputs, and the reference's own optimiser checks
(``tests/test_optim.py``) ported.

Tolerances: float32 leaves within 1e-6 of the reference after three AdamW
steps (both sides compute the same float32 formula; the global norm sums
its squares in another order); bfloat16 leaves and moments bit for bit
(each is a float32 value rounded once); the int8 payload byte for byte (both
round half to even) and the residuals within 1e-7.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as r_adamw
from repro.optim import grad_compress as r_gc
from repro.optim.schedule import warmup_cosine as r_warmup_cosine
from repro_torch import tree as T
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.grad_compress import (EFState, compress_grads, ef_init,
                                             quantize_int8, topk_compress)
from repro_torch.optim.schedule import warmup_cosine


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"embed": (scale * rng.normal(size=(6, 4))).astype(np.float32),
            "segments": ({"wq": (scale * rng.normal(size=(2, 4, 4))).astype(np.float32),
                          "ln": (1 + scale * rng.normal(size=(2, 4))).astype(np.float32)},),
            "final_norm": (scale * rng.normal(size=(4,))).astype(np.float32)}


def _jax(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _torch(tree, dtype):
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)).to(dtype), tree)


def _bits(x):
    """A leaf of either package as comparable numpy (bfloat16 as its bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == jnp.bfloat16 else x


# ------------------------------------------------------------------ schedule
def test_warmup_cosine_matches_reference():
    for step in range(401):
        for s_ref, s in ((step, step), (jnp.asarray(step, jnp.int32),
                                        torch.tensor(step, dtype=torch.int32))):
            want = float(r_warmup_cosine(s_ref, peak_lr=3e-4, warmup=50, total=300))
            got = warmup_cosine(s, peak_lr=3e-4, warmup=50, total=300)
            assert got.dtype == torch.float32 and got.ndim == 0
            assert abs(float(got) - want) <= 1e-7, (step, float(got), want)


# ------------------------------------------------------------------ AdamW
@pytest.mark.parametrize("variant", ["f32", "bf16_params", "bf16_moments", "f32_clipped"])
def test_adamw_three_steps_match_reference(variant):
    p_dt = "bf16" if variant == "bf16_params" else "f32"
    m_dt = "bf16" if variant == "bf16_moments" else "f32"
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}
    # the clipped case has grads whose global norm is far above grad_clip = 1
    gscale = 50.0 if variant == "f32_clipped" else 0.05
    kw = dict(lr=1e-2, weight_decay=0.1)
    rp, p = _jax(_np_tree(0), jdt[p_dt]), _torch(_np_tree(0), tdt[p_dt])
    ropt = r_adamw.adamw_init(rp, moment_dtype=jdt[m_dt])
    opt = adamw_init(p, moment_dtype=tdt[m_dt])
    for i in range(3):
        g_np = _np_tree(10 + i, gscale)
        rg = jax.tree_util.tree_map(lambda a, q: jnp.asarray(a, q.dtype), g_np, rp)
        g = T.tree_map(lambda a, q: torch.from_numpy(a).to(q.dtype), g_np, p)
        if variant == "f32_clipped":
            gnorm = np.sqrt(sum(np.sum(np.square(a)) for a in T.leaves(g_np)))
            assert gnorm > 10.0
        rp, ropt = r_adamw.adamw_update(rg, ropt, rp, **kw)
        p, opt = adamw_update(g, opt, p, **kw)
    assert int(opt.step) == int(ropt.step) == 3 and opt.step.dtype == torch.int32
    ours = T.leaves_with_paths((p, opt))
    theirs = dict(T.leaves_with_paths((rp, ropt)))
    for key, got in ours:
        want = theirs[key]
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), key
        if got.dtype == torch.bfloat16:
            np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=key)
        else:
            np.testing.assert_allclose(_bits(got), _bits(want), rtol=0, atol=1e-6,
                                       err_msg=key)


def test_adamw_is_functional():
    p = {"w": torch.ones(3)}
    opt = adamw_init(p)
    p2, opt2 = adamw_update({"w": torch.ones(3)}, opt, p, lr=0.1)
    assert torch.equal(p["w"], torch.ones(3)) and int(opt.step) == 0
    assert not torch.equal(p2["w"], p["w"]) and int(opt2.step) == 1
    assert isinstance(opt2, AdamWState)


# ------------------------------------------------------------------ compression
def test_compress_grads_five_steps_match_reference():
    rng = np.random.default_rng(3)
    shapes = {"a": (33,), "b": (4, 7)}
    ref_ef = r_gc.ef_init({k: jnp.zeros(s) for k, s in shapes.items()})
    ef = ef_init({k: torch.zeros(s) for k, s in shapes.items()})
    for _ in range(5):
        g_np = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        for k in shapes:
            x = g_np[k] + np.asarray(ref_ef.residual[k])
            rq, rs = r_gc.quantize_int8(jnp.asarray(x))
            q, s = quantize_int8(torch.from_numpy(x))
            assert q.dtype == torch.int8
            np.testing.assert_array_equal(q.numpy().tobytes(), np.asarray(rq).tobytes())
            assert float(s) == float(rs)
        rc, ref_ef = r_gc.compress_grads({k: jnp.asarray(v) for k, v in g_np.items()}, ref_ef)
        c, ef = compress_grads({k: torch.from_numpy(v) for k, v in g_np.items()}, ef)
        assert isinstance(ef, EFState)
        for k in shapes:
            np.testing.assert_array_equal(c[k].numpy(), np.asarray(rc[k]))
            np.testing.assert_allclose(ef.residual[k].numpy(), np.asarray(ref_ef.residual[k]),
                                       rtol=0, atol=1e-7)


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.25, 0.5])
def test_topk_compress_matches_reference(frac):
    g = np.random.default_rng(4).normal(size=(5, 40)).astype(np.float32)
    g[0, :6] = 2.5                                  # ties at the threshold
    got = topk_compress(torch.from_numpy(g), frac=frac).numpy()
    np.testing.assert_array_equal(got, np.asarray(r_gc.topk_compress(jnp.asarray(g), frac)))


# ------------------------------------------------------------------ tests/test_optim.py, ported
def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    opt = adamw_init(params)
    for _ in range(300):
        w = params["w"].clone().requires_grad_()
        torch.sum(w ** 2).backward()
        params, opt = adamw_update({"w": w.grad}, opt, params, lr=5e-2, weight_decay=0.0)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


def test_adamw_grad_clip():
    params = {"w": torch.tensor([1.0])}
    opt = adamw_init(params)
    p2, _ = adamw_update({"w": torch.tensor([1e9])}, opt, params, lr=0.1,
                         weight_decay=0.0, grad_clip=1.0)
    assert abs(float(p2["w"][0]) - 0.9) < 1e-3   # clipped unit-step


def test_bf16_moments():
    params = {"w": torch.ones((8, 4))}
    opt = adamw_init(params, moment_dtype=torch.bfloat16)
    assert opt.mu["w"].dtype == torch.bfloat16
    p2, opt2 = adamw_update({"w": torch.ones((8, 4))}, opt, params, lr=1e-2)
    assert opt2.nu["w"].dtype == torch.bfloat16
    assert bool(torch.all(torch.isfinite(p2["w"])))


def test_quantize_roundtrip_error_bounded():
    x = torch.linspace(-4, 4, 1000)
    q, s = quantize_int8(x)
    err = (q.float() * s - x).abs().max()
    assert float(err) <= float(s) / 2 + 1e-6


def test_error_feedback_unbiased_over_time():
    """The *sum* of compressed grads converges to the sum of true grads
    (the residual stays bounded)."""
    rng = np.random.default_rng(0)
    g_true = {"w": torch.from_numpy(rng.normal(0, 1, (64,)).astype(np.float32))}
    ef = ef_init(g_true)
    total_c = torch.zeros(64)
    n = 50
    for _ in range(n):
        c, ef = compress_grads(g_true, ef)
        total_c = total_c + c["w"]
    np.testing.assert_allclose((total_c / n).numpy(), g_true["w"].numpy(), atol=2e-3)


def test_topk_keeps_largest():
    out = topk_compress(torch.tensor([0.1, -5.0, 0.2, 3.0, -0.05]), frac=0.4)
    np.testing.assert_array_equal((out != 0).numpy(), [False, True, False, True, False])


def test_warmup_cosine_shape():
    lrs = [float(warmup_cosine(torch.tensor(s), peak_lr=1.0, warmup=10, total=100))
           for s in range(100)]
    assert lrs[0] < lrs[9] <= 1.0 + 1e-6
    assert lrs[10] == pytest.approx(1.0, rel=1e-2)
    assert lrs[99] < 0.2
