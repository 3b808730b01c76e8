"""The port's linear scans against the JAX package's, on the same numpy
inputs in float32: ``scan_sequential`` (the scan kernel's plain version),
``scan_chunked`` and the ``linear_scan`` dispatch at 2e-4 (the tolerance of
tests/test_linear_scan.py), a ragged S and S=1, and the strong-decay edge
log_w = -8, where the port's kernel path stays finite and equal to the
sequential recurrence."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import linear_scan as ref_ls
from repro_torch.models import linear_scan as ls

TOL = 2e-4


def _inputs(seed, B, S, H, dk, dv, decay_scale=0.5, rwkv=True):
    rng = np.random.default_rng(seed)
    q, k = rng.standard_normal((2, B, S, H, dk)).astype(np.float32)
    v = rng.standard_normal((B, S, H, dv)).astype(np.float32)
    lw = -np.exp(rng.standard_normal((B, S, H, dk)) * decay_scale).astype(np.float32)
    st0 = (rng.standard_normal((B, H, dk, dv)) * 0.2).astype(np.float32)
    u = (rng.standard_normal((H, dk)) * 0.2).astype(np.float32) if rwkv else None
    return q, k, v, lw, st0, u


def _both(args):
    j = tuple(None if a is None else jnp.asarray(a) for a in args)
    t = tuple(None if a is None else torch.from_numpy(a) for a in args)
    return j, t


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("rwkv", [True, False])
@pytest.mark.parametrize("fn", ["scan_sequential", "scan_chunked"])
def test_scans_match_reference(fn, rwkv):
    (jq, jk, jv, jw, js, ju), (q, k, v, w, s, u) = _both(
        _inputs(0, 2, 64, 3, 8, 16, rwkv=rwkv))
    ro, rs = getattr(ref_ls, fn)(jq, jk, jv, jw, js, u=ju)
    o, s1 = getattr(ls, fn)(q, k, v, w, s, u=u)
    assert o.dtype == torch.float32 and s1.dtype == torch.float32
    _close(o, ro)
    _close(s1, rs)


@pytest.mark.parametrize("S", [40, 32, 7])
@pytest.mark.parametrize("impl", ["kernel", "dense"])
def test_linear_scan_dispatch_matches_reference(S, impl):
    """``dense`` is the reference's ``mode="auto"`` dispatch (chunked at S 32,
    sequential at the ragged 40 and the short 7); ``kernel`` steps the
    recurrence at any S."""
    (jq, jk, jv, jw, js, ju), (q, k, v, w, s, u) = _both(_inputs(S, 1, S, 2, 16, 8))
    ro, rs = ref_ls.linear_scan(jq, jk, jv, jw, js, u=ju)
    o, s1 = ls.linear_scan(q, k, v, w, s, u=u, impl=impl)
    _close(o, ro)
    _close(s1, rs)


@pytest.mark.parametrize("rwkv", [True, False])
@pytest.mark.parametrize("S", [40, 1])
def test_kernel_path_ragged_and_single_step(S, rwkv):
    """A ragged S (40 is no multiple of 16) and decode's S=1 from a non-zero
    state, against the reference's ``scan_sequential``."""
    (jq, jk, jv, jw, js, ju), (q, k, v, w, s, u) = _both(
        _inputs(S + 100, 2, S, 3, 16, 32, rwkv=rwkv))
    ro, rs = ref_ls.scan_sequential(jq, jk, jv, jw, js, u=ju)
    o, s1 = ls.linear_scan(q, k, v, w, s, u=u, impl="kernel")
    _close(o, ro)
    _close(s1, rs)


def test_chunked_and_sequential_compose():
    """Two calls carrying the state equal one call over both halves."""
    _, (q, k, v, w, s, u) = _both(_inputs(7, 1, 64, 2, 8, 8))
    o_full, s_full = ls.scan_chunked(q, k, v, w, s, u=u)
    o1, s1 = ls.scan_sequential(q[:, :32], k[:, :32], v[:, :32], w[:, :32], s, u=u)
    o2, s2 = ls.scan_chunked(q[:, 32:], k[:, 32:], v[:, 32:], w[:, 32:], s1, u=u)
    _close(o_full, torch.cat([o1, o2], 1), 1e-5)
    _close(s_full, s2, 1e-5)


@pytest.mark.parametrize("rwkv", [True, False])
def test_strong_decay_stays_finite_on_the_kernel_path(rwkv):
    """At log_w = -8 (the clamp) a 16-step chunk's cumulative decay is
    exp(-128), below f32's range: the ratio trick of the reference's chunked
    scan divides by it and turns non-finite (the port's ``scan_chunked``
    keeps that behaviour, as the reference).  The kernel path steps the
    recurrence and equals the reference's ``scan_sequential``."""
    B, S, H, dk, dv = 1, 32, 2, 8, 8
    q, k, v, _, st0, u = _inputs(3, B, S, H, dk, dv, rwkv=rwkv)
    lw = np.full((B, S, H, dk), -8.0, np.float32)
    (jq, jk, jv, jw, js, ju), (tq, tk, tv, tw, ts, tu) = _both((q, k, v, lw, st0, u))
    ro, rs = ref_ls.scan_sequential(jq, jk, jv, jw, js, u=ju)
    assert np.isfinite(np.asarray(ro)).all()
    o, s1 = ls.linear_scan(tq, tk, tv, tw, ts, u=tu, impl="kernel")
    assert torch.isfinite(o).all() and torch.isfinite(s1).all()
    _close(o, ro)
    _close(s1, rs)
    co, _ = ls.scan_chunked(tq, tk, tv, tw, ts, u=tu, chunk=16)
    rco, _ = ref_ls.scan_chunked(jq, jk, jv, jw, js, u=ju, chunk=16)
    assert not torch.isfinite(co).all()
    assert not np.isfinite(np.asarray(rco)).all()


def test_bad_impl_and_ragged_chunk_raise():
    _, (q, k, v, w, s, u) = _both(_inputs(1, 1, 12, 1, 8, 8))
    with pytest.raises(ValueError, match="impl"):
        ls.linear_scan(q, k, v, w, s, u=u, impl="pallas")
    with pytest.raises(ValueError, match="multiple"):
        ls.scan_chunked(q, k, v, w, s, u=u, chunk=16)
