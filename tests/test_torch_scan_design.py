"""The arithmetic of the port's chunked SSM scan kernels, emulated on the CPU
and held against the JAX package's ``scan_sequential`` and the port's plain
scan.

No CUDA kernel runs here.  ``csrc/ssm_scan.cu`` (bf16, dk = dv = 64, S of
at least one chunk) cuts time into chunks of 16 tokens and passes the f32
state from chunk to chunk.  The decays that reach the state are products of
the per-token w_t = exp(max(log_w, -8)); the intra-chunk matrix A is
factored through the chunk's token 7, every exponent at most 64 in size,
and masked by selection.  Every f32 operand of a tensor-core product (the
state, q and k times their decays, A) is split into bf16 terms whose
products are exact; the sums are f32.  A ragged last chunk is zero-filled
(k = v = 0, log_w = 0).  Two kernels:

* per-channel decay (RWKV-6): Q' = q prod w and K' = k prod w per channel,
  A from f32 dot products on the CUDA cores, RWKV's bonus q (u k) on the
  diagonal;
* per-head decay (Mamba-2): the decays are per-token scalars, so the read-out
  takes raw q and scales each token afterwards, and A is (q k^T) scaled by
  e^{c_t - c_j}.

The emulations repeat that arithmetic in torch and are held to the
tolerances ``chip_smoke.py`` holds the kernels to on the card: an output
within 3e-4 + |plain| / 128 (bf16), the state within 3e-4 + |plain| 2^-20.
"""
import numpy as np
import pytest
import torch

from repro.models import linear_scan as ref_ls
from repro_torch.kernels.ssm_scan import ops as ss_ops
from repro_torch.kernels.ssm_scan import ref as ss_ref

SCAN_ATOL, BF16_RTOL, STATE_RTOL = 3e-4, 2.0 ** -7, 2.0 ** -20
C, MID = ss_ops.CHUNK, 7
LOG2E = 1.4426950408889634
TERMS = 3                        # kTerms in csrc/ssm_scan.cu


def split(x, terms=TERMS):
    """x as ``terms`` bf16 terms (round to nearest even), widened to f32."""
    out = []
    for _ in range(terms):
        hi = x.to(torch.bfloat16).float()
        out.append(hi)
        x = x - hi
    return out


def _chunks(q, k, v, lw):
    """Zero-filled to whole chunks, head-major: [B, H, n, C, *]."""
    S = q.shape[1]
    pad = (-S) % C

    def prep(x):
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
        B, Sp, H, D = x.shape
        return x.permute(0, 2, 1, 3).reshape(B, H, Sp // C, C, D)
    return prep(q), prep(k), prep(v), prep(torch.clamp(lw.float(), min=-8.0))


def _prefix(w, inclusive):
    p = torch.cumprod(w, dim=-2)
    if inclusive:
        return p
    return torch.cat([torch.ones_like(p[..., :1, :]), p[..., :-1, :]], dim=-2)


def _suffix(w):
    """prod_{tau > t} w, multiplied from the chunk's end."""
    p = torch.flip(torch.cumprod(torch.flip(w, [-2]), dim=-2), [-2])
    return torch.cat([p[..., 1:, :], torch.ones_like(p[..., :1, :])], dim=-2)


def emulate_channel(q, k, v, lw, state, u=None, terms=TERMS):
    """The per-channel kernel: q/k/v [B, S, H, 64] holding bf16 values, lw
    [B, S, H, 64], state [B, H, 64, 64].  Returns (o widened from bf16,
    final state)."""
    S = q.shape[1]
    qc, kc, vc, lc = _chunks(q, k, v, lw)
    rwkv = u is not None
    w = torch.exp(lc)
    c = torch.cumsum(lc * LOG2E, dim=-2)
    e = torch.cat([torch.zeros_like(c[..., :1, :]), c[..., :-1, :]], dim=-2)
    x = e if rwkv else c
    mask = torch.tril(torch.ones(C, C, dtype=torch.bool), -1 if rwkv else 0)
    st = state.float().clone()
    outs = []
    for n in range(qc.shape[2]):
        qn, kn, vn, wn, cn, xn = (t[:, :, n] for t in (qc, kc, vc, w, c, x))
        qp = qn * _prefix(wn, inclusive=not rwkv)
        o = sum(qj @ si for qj in split(qp, terms) for si in split(st, terms))
        cm = cn[..., MID:MID + 1, :]
        a = (qn * torch.exp2(xn - cm)) @ (kn * torch.exp2(cm - cn)).transpose(-1, -2)
        a = torch.where(mask, a, torch.zeros(()))
        if rwkv:
            a = a + torch.diag_embed((qn * (kn * u[None, :, None, :].float())).sum(-1))
        o = o + sum(ai @ vn for ai in split(a, terms))
        outs.append(o)
        kp = kn * _suffix(wn)
        ds = sum(vn.transpose(-1, -2) @ ki for ki in split(kp, terms)).transpose(-1, -2)
        decay = _suffix(wn)[..., :1, :] * wn[..., :1, :]          # prod_{all 16} w
        st = st * decay.transpose(-1, -2) + ds
    o = torch.stack(outs, dim=2).flatten(2, 3)[:, :, :S].permute(0, 2, 1, 3)
    return o.to(torch.bfloat16).float(), st


def emulate_head(q, k, v, lw, state, terms=TERMS):
    """The per-head kernel (Mamba-2 mode): lw [B, S, H, 64] with one value
    per (b, s, h) across its channels."""
    S = q.shape[1]
    qc, kc, vc, lc = _chunks(q, k, v, lw)
    lc = lc[..., :1]                                                 # [B, H, n, C, 1]
    w = torch.exp(lc)
    c = torch.cumsum(lc * LOG2E, dim=-2)
    mask = torch.tril(torch.ones(C, C, dtype=torch.bool))
    st = state.float().clone()
    outs = []
    for n in range(qc.shape[2]):
        qn, kn, vn, wn, cn = (t[:, :, n] for t in (qc, kc, vc, w, c))
        o = (qn @ sum(split(st, terms))) * _prefix(wn, inclusive=True)
        a = (qn @ kn.transpose(-1, -2)) * torch.exp2(cn - cn.transpose(-1, -2))
        a = torch.where(mask, a, torch.zeros(()))
        o = o + sum(ai @ vn for ai in split(a, terms))
        outs.append(o)
        kp = kn * _suffix(wn)
        ds = sum(vn.transpose(-1, -2) @ ki for ki in split(kp, terms)).transpose(-1, -2)
        st = st * (_suffix(wn)[..., :1, :] * wn[..., :1, :]) + ds
    o = torch.stack(outs, dim=2).flatten(2, 3)[:, :, :S].permute(0, 2, 1, 3)
    return o.to(torch.bfloat16).float(), st


def inputs(seed, B, S, H, mode, decay):
    """chip_smoke.py's scan inputs at a small size: bf16 q/k/v (Mamba-2: q
    and k broadcast over heads, the decay over channels), a non-zero state,
    u for RWKV."""
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale)

    def bf16(x):
        return x.to(torch.bfloat16).float()

    if mode == "rwkv":
        q, k, v = bf16(randn(B, S, H, 64)), bf16(randn(B, S, H, 64)), bf16(randn(B, S, H, 64))
        shape = (B, S, H, 64)
    else:
        q = bf16(randn(B, S, 1, 64)).expand(B, S, H, 64)
        k = bf16(randn(B, S, 1, 64)).expand(B, S, H, 64)
        v = bf16(randn(B, S, H, 64))
        shape = (B, S, H, 1)
    if decay == "strong":
        lw = torch.full(shape, -8.0)
    elif decay == "weak":                        # the served model's w0 = -6
        lw = -torch.exp(randn(*shape, scale=0.5) - 6.0)
    else:
        lw = -torch.exp(randn(*shape, scale=0.5))
    lw = lw.expand(B, S, H, 64)
    u = randn(H, 64, scale=0.1) if mode == "rwkv" else None
    return q, k, v, lw, randn(B, H, 64, 64, scale=0.1), u


def emulate(mode, q, k, v, lw, s0, u, terms=TERMS):
    if mode == "rwkv":
        return emulate_channel(q, k, v, lw, s0, u, terms=terms)
    return emulate_head(q, k, v, lw, s0, terms=terms)


def shares(o, st, po, ps):
    """The largest shares of the allowed error, output and state."""
    so = ((o - po).abs() / (SCAN_ATOL + BF16_RTOL * po.abs())).max().item()
    ss = ((st - ps).abs() / (SCAN_ATOL + STATE_RTOL * ps.abs())).max().item()
    return so, ss


def _jax_plain(q, k, v, lw, s0, u):
    import jax.numpy as jnp
    args = (jnp.asarray(t.contiguous().numpy()) for t in (q, k, v, lw, s0))
    o, s = ref_ls.scan_sequential(*args, u=None if u is None else jnp.asarray(u.numpy()))
    return torch.from_numpy(np.array(o, np.float32)), torch.from_numpy(np.array(s, np.float32))


@pytest.mark.parametrize("decay", ["random", "weak", "strong"])
@pytest.mark.parametrize("S", [1, 12, 64, 65, 203])
@pytest.mark.parametrize("mode", ["rwkv", "mamba2"])
def test_chunked_scan_design_meets_the_stated_tolerance(mode, S, decay):
    """Both modes, one ragged chunk (S 1, 12), a chunk edge (64, 65), several
    chunks with a ragged tail (203), random, weak and log_w = -8 decay:
    within chip_smoke.py's tolerances of the JAX oracle and the plain scan,
    and finite (log_w = -8 makes the reference's ratio trick overflow)."""
    q, k, v, lw, s0, u = inputs(S, 1, S, 2, mode, decay)
    o, st = emulate(mode, q, k, v, lw, s0, u)
    assert torch.isfinite(o).all() and torch.isfinite(st).all()
    for po, ps in (_jax_plain(q, k, v, lw, s0, u), ss_ref.ssm_scan(q, k, v, lw, s0, u=u)):
        so, ss = shares(o, st, po, ps)
        assert so <= 1.0 and ss <= 1.0, (so, ss)


def test_per_channel_emulation_takes_a_per_head_decay_too():
    """The per-channel kernel in the Mamba-2 mode (a per-channel log_w that
    happens to be constant over channels) agrees with the per-head one."""
    q, k, v, lw, s0, _ = inputs(5, 1, 100, 2, "mamba2", "random")
    oc, sc = emulate_channel(q, k, v, lw, s0)
    oh, sh = emulate_head(q, k, v, lw, s0)
    po, ps = ss_ref.ssm_scan(q, k, v, lw, s0)
    assert max(shares(oc, sc, po, ps)) <= 1.0 and max(shares(oh, sh, po, ps)) <= 1.0


@pytest.mark.parametrize("mode", ["rwkv", "mamba2"])
def test_two_term_split_exceeds_the_allowance_at_weak_decay(mode):
    """Why three bf16 terms: at the served model's weak decay (w near 0.9975)
    the state sums rounding over all 1000 tokens, and two terms (~2^-17 of
    each operand) move the outputs near zero past the 3e-4 they are
    allowed; three hold both allowances."""
    q, k, v, lw, s0, u = inputs(11, 1, 1000, 12, mode, "weak")
    po, ps = ss_ref.ssm_scan(q, k, v, lw, s0, u=u)
    chosen = shares(*emulate(mode, q, k, v, lw, s0, u), po, ps)
    cheaper = shares(*emulate(mode, q, k, v, lw, s0, u, terms=2), po, ps)
    assert max(chosen) <= 1.0 < cheaper[0], (chosen, cheaper)


def test_split_terms_are_exact_bf16_and_sum_back():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(4096).astype(np.float32)) * 1e3
    terms = split(x)
    for t in terms:
        assert torch.equal(t, t.to(torch.bfloat16).float())
    assert ((terms[0] + terms[1] + terms[2]) - x).abs().le(2.0 ** -24 * x.abs()).all()


@pytest.mark.parametrize("dtype,S,dims,want", [
    (torch.bfloat16, 1000, (64, 64), "chunked"),
    (torch.bfloat16, 16, (64, 64), "chunked"),
    (torch.bfloat16, 15, (64, 64), "stepped"),      # one ragged chunk: decode, short prompts
    (torch.bfloat16, 1, (64, 64), "stepped"),
    (torch.float32, 1000, (64, 64), "stepped"),     # f32 stays off the tensor cores
    (torch.bfloat16, 1000, (32, 32), "stepped"),
    (torch.bfloat16, 1000, (64, 16), "stepped"),
])
def test_route_is_by_dtype_and_shape(dtype, S, dims, want):
    q = torch.zeros((1, S, 2, dims[0]), dtype=dtype)
    v = torch.zeros((1, S, 2, dims[1]), dtype=dtype)
    assert ss_ops.route(q, v) == want


def test_tma_operands_keep_the_model_views_and_copy_the_rest():
    """The Mamba-2 block's broadcasts are read in place; what TMA cannot read
    is copied in the layout the kernels take."""
    B, S, H = 2, 40, 8
    bc = torch.randn(B, S, 3 * 64).to(torch.bfloat16)[..., 64:128]     # a slice, as mamba2 passes
    q = bc[:, :, None].expand(B, S, H, 64)
    v = torch.randn(B, S, H, 64).to(torch.bfloat16)
    lw = (-torch.rand(B, S, H))[..., None].expand(B, S, H, 64)
    q2, k2, v2, w, ws = ss_ops.tma_operands(q, q, v, lw, rwkv=False)
    assert q2 is q and k2 is q and v2 is v                        # no copies
    assert w.shape == (B, S, H) and ws == (S * H, H, 1, 0)
    assert torch.equal(w, lw[..., 0])
    # RWKV takes a per-head decay only expanded over its channels
    *_, w, ws = ss_ops.tma_operands(q, q, v, lw, rwkv=True)
    assert w.shape == (B, S, H, 64) and ws[-1] == 1 and torch.equal(w, lw)
    # heads not a multiple of 4: the per-head decay is padded, not expanded
    lw3 = (-torch.rand(B, S, 6))[..., None].expand(B, S, 6, 64)
    *_, w, ws = ss_ops.tma_operands(q[:, :, :6], q[:, :, :6], v[:, :, :6], lw3, rwkv=False)
    assert w.shape == (B, S, 6) and ws == (S * 8, 8, 1, 0) and torch.equal(w, lw3[..., 0])
    # strides TMA takes are read in place; a row that does not start on 16
    # bytes is copied to the model layout
    vt = v.transpose(1, 2).contiguous().transpose(1, 2)
    assert ss_ops.tma_operands(q, q, vt, lw, rwkv=False)[2] is vt
    vm = torch.randn(B, S, H, 65).to(torch.bfloat16)[..., 1:]
    v3 = ss_ops.tma_operands(q, q, vm, lw, rwkv=False)[2]
    assert v3.is_contiguous() and torch.equal(v3, vm)
