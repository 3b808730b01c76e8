"""The arithmetic and host side of the port's Hopper attention kernels,
emulated on the CPU and held against the JAX package's oracles.

No CUDA kernel runs here.  ``csrc/flash_attention.cu`` (bf16) computes
scores on tensor cores in f32 from bf16 inputs, keeps an online softmax in
f32 over 64-key tiles, and multiplies P by V as two bf16 terms (P_hi =
bf16(P), P_lo = bf16(P - P_hi)) accumulated in f32, rounding once at its
bf16 output.  ``csrc/decode_attention.cu`` splits a cache row's keys into
blocks of ``SPLIT_KEYS``, each leaving a partial (m, l, acc), and merges the
partials.  At head dim 80 the bf16 kernel runs its hd-128 layout on columns
that TMA fills with zeros past 80, scaled by 1 / sqrt(80), and the decode
kernel guards each lane's last column.  The emulations below repeat that
arithmetic in torch, so that the designs are held to the tolerances
``chip_smoke.py`` holds the kernels to on the card: 2e-5 + |plain| / 128 a
bf16 output (the f32 attention tolerance plus one bf16 ulp), 2e-5 in f32.
"""
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as ref_fa
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa_ops

ATOL, BF16_RTOL = 2e-5, 2.0 ** -7
NEG_INF = -1e30
TILE = 64


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _bf16(a):
    """f32 values that bf16 represents exactly (the kernel's inputs)."""
    return torch.from_numpy(a).to(torch.bfloat16).float()


def _oracle(fn, *arrays, **kw):
    """The JAX oracle in f32 on head-major inputs, as a torch tensor."""
    out = fn(*(jnp.asarray(a.numpy()) for a in arrays), **kw)
    return torch.from_numpy(np.array(out, np.float32))


def _share(got, plain, rtol):
    """Largest share of the allowed error any element takes."""
    return ((got - plain).abs() / (ATOL + rtol * plain.abs())).max().item()


# ------------------------------------------------------------ flash, bf16
def emulate_flash_bf16(q, k, v, *, causal=True, split_p=True, scale=None):
    """The wgmma kernel's arithmetic: q [B, H, S, hd], k/v [B, KV, T, hd]
    holding bf16 values in f32, scores scaled by ``scale`` (1 / sqrt(hd)
    when None).  Returns the bf16 output widened to f32."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    rows = torch.arange(S)[:, None]
    m = torch.full((B, H, S, 1), NEG_INF)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, hd))
    # every tile: one past the causal diagonal adds exp(-1e30 - m) = 0
    for k0 in range(0, T, TILE):
        kt, vt = k[:, :, k0:k0 + TILE], v[:, :, k0:k0 + TILE]
        s = (q @ kt.transpose(-1, -2)) * scale
        cols = k0 + torch.arange(kt.shape[2])[None, :]
        if causal:
            s = torch.where(cols <= rows + (T - S), s, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        p_hi = p.to(torch.bfloat16).float()
        pv = p_hi @ vt
        if split_p:
            pv = pv + (p - p_hi).to(torch.bfloat16).float() @ vt
        acc = acc * corr + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16).float()


@pytest.mark.parametrize("S,T,hd", [(1000, 1000, 64), (1000, 1000, 128), (77, 77, 128),
                                    (100, 300, 64)])
def test_flash_bf16_design_meets_the_stated_tolerance(S, T, hd):
    """P split into two bf16 terms keeps every output within 2e-5 +
    |plain| / 128 of the f32 oracle from the same bf16 inputs (ragged S,
    T > S with the diagonal aligned bottom-right)."""
    q, k, v = (_bf16(a) for a in _rand(S + hd, (1, 4, S, hd), (1, 1, T, hd), (1, 1, T, hd)))
    plain = _oracle(ref_fa.attention, q, k, v, causal=True)
    got = emulate_flash_bf16(q, k, v)
    assert torch.isfinite(got).all()
    assert _share(got, plain, BF16_RTOL) <= 1.0


def test_flash_bf16_single_rounding_of_p_takes_more_of_the_allowance():
    """Why P is split: one bf16 rounding of P (2^-9 relative a term) moves
    outputs near zero by more than the hi/lo split does, at S 1000."""
    S, hd = 1000, 64
    q, k, v = (_bf16(a) for a in _rand(7, (1, 4, S, hd), (1, 1, S, hd), (1, 1, S, hd)))
    plain = _oracle(ref_fa.attention, q, k, v, causal=True)
    split = _share(emulate_flash_bf16(q, k, v), plain, BF16_RTOL)
    single = _share(emulate_flash_bf16(q, k, v, split_p=False), plain, BF16_RTOL)
    assert split <= 1.0 < single


@pytest.mark.parametrize("S,T", [(1000, 1000), (77, 77), (100, 300)])
def test_flash_bf16_hd80_padded_design(S, T):
    """Head dim 80 runs the hd-128 layout: TMA fills columns 80-127 of each
    row's second box with zeros, the scores are scaled by 1 / sqrt(80) and
    only columns < 80 are stored.  On those inputs the kernel's arithmetic
    gives the hd-80 output exactly (the zero columns add exact zeros to
    Q K^T, and P V's extra columns are never read), within 2e-5 +
    |plain| / 128 of the f32 oracle."""
    hd, pad = 80, 128
    q, k, v = (_bf16(a) for a in _rand(S + T, (1, 4, S, hd), (1, 2, T, hd), (1, 2, T, hd)))
    q_p, k_p, v_p = (torch.nn.functional.pad(x, (0, pad - hd)) for x in (q, k, v))
    padded = emulate_flash_bf16(q_p, k_p, v_p, scale=1.0 / math.sqrt(hd))
    assert torch.equal(padded[..., hd:], torch.zeros_like(padded[..., hd:]))
    got = padded[..., :hd]
    assert torch.equal(got, emulate_flash_bf16(q, k, v))
    plain = _oracle(ref_fa.attention, q, k, v, causal=True)
    assert _share(got, plain, BF16_RTOL) <= 1.0


# ------------------------------------------------------------ decode split-K
def emulate_decode_split(q, k, v, lengths):
    """The split decode kernel's arithmetic: q [B, H, 1, hd], k/v
    [B, KV, T, hd], lengths [B]; each split, one tile of SPLIT_KEYS keys,
    takes the softmax of its keys below the clamped length, and the
    partials (m, l, acc) merge by their maxima."""
    B, H, _, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    scale = 1.0 / math.sqrt(hd)
    n_split = fa_ops.decode_splits(T)
    out = torch.zeros((B, H, 1, hd))
    for b in range(B):
        n = min(max(int(lengths[b]), 0), T)
        parts = []
        for sp in range(n_split):
            lo, hi = sp * fa_ops.SPLIT_KEYS, min((sp + 1) * fa_ops.SPLIT_KEYS, n)
            if lo >= hi:                    # past the length: an empty partial
                parts.append((torch.full((H, 1), NEG_INF), torch.zeros((H, 1)),
                              torch.zeros((H, hd))))
                continue
            s = torch.einsum("hd,htd->ht", q[b, :, 0], k[b, :, lo:hi]) * scale
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            parts.append((m, p.sum(-1, keepdim=True),
                          torch.einsum("ht,htd->hd", p, v[b, :, lo:hi])))
        if n_split == 1:
            m, l, acc = parts[0]
            out[b, :, 0] = acc / l.clamp_min(1e-30)
            continue
        mx = torch.stack([p[0] for p in parts]).amax(0)
        L = sum(p[1] * torch.exp(p[0] - mx) for p in parts)
        A = sum(p[2] * torch.exp(p[0] - mx) for p in parts)
        out[b, :, 0] = A / L.clamp_min(1e-30)
    return out


@pytest.mark.parametrize("T,lens", [
    (1017, [1016, 1016, 1016, 1016]),
    (1017, [1017, 0, 5, 508]),          # full, zero-length, inside split 0, mid-cache
    (1017, [128, 129, 256, 257]),       # on a split boundary and one past it
    (1017, [64, 65, 192, 1]),
    (1017, [100, 5, 0, 120]),           # splits 2-15 past every length: empty
    (1017, [5000, 1, 640, 641]),        # a length past T clamps to T
    (29, [28, 28, 0, 29]),              # one split: written directly
    (200, [200, 0, 63, 128]),
])
def test_decode_split_merge_matches_the_oracle(T, lens):
    B, H, KV, hd = 4, 8, 2, 64
    q, k, v = (torch.from_numpy(a) for a in _rand(T, (B, H, 1, hd), (B, KV, T, hd),
                                                   (B, KV, T, hd)))
    lengths = np.asarray(lens, np.int32)
    got = emulate_decode_split(q, k, v, lengths)
    plain = _oracle(ref_fa.decode_attention, q, k, v, torch.from_numpy(lengths))
    assert _share(got, plain, 0.0) <= 1.0
    for b, n in enumerate(lens):
        if n == 0:
            assert torch.equal(got[b], torch.zeros_like(got[b]))   # exactly zero


@pytest.mark.parametrize("T,lens", [
    (1017, [1016, 1016, 1016, 1016]),
    (1017, [64, 65, 1024, 0]),          # on a split boundary, one past it, past T, zero
    (29, [28, 0, 5, 40]),               # one split: written directly
])
def test_decode_split_merge_at_hd80_matches_the_oracle(T, lens):
    """zamba2's head dim 80 (G = 1, as its 32/32 heads): the same split and
    merge, each lane's last column guarded in the kernel, against the
    oracle at 2e-5; a zero-length row is exactly zero."""
    B, H, KV, hd = 4, 4, 4, 80
    q, k, v = (torch.from_numpy(a) for a in _rand(T + hd, (B, H, 1, hd), (B, KV, T, hd),
                                                   (B, KV, T, hd)))
    lengths = np.asarray(lens, np.int32)
    got = emulate_decode_split(q, k, v, lengths)
    plain = _oracle(ref_fa.decode_attention, q, k, v, torch.from_numpy(lengths))
    assert _share(got, plain, 0.0) <= 1.0
    for b, n in enumerate(lens):
        if n == 0:
            assert torch.equal(got[b], torch.zeros_like(got[b]))


@pytest.mark.parametrize("T,want", [(1, 1), (29, 1), (64, 1), (65, 2), (200, 4),
                                    (1017, 16), (1024, 16), (1025, 17)])
def test_decode_splits_follow_the_capacity_alone(T, want):
    assert fa_ops.decode_splits(T) == want == math.ceil(T / fa_ops.SPLIT_KEYS)


def test_decode_tickets_are_zeroed_once_and_reused(monkeypatch):
    monkeypatch.setattr(fa_ops, "_TICKETS", {})
    dev = torch.device("cpu")
    t = fa_ops._tickets(dev, 0, 32)
    assert t.dtype == torch.int32 and t.numel() == 32 and not t.any()
    assert fa_ops._tickets(dev, 0, 16) is t            # no new buffer, no memset
    assert fa_ops._tickets(dev, 0, 64).numel() == 64   # grows for a larger B * KV


def test_decode_tickets_are_kept_apart_per_stream(monkeypatch):
    """Two streams may run decode launches at once: each has its own
    counters, so one launch never draws another's ticket."""
    monkeypatch.setattr(fa_ops, "_TICKETS", {})
    dev = torch.device("cpu")
    a, b = fa_ops._tickets(dev, 1, 32), fa_ops._tickets(dev, 2, 32)
    assert a is not b and a.data_ptr() != b.data_ptr()
    assert fa_ops._tickets(dev, 1, 32) is a


# ------------------------------------------------------------ entry points
def _c_params(src, name):
    m = re.search(r'extern "C" int %s\(([^)]*)\)' % name, src)
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("name", sorted(build._SIGNATURES))
def test_ctypes_signature_matches_the_c_prototype(name):
    """Each entry point's ctypes argument list has the C prototype's length
    and kinds: a pointer for each pointer, a 64-bit int for each long long."""
    src = "".join(p.read_text() for p in build._sources()[0])
    params = _c_params(src, name)
    sig = build._SIGNATURES[name]
    assert len(params) == len(sig)
    for p, t in zip(params, sig):
        want = ctypes_kind(p)
        assert t is want, f"{name}: {p} bound as {t}"


def ctypes_kind(param):
    import ctypes
    if "*" in param:
        return ctypes.c_void_p
    if param.startswith("long long"):
        return ctypes.c_longlong
    return ctypes.c_int


@pytest.mark.parametrize("source,entry", [("flash_attention.cu", "flash_attention_fwd"),
                                          ("decode_attention.cu", "decode_attention_fwd")])
def test_every_head_dim_is_dispatched_in_both_dtypes(source, entry):
    """Each head dim the wrapper lets through (HEAD_DIMS) has a branch in
    the entry point's f32 and bf16 dispatch, and no other head dim has one:
    the wrapper's check and the kernels' instantiations agree."""
    src = (build.CSRC / source).read_text()
    body = src[src.index(f'extern "C" int {entry}('):]
    for dtype in ("kF32", "kBF16"):
        branch = re.search(r"if \(dtype == rk::%s\) \{(.*?)return rk::kBadHeadDim;" % dtype,
                           body, re.S).group(1)
        dims = tuple(int(d) for d in re.findall(r"if \(hd == (\d+)\)", branch))
        assert dims == fa_ops.HEAD_DIMS, (source, dtype, dims)


def test_every_error_code_has_a_message():
    hdr = (build.CSRC / "common.cuh").read_text()
    msgs = (build.CSRC / "common.cu").read_text()
    enum = re.search(r"enum ArgError : int \{(.*?)\};", hdr, re.S).group(1)
    codes = re.findall(r"(k\w+) = -\d+", enum)
    assert "kNoDriverEntry" in codes and "kTensorMap" in codes
    for c in codes:
        assert f"case rk::{c}:" in msgs
