"""The arithmetic and host side of the port's Hopper exit-head kernel,
emulated on the CPU and held against the JAX package's oracle and its
Pallas kernel in interpret mode.

No CUDA kernel runs here.  ``csrc/exit_head.cu`` splits the vocab into
``ops.exit_head_plan``'s chunks of whole 128-row tiles, one block each.  In
bf16 a block's two warpgroups compute a tile's scores S^T [64 vocab, N
rows] on the tensor cores (N = 16 for rows <= 16, else 64, in row groups of
N), and each thread folds its accumulator fragment (vocab rows lane/4 and
lane/4 + 8 of its warp's 16, hidden rows 8j + 2 (lane % 4) + {0, 1}) into
one running (m, Z, W, argmax) per hidden row, skipping vocab rows past V
and hidden rows past ``rows``; the 8 lanes that share a hidden row merge by
shuffles, then the 8 warps in order.  In f32 warp w of a block folds the
vocab rows w, w + 8, ... of its chunk, lane r holding row r of a group of
4.  Either way the block that draws the last ticket merges the chunks'
partials: lane l merges its own contiguous run of chunks, then a tree joins
neighbouring runs.  Every merge runs max-first (the maximum M, then the
sums of Z and W rescaled to M in a fixed order, and the least argmax at
M), and the fold keeps the larger score and, on equal scores, the smaller
index, in any order.  The
emulations below walk exactly that, and are held at the f32 exit-head
tolerance of tests/test_kernels.py (1e-5) on bf16-exact inputs.
"""
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.exit_head import ops as ref_eh_ops
from repro.kernels.exit_head import ref as ref_eh
from repro_torch.kernels import build
from repro_torch.kernels.exit_head import ops as eh_ops

TOL = 1e-5
NEG_INF = -1e30
INT_MAX = 2 ** 31 - 1
TILE = eh_ops.TILE


# ------------------------------------------------------------------ plan
@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("V", [1, 17, 1000, 32000, 32001, 49155, 128256, 202112])
def test_plan_covers_the_vocab_once_in_ordered_chunks(V, sms):
    tile, n_chunks = eh_ops.exit_head_plan(V, sms)
    n_tiles = math.ceil(V / tile)
    assert tile == TILE and n_chunks == min(n_tiles, 2 * sms)
    runs = [eh_ops.chunk_tiles(c, V, n_chunks) for c in range(n_chunks)]
    assert runs[0][0] == 0 and runs[-1][1] == n_tiles
    for (_, end), (start, _) in zip(runs, runs[1:]):
        assert end == start                          # contiguous, ascending
    lengths = [t1 - t0 for t0, t1 in runs]
    assert min(lengths) >= 1 and max(lengths) - min(lengths) <= 1
    covered = np.concatenate([np.arange(t0 * tile, min(V, t1 * tile)) for t0, t1 in runs])
    assert np.array_equal(covered, np.arange(V))     # every index once, in order


def test_plan_fills_two_blocks_an_sm_at_the_served_vocabularies():
    """One wave of two blocks on each of the H100's 132 SMs, no tail."""
    assert [eh_ops.exit_head_plan(V, 132)[1] for V in (32000, 128256, 202112)] == [250, 264, 264]


def test_the_wrapper_and_the_kernel_share_the_tile():
    src = (build.CSRC / "exit_head.cu").read_text()
    assert int(re.search(r"constexpr int kTile = (\d+);", src).group(1)) == TILE
    # the same split of tiles into chunks on both sides
    body = re.search(r"void chunk_tiles\(.*?\{(.*?)\n\}", src, re.S).group(1)
    assert "t0 = c * q + min(c, r);" in body and "t1 = t0 + q + (c < r ? 1 : 0);" in body


# ------------------------------------------------------------ emulation
class State:
    """(m, Z, W, argmax) of running states, elementwise over any shape."""

    def __init__(self, m, z, w, a):
        self.m, self.z, self.w, self.a = m, z, w, a

    @classmethod
    def empty(cls, shape):
        return cls(torch.full(shape, NEG_INF), torch.zeros(shape), torch.zeros(shape),
                   torch.full(shape, INT_MAX, dtype=torch.int64))

    def fold(self, s, v, valid):
        """acc_fold of score s at index v where ``valid``: the larger score
        wins the argmax, on equal scores the smaller index."""
        m = torch.maximum(self.m, s)
        cx, cs = torch.exp(self.m - m), torch.exp(s - m)
        take = (s > self.m) | ((s == self.m) & (v < self.a))
        new = (m, self.z * cx + cs, self.w * cx + s * cs, torch.where(take, v, self.a))
        return State(*(torch.where(valid, n, x) for n, x in
                       zip(new, (self.m, self.z, self.w, self.a))))

    def max_first(self, dim, tree=False):
        """Merge along ``dim``: the maximum M first, then the sums Z e^(m - M)
        and W e^(m - M) in index order (``tree``: pairwise, neighbours first,
        as a shuffle butterfly), and the least argmax among the states whose
        maximum is M."""
        M = self.m.amax(dim, keepdim=True)
        e = torch.exp(self.m - M)
        z, w = self.z * e, self.w * e
        if tree:
            while z.shape[dim] > 1:
                z = z.unflatten(dim, (-1, 2)).sum(dim + 1)
                w = w.unflatten(dim, (-1, 2)).sum(dim + 1)
        else:
            z = z.cumsum(dim).narrow(dim, z.shape[dim] - 1, 1)
            w = w.cumsum(dim).narrow(dim, w.shape[dim] - 1, 1)
        a = torch.where(self.m == M, self.a, INT_MAX).amin(dim, keepdim=True)
        return State(*(t.squeeze(dim) for t in (M, z, w, a)))


def _ticket_merge(parts):
    """parts: State [rows, n_chunks] -> State [rows].  Lane l merges chunks
    [l per, (l + 1) per) in order, per = ceil(n / 32), then a butterfly
    joins the 32 lanes."""
    rows, n = parts.m.shape
    pad = 32 * -(-n // 32) - n
    lanes = State(*(torch.nn.functional.pad(t, (0, pad), value=fill).view(rows, 32, -1)
                    for t, fill in ((parts.m, NEG_INF), (parts.z, 0.0), (parts.w, 0.0),
                                    (parts.a, INT_MAX))))
    return lanes.max_first(2).max_first(1, tree=True)


def _finish(st):
    z = st.z.clamp_min(1e-30)
    return {"token": st.a.to(torch.int32), "conf": 1.0 / z,
            "entropy": st.m + torch.log(z) - st.w / z}


def _chunk_bf16(h, emb_p, V, t0, t1, nrows, mask_tail=True):
    """One bf16 block: h [N, D] (zero past nrows), tiles [t0, t1) of the
    zero-padded table -> State [N], hidden row n's partial."""
    N = h.shape[0]
    n = torch.arange(N)
    # thread (warpgroup g, warp w, lane / 4 = lr) of the tile's 128 vocab
    # rows g 64 + w 16 + h8 8 + lr; lane % 4 picks which hidden rows
    st = State.empty((2, 4, 8, N))
    for t in range(t0, t1):
        s = (emb_p[t * TILE:(t + 1) * TILE] @ h.T).view(2, 4, 2, 8, N)
        v = (t * TILE + torch.arange(TILE)).view(2, 4, 2, 8, 1).expand(2, 4, 2, 8, N)
        for h8 in (0, 1):
            vv = v[:, :, h8]
            ok = (n < nrows) & ((vv < V) if mask_tail else torch.ones_like(vv, dtype=bool))
            st = st.fold(s[:, :, h8], vv, ok)
    st = st.max_first(2, tree=True)      # lanes xor 4, 8, 16: lr bits 0, 1, 2
    return State(*(x.reshape(8, N) for x in (st.m, st.z, st.w, st.a))).max_first(0)


def _chunk_f32(h, emb, V, t0, t1, nrows):
    """One f32 block: warp w folds vocab rows v0 + w, v0 + w + 8, ... in
    order, lane r row r; then the 8 warps in order."""
    R = h.shape[0]
    v0, v1 = t0 * TILE, min(V, t1 * TILE)
    st = State.empty((8, R))
    ok = (torch.arange(R) < nrows).expand(8, R)
    for i0 in range(v0, v1, 8):
        v = torch.arange(i0, i0 + 8)
        live = v < v1
        s = emb[v.clamp_max(V - 1)] @ h.T
        st = st.fold(s, v[:, None].expand(8, R), ok & live[:, None])
    return st.max_first(0)


def emulate(h, emb, sms, path="bf16", mask_tail=True):
    """The kernel's arithmetic on h [rows, D], emb [V, D] (f32 tensors
    holding the kernel's inputs) on a card of ``sms`` SMs."""
    rows, D = h.shape
    V = emb.shape[0]
    _, n_chunks = eh_ops.exit_head_plan(V, sms)
    N = (16 if rows <= 16 else 64) if path == "bf16" else 4
    n_groups = -(-rows // N)
    h_p = torch.nn.functional.pad(h, (0, 0, 0, n_groups * N - rows))
    emb_p = torch.nn.functional.pad(emb, (0, 0, 0, -(-V // TILE) * TILE - V))
    out = []
    for g in range(n_groups):
        hg, nrows = h_p[g * N:(g + 1) * N], min(N, rows - g * N)
        parts = []
        for c in range(n_chunks):
            t0, t1 = eh_ops.chunk_tiles(c, V, n_chunks)
            parts.append(_chunk_bf16(hg, emb_p, V, t0, t1, nrows, mask_tail)
                         if path == "bf16" else _chunk_f32(hg, emb, V, t0, t1, nrows))
        st = State(*(torch.stack([getattr(p, k) for p in parts], 1)[:nrows]
                     for k in ("m", "z", "w", "a")))
        out.append(_finish(_ticket_merge(st)))
    return {k: torch.cat([o[k] for o in out]) for k in out[0]}


# ------------------------------------------------------------ against JAX
def _bf16_exact(a):
    return torch.from_numpy(a).to(torch.bfloat16).float()


_ORACLES = {}


def _oracles(key, h, emb):
    """The JAX oracle and the Pallas kernel in interpret mode on [1, rows, D]."""
    if key not in _ORACLES:
        hj, ej = jnp.asarray(h.numpy())[None], jnp.asarray(emb.numpy())
        _ORACLES[key] = (ref_eh.exit_confidence(hj, ej),
                         ref_eh_ops.exit_confidence(hj, ej, tile_rows=8, tile_v=128))
    return _ORACLES[key]


def _held(got, key, h, emb):
    for want in _oracles(key, h, emb):
        assert got["token"].tolist() == np.asarray(want["token"])[0].tolist()
        for k in ("conf", "entropy"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k])[0],
                                       rtol=TOL, atol=TOL)


@pytest.mark.parametrize("path", ["bf16", "f32"])
@pytest.mark.parametrize("rows", [1, 7, 16, 17, 64, 65])
def test_emulation_matches_the_oracle_across_row_counts(rows, path):
    """Rows 1-16 run one m64n16 group, 17-64 one m64n64 group and 65 two
    groups (bf16); groups of 4 in f32.  A ragged vocab (1000 = 7 tiles +
    104) over 4 chunks (2 SMs)."""
    D, V = 64, 1000
    rng = np.random.default_rng(rows)
    h = _bf16_exact(rng.standard_normal((rows, D)).astype(np.float32))
    emb = _bf16_exact((rng.standard_normal((V, D)) / 4).astype(np.float32))
    _held(emulate(h, emb, sms=2, path=path), ("rows", rows), h, emb)


TIES = {
    # (first, second) vocab rows of an exact tie, V 1000 in 4 chunks of 2 tiles
    "inside a slab": (5, 6),             # neighbouring lanes of one warp
    "across fragment halves": (6, 13),   # 13 sits in the lane before 6's, as its row + 8
    "across warps": (5, 21),
    "across warpgroups": (5, 69),
    "across tiles": (5, 133),
    "at a chunk boundary": (255, 256),   # the last row of chunk 0, the first of chunk 1
    "across chunks": (5, 900),
}


@pytest.mark.parametrize("path", ["bf16", "f32"])
@pytest.mark.parametrize("where", list(TIES))
def test_ties_go_to_the_first_index(where, path):
    """Integer-valued rows, so every dot product is exact in any order: row
    0's maximum is a tie between two vocab rows, which the first wins; row
    1 has its own maximum."""
    first, second = TIES[where]
    D, V, sms = 16, 1000, 2
    assert eh_ops.chunk_tiles(1, V, eh_ops.exit_head_plan(V, sms)[1])[0] * TILE == 256
    rng = np.random.default_rng(0)
    emb = rng.integers(-3, 4, (V, D)).astype(np.float32)
    emb[first] = emb[second] = 3.0
    emb[700] = np.r_[np.full(D // 2, 3.0), np.full(D // 2, -3.0)]
    h = np.ones((2, D), np.float32)
    h[1, D // 2:] = -1.0
    h, emb = torch.from_numpy(h), torch.from_numpy(emb)
    got = emulate(h, emb, sms=sms, path=path)
    assert got["token"].tolist() == [first, 700]
    _held(got, ("tie", where), h, emb)


@pytest.mark.parametrize("path", ["bf16", "f32"])
def test_all_negative_logits_with_a_ragged_tail(path):
    """Every logit negative, V = 777 (6 tiles + 9): a zero-filled row past V
    would score 0 and win; the mask keeps it out."""
    D, V, rows = 64, 777, 5
    rng = np.random.default_rng(5)
    h = _bf16_exact(np.abs(rng.standard_normal((rows, D))).astype(np.float32))
    emb = _bf16_exact(-np.abs(rng.standard_normal((V, D)) / 8).astype(np.float32))
    got = emulate(h, emb, sms=2, path=path)
    assert (got["token"] < V).all()
    _held(got, "negative", h, emb)


def test_an_unmasked_tail_would_win_the_all_negative_case():
    """Why the tail is masked: without it the emulation picks a padded row."""
    D, V = 64, 777
    rng = np.random.default_rng(5)
    h = _bf16_exact(np.abs(rng.standard_normal((3, D))).astype(np.float32))
    emb = _bf16_exact(-np.abs(rng.standard_normal((V, D)) / 8).astype(np.float32))
    got = emulate(h, emb, sms=2, mask_tail=False)
    assert (got["token"] >= V).all()


def test_the_kernel_path_is_deterministic_and_sm_count_free():
    """The merge order is fixed by the plan: the same inputs give the same
    bits, and other SM counts (other chunkings) stay within tolerance."""
    D, V, rows = 64, 1000, 4
    rng = np.random.default_rng(11)
    h = _bf16_exact(rng.standard_normal((rows, D)).astype(np.float32))
    emb = _bf16_exact((rng.standard_normal((V, D)) / 4).astype(np.float32))
    a, b = emulate(h, emb, sms=3), emulate(h, emb, sms=3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    for sms in (1, 132):
        other = emulate(h, emb, sms=sms)
        assert torch.equal(other["token"], a["token"])
        for k in ("conf", "entropy"):
            torch.testing.assert_close(other[k], a[k], rtol=TOL, atol=TOL)


def test_tickets_are_zeroed_once_and_kept_apart_per_stream(monkeypatch):
    monkeypatch.setattr(eh_ops, "_TICKETS", {})
    dev = torch.device("cpu")
    t = eh_ops._tickets(dev, 0, 16)
    assert t.dtype == torch.int32 and t.numel() == 16 and not t.any()
    assert eh_ops._tickets(dev, 0, 4) is t               # no new buffer, no memset
    assert eh_ops._tickets(dev, 0, 65).numel() == 65     # grows for more rows
    assert eh_ops._tickets(dev, 1, 4) is not eh_ops._tickets(dev, 0, 4)
