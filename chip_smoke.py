#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card and the CUDA
toolkit (``nvcc``).  It imports nothing of JAX or of the JAX package: it
puts ``src`` on ``sys.path`` and uses ``repro_torch`` alone.  Phases, in
order; any failure exits non-zero:

1. device: the card's name, ``nvidia-smi``'s name and power limit, the torch
   and CUDA versions;
2. build: the port's CUDA kernels, compiled by ``nvcc`` from
   ``src/repro_torch/kernels/csrc`` into ``build/``, with no wgmma
   serialised by ptxas (warning C7514);
3. kernel checks: each kernel against its plain PyTorch version on the card
   at the main paths' full-width shapes, in bfloat16 and float32, with the
   edge cases (a ragged prefill tile, T > S prefill, a zero-length decode
   row, decode lengths on a key-split boundary, one past it and past T, and
   splits past every length, vocab ties;
   for the SSM scan both modes, rwkv6-3b's prefill and decode shapes from a
   non-zero state, zamba2-2.7b's Mamba-2 shapes read through stride-0
   broadcasts, chunk edges, the served model's weak decay and log_w = -8
   everywhere); then each kernel timed with CUDA
   events beside its plain version, one library call for the same function
   where there is one, and its bound on the card (attention also at the
   short serving shapes, S 12 and T 29);
4. serve llama3.2-1b: full width in bfloat16 through ``ServingEngine.serve``
   (Edgent plan, prefill, right-sized decode, exit-head token) with every
   launch counter at zero before and its kernels' above zero after;
5. kernel path against plain path for llama3.2-1b: the same parameters in
   float32, served once through the kernels and once through the dense
   attention and the plain exit head, for a 12-token batch at the full exit
   and for phase 4's 1000-token batch, which deadline demotion decodes at
   earlier exits;
6. serve rwkv6-3b: full width and depth in bfloat16, every layer's scan
   through an SSM scan kernel (its 1000-token prefill through the chunked
   tensor-core kernel, which the per-kernel count shows) and every token
   through the exit head, the counters as in phase 4;
7. kernel path against plain path for rwkv6-3b, as phase 5 (the plain
   path is the reference's scan dispatch and the plain exit head), held
   launch by launch: every scan launch and every token of the served float32
   kernel path against the plain version on the same inputs.  The
   end-to-end distances are logged beside those of the plain path from the
   same path with a float64 scan (see END_TO_END).

The line before the last is the JSON record of every kernel; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside the
repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

LLAMA, RWKV = "llama3.2-1b", "rwkv6-3b"
BATCH = 4
NEW_TOKENS = 16
SHORT_PROMPT, LONG_PROMPT = 12, 1000
SHORT_SLO = 0.4
# The long prompts' SLO: their 1000-token prefill nearly spends it in the
# latency model's virtual time, so EDF serves them first and deadline
# demotion decodes them at earlier exits (llama3.2-1b: exits 2-4; rwkv6-3b:
# exits 2-3), and the right-sized model runs on the card beside the full one.
LONG_SLO = {LLAMA: 0.031, RWKV: 0.068}
# the kernels each served model's main path must launch
PATH_KERNELS = {LLAMA: ("flash_attention", "decode_attention", "exit_confidence"),
                RWKV: ("ssm_scan", "exit_confidence")}
# stated tolerances:
#  * attention: the kernel against its plain version computed in float32
#    from the same inputs (widened, never rounded on the plain side), at
#    |kernel - plain| <= ATTN_ATOL + ATTN_RTOL[dtype] * |plain| element by
#    element.  ATTN_ATOL is the float32 tolerance of the reference's kernel
#    tests; a bfloat16 kernel also computes in float32 and rounds once, at
#    its output, which moves a value by at most half a bfloat16 ulp
#    (|x| / 256): ATTN_RTOL allows one ulp, |x| / 128;
#  * exit head: both sides compute in float32 (the kernel reads bfloat16 and
#    widens it, as the Pallas kernel does, so its plain version is given the
#    same values widened); conf and entropy are sums over 128256 terms taken
#    in another order: 1e-5 on conf, 1e-4 relative on entropy.  A token may
#    differ only where the plain top-2 logit margin is below MARGIN_TOL.
ATTN_ATOL = 2e-5
ATTN_RTOL = {"torch.float32": 0.0, "torch.bfloat16": 2.0 ** -7}
CONF_TOL, ENT_RTOL, MARGIN_TOL = 1e-5, 1e-4, 1e-4
#  * SSM scan: both sides compute in float32 from the same inputs (the plain
#    version is given them widened), the kernel rounds once, at its bfloat16
#    output; |kernel - plain| <= SCAN_ATOL + ATTN_RTOL[dtype] * |plain|, with
#    SCAN_ATOL the reference's scan test tolerance; the final state is float32
#    on both sides and held at SCAN_ATOL + |plain| * 2^-20 (a few float32
#    roundings of the running sum).
SCAN_ATOL = 3e-4
STATE_RTOL = 2.0 ** -20
# phase 5: float32 hidden states of the kernel path against the plain path,
# after 16 layers whose attention sums in another order
HIDDEN_TOL = 1e-4
# phase 7 holds each scan launch of the served float32 kernel path against
# the plain scan on the same inputs.  The model's decay is weak (w near
# 0.9975), so a state sums up to 1000 outer products far larger than the
# result: allowed is SCAN_ATOL + 2 n F32_UNIT sum|terms|, twice the forward
# error bound of an n-term float32 accumulation (n = S + dk + 2 for o, S + 2
# for the state), sum|terms| being the plain scan of the inputs' absolute
# values.
F32_UNIT = 2.0 ** -24
# phase 7 holds rwkv6-3b's kernel path against the plain path launch by
# launch, not end to end: with random weights its stack amplifies float32
# rounding (a head whose scan output barely varies over its 64 channels is
# divided by that spread in the group norm), so that the plain path itself
# ends more than HIDDEN_TOL from the same path with a float64 scan.  Its
# end-to-end distances are measured and logged (PERF.md, PR 12).
END_TO_END = {LLAMA: True, RWKV: False}
TIMED_RUNS, WARMUP_RUNS = 20, 3
L2_FLUSH_BYTES = 256 * 2**20          # > the H100's 50 MB L2
SPIN_CYCLES = 2_000_000               # ~1 ms at the H100's clock
HOST_CALLS, HOST_REPEATS = 50, 20


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------- timing
class Timer:
    """Median time of a callable on the card with CUDA events.  Each timed
    run starts with a cold L2 (a 256 MB buffer is written first), as the
    main path finds it: between two calls of a kernel the model streams far
    more than 50 MB of weights.  Each is then queued behind a spin of
    SPIN_CYCLES on the card, so that the host has queued the launch before
    the start event fires: otherwise a slow host's launch overhead counts
    as device time for a short kernel (PERF.md, section 6).  A kernel is
    also timed without the spin, and its wrapper's host time per call is
    read on the host's clock, so that a host cost the spin hides still
    shows."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def ms(self, fn, spin=True):
        torch = self.torch
        for _ in range(WARMUP_RUNS):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(TIMED_RUNS):
            self.flush.zero_()
            if spin:
                torch.cuda._sleep(SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    def host_us(self, fn):
        """Host time of one call in microseconds: the least, over
        HOST_REPEATS batches, of HOST_CALLS back-to-back calls' wall time
        over HOST_CALLS (the launches queue on the card meanwhile).  Other
        work on the host only adds to a batch, so the least batch is the
        call's own cost."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        per_call = []
        for _ in range(HOST_REPEATS):
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            per_call.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
            torch.cuda.synchronize()
        return min(per_call)

    def kernel(self, fn):
        """A kernel wrapper's times: behind the spin (``ms``), without it
        (``ms_unspun``), and on the host (``host_us``)."""
        return dict(ms=self.ms(fn), ms_unspun=self.ms(fn, spin=False),
                    host_us=self.host_us(fn))


def bound(nbytes, flops, dtype, cfgmod):
    """The least time the card could take: bytes over the HBM rate or
    operations over the peak rate for the inputs' type, the larger."""
    import torch
    peak = cfgmod.PEAK_FLOPS_BF16 if dtype == torch.bfloat16 else cfgmod.PEAK_FLOPS_F32
    t_bytes, t_ops = nbytes / cfgmod.HBM_BW, flops / peak
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def distinct_bytes(t):
    """Bytes of the distinct elements of ``t``: a stride-0 broadcast is one
    read of its source."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


# ---------------------------------------------------------------- phase 3
def kernel_checks(torch, timer):
    import torch.nn.functional as F

    import repro_torch.config as C
    from repro_torch.configs import get_config
    from repro_torch.kernels.exit_head import ops as eh_ops
    from repro_torch.kernels.exit_head import ref as eh_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    cfg = get_config(LLAMA)
    H, KV, hd, D, V = cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_model, cfg.padded_vocab
    gen = torch.Generator(device="cuda").manual_seed(1234)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
        return (x * scale).to(dtype)

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    def attn_err(out, plain32, dt):
        """max |kernel - plain| over the output, and the largest share of
        the allowed error (ATTN_ATOL + ATTN_RTOL * |plain|) any element
        takes; ``plain32`` is the plain version in float32."""
        diff = (out.float() - plain32).abs()
        allowed = ATTN_ATOL + ATTN_RTOL[str(dt)] * plain32.abs()
        return diff.max().item(), (diff / allowed).max().item()

    def tol_text(dt):
        return f"allowed {ATTN_ATOL} + {ATTN_RTOL[str(dt)]:.4g} |plain f32|"

    record = {}

    # -- prefill flash attention: S 12 and 1000 (both ragged against the
    #    64- and 128-row tiles), a head dim of 128, and T > S (the causal
    #    diagonal aligned bottom-right) at both head dims
    short = {}
    for dt in (torch.bfloat16, torch.float32):
        for B, S, Tk, h, kv, d in ((BATCH, SHORT_PROMPT, SHORT_PROMPT, H, KV, hd),
                                   (BATCH, LONG_PROMPT, LONG_PROMPT, H, KV, hd),
                                   (2, 77, 77, 4, 2, 128),
                                   (2, 100, 300, 4, 2, 64),
                                   (2, 100, 300, 4, 2, 128)):
            q, k, v = randn(B, S, h, d, dtype=dt), randn(B, Tk, kv, d, dtype=dt), \
                randn(B, Tk, kv, d, dtype=dt)
            out = fa_ops.flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            plain = fa_ref.attention(qt.float(), kt.float(), vt.float(),
                                     causal=True).transpose(1, 2)
            e, share = attn_err(out, plain, dt)
            log(f"check flash_attention {dt} B{B} S{S} T{Tk} H{h} KV{kv} hd{d}: "
                f"max_abs_err {e:.3g}, worst err/allowed {share:.3g} ({tol_text(dt)})")
            require(torch.isfinite(out).all().item(), "flash_attention: non-finite output")
            require(share <= 1.0, f"flash_attention {dt} S{S} hd{d} disagrees: "
                    f"{share} of the allowed error")
            if dt == torch.bfloat16 and h == H and d == hd and S == Tk:
                qc, kc, vc = (x.transpose(1, 2).contiguous() for x in (q, k, v))
                t = dict(
                    **timer.kernel(lambda: fa_ops.flash_attention(q, k, v, causal=True)),
                    plain_ms=timer.ms(lambda: fa_ref.attention(qt, kt, vt, causal=True)),
                    library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                        qc, kc, vc, is_causal=True, enable_gqa=True)))
                elt = q.element_size()
                nbytes = (2 * q.numel() + k.numel() + v.numel()) * elt
                flops = 4 * B * h * d * S * (S + 1) // 2     # QK^T and PV, causal half
                t["bound_ms"], t["bound_by"] = bound(nbytes, flops, dt, C)
                t.update(max_abs_err=e, err_share=share,
                         shape=f"B{B} S{S} H{h} KV{kv} hd{d}", dtype=str(dt))
                log(f"time flash_attention {t}")
                if S == LONG_PROMPT:
                    record["flash_attention"] = t
                else:
                    short["flash_attention"] = t

    # -- decode attention: the serving caches (T = 1000 + 16 + 1 and 12 + 16
    #    + 1, the short one 544 of the 635 served launches), read in place
    #    through a view of a [n_units, B, T, KV, hd] segment cache; the keys
    #    are split in blocks of SPLIT_KEYS: lengths on a split boundary, one
    #    past it, and splits past every length (empty partials)
    T = LONG_PROMPT + NEW_TOKENS + 1
    T_SHORT = SHORT_PROMPT + NEW_TOKENS + 1
    SK = fa_ops.SPLIT_KEYS
    for dt in (torch.bfloat16, torch.float32):
        for B, Tc, h, kv, d, lens in ((BATCH, T, H, KV, hd, [T - 1] * BATCH),
                                      (BATCH, T, H, KV, hd, [T, 0, 5, T // 2]),
                                      (3, 200, 4, 1, 128, [200, 0, 63]),
                                      (BATCH, T, H, KV, hd, [SK, 2 * SK, 5 * SK, 1]),
                                      (BATCH, T, H, KV, hd, [SK + 1, 2 * SK + 1, 5 * SK + 1,
                                                             T + 7]),
                                      (BATCH, T, H, KV, hd, [SK - 28, 5, 0, SK]),
                                      (BATCH, T_SHORT, H, KV, hd, [T_SHORT - 1] * BATCH)):
            ck, cv = randn(2, B, Tc, kv, d, dtype=dt), randn(2, B, Tc, kv, d, dtype=dt)
            q = randn(B, 1, h, d, dtype=dt)
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            out = fa_ops.decode_attention(q, ck[1], cv[1], lengths)
            torch.cuda.synchronize()
            qt, kt, vt = q.transpose(1, 2), ck[1].transpose(1, 2), cv[1].transpose(1, 2)
            plain = fa_ref.decode_attention(qt.float(), kt.float(), vt.float(),
                                            lengths).transpose(1, 2)
            e, share = attn_err(out, plain, dt)
            log(f"check decode_attention {dt} B{B} T{Tc} H{h} KV{kv} hd{d} "
                f"lengths {lens}: max_abs_err {e:.3g}, worst err/allowed {share:.3g} "
                f"({tol_text(dt)})")
            require(torch.isfinite(out).all().item(), "decode_attention: non-finite output")
            require(share <= 1.0, f"decode_attention {dt} lengths {lens} disagrees: "
                    f"{share} of the allowed error")
            if 0 in lens:
                z = out[lens.index(0)].abs().max().item()
                require(z == 0.0, f"decode_attention: zero-length row is not zero ({z})")
            if dt == torch.bfloat16 and lens == [Tc - 1] * BATCH:
                qc, kc, vc = (x.contiguous() for x in (qt, kt, vt))
                valid = (torch.arange(Tc, device="cuda")[None, :] < lengths[:, None])
                mask = valid[:, None, None, :]
                t = dict(
                    **timer.kernel(lambda: fa_ops.decode_attention(q, ck[1], cv[1], lengths)),
                    plain_ms=timer.ms(lambda: fa_ref.decode_attention(qt, kt, vt, lengths)),
                    library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                        qc, kc, vc, attn_mask=mask, enable_gqa=True)))
                elt = q.element_size()
                n_keys = sum(lens)
                nbytes = (2 * q.numel() + 2 * n_keys * kv * d) * elt + 4 * B
                flops = 4 * h * d * n_keys
                t["bound_ms"], t["bound_by"] = bound(nbytes, flops, dt, C)
                t.update(max_abs_err=e, err_share=share,
                         shape=f"B{B} T{Tc} H{h} KV{kv} hd{d} lengths {lens[0]}",
                         dtype=str(dt))
                log(f"time decode_attention {t}")
                if Tc == T:
                    record["decode_attention"] = t
                else:
                    short["decode_attention"] = t
    log("time at the short serving shapes: " + "; ".join(
        f"{name} {t['shape']}: kernel {t['ms']} ms ({t['ms_unspun']} ms unspun, "
        f"{t['host_us']} us on the host), library {t['library_ms']} ms, "
        f"bound {t['bound_ms']} ms" for name, t in short.items()))

    # -- exit head: the main path's rows against the full tied embedding,
    #    with exact ties across chunks and warps, and a ragged small vocab
    def margins(logits):
        top2 = logits.topk(2, dim=-1).values
        return (top2[..., 0] - top2[..., 1])

    for dt in (torch.bfloat16, torch.float32):
        for rows, d, vv in ((BATCH, D, V), (7, 64, 1000)):
            h = randn(1, rows, d, dtype=dt)
            emb = randn(vv, d, dtype=dt, scale=1.0 / math.sqrt(d))
            emb[6] = emb[5]                      # same chunk, neighbouring warps
            emb[vv - 100] = emb[5]               # a chunk near the end
            h[0, 0] = emb[5].float().mul(40.0).to(dt)   # row 0's maximum: a 3-way tie
            got = eh_ops.exit_confidence(h, emb)
            torch.cuda.synchronize()
            hf, ef = h.float(), emb.float()
            plain = eh_ref.exit_confidence(hf, ef)
            require(got["token"][0, 0].item() == 5,
                    f"exit head: tie went to {got['token'][0, 0].item()}, not 5")
            diff = (got["token"] != plain["token"]).nonzero().tolist()
            if diff:
                m = margins(torch.einsum("bsd,vd->bsv", hf, ef))
                for b, s in diff:
                    log(f"exit head token flip row {s}: kernel {got['token'][b, s].item()} "
                        f"plain {plain['token'][b, s].item()} margin {m[b, s].item():.3g}")
                    require(m[b, s].item() < MARGIN_TOL, "exit head: token differs "
                            "where the plain margin is above tolerance")
            ec = err(got["conf"], plain["conf"])
            ee = ((got["entropy"] - plain["entropy"]).abs()
                  / plain["entropy"].abs().clamp_min(1.0)).max().item()
            log(f"check exit_confidence {dt} rows{rows} D{d} V{vv}: tokens equal "
                f"{not diff}, conf err {ec:.3g} (tol {CONF_TOL}), entropy rel err "
                f"{ee:.3g} (tol {ENT_RTOL})")
            require(ec <= CONF_TOL and ee <= ENT_RTOL, f"exit head {dt} V{vv} disagrees")
            if dt == torch.bfloat16 and vv == V:
                h2 = h.reshape(rows, d)

                def library():
                    logits = (h2 @ emb.T).float()
                    lse = torch.logsumexp(logits, -1)
                    p = torch.softmax(logits, -1)
                    return logits.argmax(-1), torch.exp(logits.max(-1).values - lse), \
                        lse - (p * logits).sum(-1)

                t = dict(**timer.kernel(lambda: eh_ops.exit_confidence(h, emb)),
                         plain_ms=timer.ms(lambda: eh_ref.exit_confidence(h, emb)),
                         library_ms=timer.ms(library))
                nbytes = (h.numel() + emb.numel()) * h.element_size() + 12 * rows
                flops = 2 * rows * vv * d
                t["bound_ms"], t["bound_by"] = bound(nbytes, flops, dt, C)
                t.update(max_abs_err=max(ec, err(got["entropy"], plain["entropy"])),
                         shape=f"rows{rows} D{d} V{vv}",
                         dtype=str(dt))
                log(f"time exit_confidence {t}")
                record["exit_confidence"] = t
    record["ssm_scan"] = scan_checks(torch, timer, randn)
    return record


def scan_checks(torch, timer, randn):
    """The SSM scan kernels against their plain version, in both modes, at
    rwkv6-3b's prefill (S 12, and S 1000, ragged against any power-of-two
    tile) and decode (S 1, from a non-zero state) shapes and zamba2-2.7b's
    Mamba-2 shapes (and the Mamba-2 mode with a per-channel decay); at the
    chunk edges S 16, 17, 64 and 65; with random
    decay (w near 0.37 on average), the served model's weak decay
    (log_w = -exp(-6 + 0.5 randn), w near 0.9975, so that the state sums
    rounding over all 1000 tokens) and log_w = -8 everywhere.  Each case
    logs the kernel the wrapper chose.  Then timed at rwkv6-3b's S 1000
    prefill (the record), S 1 decode and the Mamba-2 shapes."""
    import repro_torch.config as C
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan import ops as ss_ops
    from repro_torch.kernels.ssm_scan import ref as ss_ref
    from repro_torch.models import mamba2 as M2

    rc, zc = get_config(RWKV), get_config("zamba2-2.7b")
    H, hd = rc.num_heads, rc.hd
    Hm, N = M2.n_heads(zc), zc.ssm_state

    def log_decay(decay, *shape):
        if decay == "strong":
            return torch.full(shape, -8.0, device="cuda")
        if decay == "weak":
            return -torch.exp(randn(*shape, scale=0.5) - 6.0)
        return -torch.exp(randn(*shape, scale=0.5))

    def rwkv_inputs(dt, S, decay):
        q, k, v = (randn(BATCH, S, H, hd, dtype=dt) for _ in range(3))
        lw = log_decay(decay, BATCH, S, H, hd)
        return q, k, v, lw, randn(BATCH, H, hd, hd, scale=0.1), randn(H, hd, scale=0.1)

    def mamba_inputs(dt, S, decay):
        # as mamba2.block builds them: C and B broadcast over the heads, the
        # per-head decay over the state channels (stride-0 views)
        bc, cc = randn(BATCH, S, N, dtype=dt), randn(BATCH, S, N, dtype=dt)
        lw = log_decay(decay, BATCH, S, Hm)
        return (cc[:, :, None].expand(BATCH, S, Hm, N), bc[:, :, None].expand(BATCH, S, Hm, N),
                randn(BATCH, S, Hm, M2.DH, dtype=dt), lw[..., None].expand(BATCH, S, Hm, N),
                randn(BATCH, Hm, N, M2.DH, scale=0.1), None)

    def mamba_channel_inputs(dt, S, decay):
        # the Mamba-2 mode with a per-channel decay (the RWKV kernel's layout)
        q, k, v, lw, s0, u = mamba_inputs(dt, S, decay)
        return q, k, v, lw.contiguous(), s0, u

    def bound_of(args, o, s_out, dt):
        q, k, v, lw, s0, u = args
        nbytes = sum(distinct_bytes(t) for t in (q, k, v, lw, s0, o, s_out)) \
            + (0 if u is None else distinct_bytes(u))
        B, S, Hh, dk = q.shape
        flops = 6 * B * Hh * S * dk * v.shape[-1]       # decay, outer product, readout
        return bound(nbytes, flops, dt, C)

    out = None
    for dt in (torch.bfloat16, torch.float32):
        for label, make, S, decay in (("rwkv", rwkv_inputs, SHORT_PROMPT, "random"),
                                      ("rwkv", rwkv_inputs, LONG_PROMPT, "random"),
                                      ("rwkv", rwkv_inputs, 1, "random"),
                                      ("mamba2", mamba_inputs, LONG_PROMPT, "random"),
                                      ("rwkv", rwkv_inputs, LONG_PROMPT, "strong"),
                                      ("mamba2", mamba_inputs, LONG_PROMPT, "strong"),
                                      ("rwkv", rwkv_inputs, LONG_PROMPT, "weak"),
                                      ("mamba2", mamba_inputs, LONG_PROMPT, "weak"),
                                      ("mamba2 per-channel decay", mamba_channel_inputs,
                                       LONG_PROMPT, "weak"),
                                      ("rwkv", rwkv_inputs, 16, "random"),
                                      ("mamba2", mamba_inputs, 17, "random"),
                                      ("rwkv", rwkv_inputs, 64, "random"),
                                      ("rwkv", rwkv_inputs, 65, "weak"),
                                      ("mamba2", mamba_inputs, 64, "weak"),
                                      ("mamba2", mamba_inputs, 65, "random")):
            args = make(dt, S, decay)
            q, k, v, lw, s0, u = args
            before = dict(ss_ops.LAUNCHES)
            o, s_out = ss_ops.ssm_scan(*args)
            torch.cuda.synchronize()
            kind = [n for n in ("chunked", "stepped")
                    if ss_ops.LAUNCHES[f"ssm_scan.{n}"] > before[f"ssm_scan.{n}"]]
            require(kind == [ss_ops.route(q, v)], f"ssm_scan ran {kind}, "
                    f"not the routed {ss_ops.route(q, v)}")
            po, ps = ss_ref.ssm_scan(q.float(), k.float(), v.float(), lw, s0, u=u)
            require(torch.isfinite(po).all().item() and torch.isfinite(ps).all().item(),
                    f"ssm_scan plain version non-finite ({label} S{S} decay {decay})")
            require(torch.isfinite(o.float()).all().item()
                    and torch.isfinite(s_out).all().item(),
                    f"ssm_scan {label} {dt} S{S}: non-finite kernel output")
            diff = (o.float() - po).abs()
            share = (diff / (SCAN_ATOL + ATTN_RTOL[str(dt)] * po.abs())).max().item()
            sdiff = (s_out - ps).abs()
            sshare = (sdiff / (SCAN_ATOL + STATE_RTOL * ps.abs())).max().item()
            shape = (f"{label} B{q.shape[0]} S{S} H{q.shape[2]} dk{q.shape[3]} "
                     f"dv{v.shape[-1]}" + {"strong": " log_w -8", "weak": " weak decay",
                                           "random": ""}[decay])
            e = diff.max().item()
            log(f"check ssm_scan {dt} {shape} ({kind[0]}): o max_abs_err {e:.3g}, worst err/allowed "
                f"{share:.3g} (allowed {SCAN_ATOL} + {ATTN_RTOL[str(dt)]:.4g} |plain f32|); "
                f"state max_abs_err {sdiff.max().item():.3g}, worst {sshare:.3g}")
            require(share <= 1.0 and sshare <= 1.0,
                    f"ssm_scan {dt} {shape} disagrees: {share} / {sshare} of the allowed error")
            if dt == torch.bfloat16 and decay == "random" and S in (1, LONG_PROMPT):
                t = dict(**timer.kernel(lambda: ss_ops.ssm_scan(*args)),
                         plain_ms=timer.ms(lambda: ss_ref.ssm_scan(*args)),
                         library_ms=None)
                t["bound_ms"], t["bound_by"] = bound_of(args, o, s_out, dt)
                t.update(max_abs_err=e, err_share=share, shape=shape, dtype=str(dt))
                log(f"time ssm_scan {t}")
                if label == "rwkv" and S == LONG_PROMPT:
                    out = t
    return out


# ---------------------------------------------------------------- phases 4-7
def serving_setup(arch):
    from repro_torch.configs import get_config
    from repro_torch.core import EdgentPlanner, lm_graph
    from repro_torch.core.latency_model import RooflineLatencyModel
    from repro_torch.data.bandwidth import dcn_trace
    from repro_torch.serving.tiers import Link

    cfg = get_config(arch)
    graph = lm_graph(cfg, batch=BATCH, seq=1)
    planner = EdgentPlanner(graph, latency_req_s=0.4).with_models(
        RooflineLatencyModel(chips=8, efficiency=0.4),
        RooflineLatencyModel(chips=1, efficiency=0.4))
    return cfg, graph, planner, Link(trace_bps=dcn_trace(0, 2048))


def make_requests(Request, vocab, plan):
    rs = np.random.default_rng(0)
    return [Request(rid=i, prompt=rs.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=NEW_TOKENS, slo_s=slo)
            for i, (n, slo) in enumerate(plan)]


def serve_main_path(torch, arch):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.serving import Request, ServingEngine

    cfg, graph, planner, link = serving_setup(arch)
    model = Model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init_params(gen, dtype=torch.bfloat16, device="cuda")
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"serve: {cfg.name} ({cfg.family}) layers {cfg.num_layers} d {cfg.d_model} heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} vocab {cfg.padded_vocab} segments "
        f"{model.segment_lengths()} params {n_params / 1e9:.3f} B in bf16")
    engine = ServingEngine(model, params, graph, planner, link, batch_size=BATCH,
                           dtype=torch.bfloat16)
    # 8 short prompts and 4 long ones, whose SLO demotes them (LONG_SLO)
    log(f"serve: long-prompt SLO {LONG_SLO[arch] * 1e3:.0f} ms")
    reqs = make_requests(Request, cfg.vocab_size, [(SHORT_PROMPT, SHORT_SLO)] * 8
                         + [(LONG_PROMPT, LONG_SLO[arch])] * 4)
    # wall time of each batch (a batch ends on a host read of its tokens,
    # so the synchronisations here add no wait of their own)
    batches = []
    serve_batch = engine._serve_batch

    def timed_batch(batch, stats, start_s=0.0):
        torch.cuda.synchronize()
        t = time.perf_counter()
        clock = serve_batch(batch, stats, start_s)
        torch.cuda.synchronize()
        batches.append((len(batch), max(len(r.prompt) for r in batch),
                        time.perf_counter() - t))
        return clock

    engine._serve_batch = timed_batch
    torch.cuda.synchronize()
    reset_launch_counts()
    require(not any(launch_counts().values()), "serve: a launch counter did not reset")
    t0 = time.perf_counter()
    stats = engine.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n_tok = sum(len(v) for v in stats.tokens.values())
    log(f"serve summary: {stats.summary()}")
    log(f"serve exits {stats.exits} partitions {stats.partitions}")
    log(f"serve launches: {counts}")
    variants = engine.stepper.cache_stats()["jit"]["variants"]["serial"]
    log(f"serve decode variants (model exits run): {variants}, "
        f"{sorted(engine.stepper._decode_fns, key=lambda e: e or 0)}")
    for i, (b, s, sec) in enumerate(batches):
        log(f"serve batch {i}: {b} requests, prompt {s}, {sec:.4f} s, "
            f"{b * NEW_TOKENS / sec:.1f} tokens/s")
    log(f"serve wall {wall:.3f} s, {n_tok} tokens, {n_tok / wall:.1f} tokens/s "
        f"(CUDA-synchronised, prefill included, first batch cold)")
    require(len(stats.tokens) == len(reqs), "serve: a request got no answer")
    for rid, toks in stats.tokens.items():
        require(len(toks) == NEW_TOKENS, f"serve: request {rid} got {len(toks)} tokens")
        require(all(0 <= t < cfg.padded_vocab for t in toks), f"serve: bad token in {rid}")
    h = engine.last_hidden
    require(h is not None and h.shape[1:] == (1, cfg.d_model)
            and torch.isfinite(h.float()).all().item(), "serve: bad last hidden state")
    for name in PATH_KERNELS[arch]:
        require(counts[name] > 0, f"serve {arch}: kernel {name} was never launched "
                "on the main path")
    require(variants > 1, "serve: no request was decoded at a demoted exit")
    if "ssm_scan" in PATH_KERNELS[arch]:
        require(counts["ssm_scan.chunked"] > 0, f"serve {arch}: no bf16 prefill ran on the "
                "chunked scan kernel")
    return params, counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_f32(v) for v in tree)
    return tree.float()


def scan_f64(q, k, v, log_w, state, u=None):
    """The plain scan computed in float64 and rounded to float32 at its
    outputs: the scan of the float64-scan path of phase 7."""
    from repro_torch.kernels.ssm_scan import ref as ss_ref
    o, s = ss_ref.ssm_scan(q.double(), k.double(), v.double(), log_w.double(),
                           state.double(), u=None if u is None else u.double())
    return o.float(), s.float()


@contextlib.contextmanager
def patched(module, name, fn):
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


def shadowed_scan(launch, worst):
    """``launch`` (the scan wrapper), with each call held against the plain
    version on the same inputs (see F32_UNIT); the worst shares of the
    allowed error and the largest error go to ``worst``."""
    from repro_torch.kernels.ssm_scan import ref as ss_ref

    def scan(q, k, v, log_w, state, u=None):
        o, s = launch(q, k, v, log_w, state, u=u)
        po, ps = ss_ref.ssm_scan(q, k, v, log_w, state, u=u)
        mo, ms = ss_ref.ssm_scan(q.abs(), k.abs(), v.abs(), log_w, state.abs(),
                                 u=None if u is None else u.abs())
        S, dk = q.shape[1], q.shape[3]
        err = (o.float() - po.float()).abs()
        share = (err / (SCAN_ATOL + ATTN_RTOL[str(v.dtype)] * po.float().abs()
                        + 2 * (S + dk + 2) * F32_UNIT * mo.float())).max().item()
        sshare = ((s - ps).abs() / (SCAN_ATOL + 2 * (S + 2) * F32_UNIT * ms)).max().item()
        worst["calls"] += 1
        worst["o"], worst["state"] = max(worst["o"], share), max(worst["state"], sshare)
        worst["err"] = max(worst["err"], err.max().item())
        return o, s
    return scan


def divergence(a, b, margins):
    """Each row's first step where the tokens of runs ``a`` and ``b``
    differ, with the top-2 margin of ``b`` there, and the distance of the
    last hidden states on the rows that never differ."""
    (pa, ha), (pb, hb) = a, b
    flips = {}
    for step, (x, y) in enumerate(zip(pa, pb)):
        for row, (s, t) in enumerate(zip(x, y)):
            if s != t and row not in flips:
                flips[row] = (step, margins[step][row])
    keep = [r for r in range(ha.shape[0]) if r not in flips]
    err = (ha[keep] - hb[keep]).abs().max().item() if keep else float("nan")
    return flips, err


def kernel_vs_plain(torch, params_bf16, arch):
    """Serve two batches of 4 requests in float32 through the kernels and
    through the plain path: the 12-token batch that decodes at the full
    exit, and the serve phase's 1000-token batch whose deadline demotes it
    to the earlier exits (whose deeper segments then go stale).

    On the kernel path every scan launch is held against the plain scan on
    the same inputs, and every token against the plain head on the same
    hidden state (equal unless its top-2 margin is below MARGIN_TOL).  End
    to end, the llama3.2-1b paths' tokens are equal except where the plain
    top-2 margin is below MARGIN_TOL, and their last hidden states within
    HIDDEN_TOL on the rows that did not flip.  For rwkv6-3b (END_TO_END) the
    end-to-end distances are measured and logged beside those of the plain
    path from the same path with a float64 scan."""
    from repro_torch.kernels.ssm_scan import ops as ss_ops
    from repro_torch.models import Model
    from repro_torch.models import linear_scan
    from repro_torch.serving import Request, ServingEngine

    params = _to_f32(params_bf16)
    impls = ("kernel", "dense") + (() if END_TO_END[arch] else ("float64 scan",))
    for label, plan in (("12-token", [(SHORT_PROMPT, SHORT_SLO)] * BATCH),
                        ("1000-token demoted", [(LONG_PROMPT, LONG_SLO[arch])] * BATCH)):
        runs = {}
        worst = {"calls": 0, "o": 0.0, "state": 0.0, "err": 0.0, "tokens": 0}
        for impl in impls:
            cfg, graph, planner, link = serving_setup(arch)
            engine = ServingEngine(Model(cfg), params, graph, planner, link,
                                   batch_size=BATCH, dtype=torch.float32,
                                   impl="kernel" if impl == "kernel" else "dense")
            picked, margin = [], []
            inner = engine.stepper.next_token

            def next_token(p, h, inner=inner, picked=picked, margin=margin,
                           impl=impl, model=engine.model):
                tok = inner(p, h)
                logits = model.logits(p, h)[:, -1].float()
                top2 = logits.topk(2, dim=-1).values
                m = (top2[:, 0] - top2[:, 1]).tolist()
                if impl == "kernel":
                    for row, (x, y) in enumerate(zip(tok[:, 0].tolist(),
                                                     logits.argmax(-1).tolist())):
                        require(x == y or m[row] < MARGIN_TOL,
                                f"{label}: the exit head picked {x}, the plain head {y} "
                                f"on the same hidden state (margin {m[row]})")
                    worst["tokens"] += len(m)
                picked.append(tok[:, 0].tolist())
                margin.append(m)
                return tok

            engine.stepper.next_token = next_token
            patch = {"kernel": (ss_ops, "ssm_scan", shadowed_scan(ss_ops.ssm_scan, worst)),
                     "float64 scan": (linear_scan, "scan_sequential", scan_f64)}.get(impl)
            with patched(*patch) if patch else contextlib.nullcontext():
                stats = engine.serve(make_requests(Request, cfg.vocab_size, plan))
            torch.cuda.synchronize()
            variants = engine.stepper.cache_stats()["jit"]["variants"]["serial"]
            runs[impl] = (stats, picked, margin, engine.last_hidden, variants)
        sk, _, _, _, vk = runs["kernel"]
        for impl, (st, *_rest) in runs.items():
            require(st.exits == sk.exits and st.summary() == sk.summary(),
                    f"{label}: the {impl} path planned differently from the kernel path")
        if plan[0][0] == LONG_PROMPT:
            require(vk > 1, f"{label}: no decode step ran at a demoted exit")
        if "ssm_scan" in PATH_KERNELS[arch]:
            require(worst["calls"] > 0, f"{label}: no scan launch was held")
        require(worst["o"] <= 1.0 and worst["state"] <= 1.0,
                f"{label}: a scan launch disagrees with the plain scan on its inputs: "
                f"{worst['o']} / {worst['state']} of the allowed error")
        log(f"kernel path ({arch}, f32, full width, {label}): {worst['calls']} scan launches "
            f"held against the plain scan on their inputs, o max_abs_err {worst['err']:.3g}, "
            f"worst err/allowed o {worst['o']:.3g} state {worst['state']:.3g}; "
            f"{worst['tokens']} tokens held "
            f"against the plain head on the same hidden state")
        for a, b in (("kernel", "dense"), ("dense", "float64 scan"),
                     ("kernel", "float64 scan")):
            if b not in runs:
                continue
            _, pa, _, ha, _ = runs[a]
            _, pb, mb, hb, _ = runs[b]
            flips, e = divergence((pa, ha), (pb, hb), mb)
            log(f"{a} vs {b} path ({arch}, f32, full width, {label}): {len(pb)} token "
                f"steps x {hb.shape[0]} rows, decode variants {vk}, last exit "
                f"{sk.exits[-1]}, first flip (step, {b} top-2 margin) by row "
                f"{ {r: (st, round(m, 6)) for r, (st, m) in sorted(flips.items())} }, "
                f"last hidden max_abs_err {e:.3g} on the other rows (tol {HIDDEN_TOL}), "
                f"min {b} margin {min(min(m) for m in mb):.3g}")
            if END_TO_END[arch] and (a, b) == ("kernel", "dense"):
                require(all(m < MARGIN_TOL for _, m in flips.values()),
                        f"{label}: a token differs where the plain path's margin is "
                        "above tolerance")
                require(not e > HIDDEN_TOL, f"{label}: last hidden states differ by {e}")


# ---------------------------------------------------------------- main
def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              f"(no {SRC / 'repro_torch'})", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # float32 comparisons are made in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1 device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"device: {kind}, count {torch.cuda.device_count()}")
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # -- 2 build
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {build.build_seconds}) -> {build.BUILD_DIR}")
    log(build.build_log)
    serialised = [line for line in build.build_log.splitlines() if "C7514" in line]
    log(f"build: {len(serialised)} wgmma serialisation warnings (C7514)")
    require(not serialised, f"ptxas serialised a kernel's wgmmas: {serialised}")

    # -- 3 kernel checks and times
    timer = Timer(torch)
    record = kernel_checks(torch, timer)
    del timer
    torch.cuda.empty_cache()

    # -- 4-7 the main paths, each with its kernel path against its plain path
    launches = {}
    for arch in (LLAMA, RWKV):
        params, counts = serve_main_path(torch, arch)
        kernel_vs_plain(torch, params, arch)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        del params
        torch.cuda.empty_cache()
    log(f"launches over the served paths: {launches}")

    sources = {
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:68"),
        "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/flash_attention/decode.py:69"),
        "exit_confidence": ("src/repro_torch/kernels/csrc/exit_head.cu",
                            "src/repro/kernels/exit_head/kernel.py:78"),
        "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                     "src/repro/kernels/ssm_scan/kernel.py:80"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        t = record[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                        "ms_unspun": t["ms_unspun"], "host_us": t["host_us"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                        "shape": t["shape"], "dtype": t["dtype"]})
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
