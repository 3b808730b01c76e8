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
   ``src/repro_torch/kernels/csrc`` into ``build/``;
3. kernel checks: each kernel against its plain PyTorch version on the card
   at the main path's full-width shapes, in bfloat16 and float32, with the
   edge cases (a ragged prefill tile, a zero-length decode row, vocab ties);
   then each kernel timed with CUDA events beside its plain version, one
   library call for the same function and its bound on the card;
4. serve: full-width llama3.2-1b in bfloat16 through ``ServingEngine.serve``
   (Edgent plan, prefill, right-sized decode, exit-head token) with every
   launch counter at zero before and above zero after;
5. kernel path against plain path: the same parameters in float32, served
   once through the kernels and once through the dense attention and the
   plain exit head, for a 12-token batch at the full exit and for phase 4's
   1000-token batch, which deadline demotion decodes at earlier exits.

The line before the last is the JSON record of every kernel; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside the
repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

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

ARCH = "llama3.2-1b"
BATCH = 4
NEW_TOKENS = 16
SHORT_PROMPT, LONG_PROMPT = 12, 1000
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
# phase 5: float32 hidden states of the kernel path against the plain path,
# after 16 layers whose attention sums in another order
HIDDEN_TOL = 1e-4
TIMED_RUNS, WARMUP_RUNS = 20, 3
L2_FLUSH_BYTES = 256 * 2**20          # > the H100's 50 MB L2


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
    more than 50 MB of weights."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def ms(self, fn):
        torch = self.torch
        for _ in range(WARMUP_RUNS):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(TIMED_RUNS):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(nbytes, flops, dtype, cfgmod):
    """The least time the card could take: bytes over the HBM rate or
    operations over the peak rate for the inputs' type, the larger."""
    import torch
    peak = cfgmod.PEAK_FLOPS_BF16 if dtype == torch.bfloat16 else cfgmod.PEAK_FLOPS_F32
    t_bytes, t_ops = nbytes / cfgmod.HBM_BW, flops / peak
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phase 3
def kernel_checks(torch, timer):
    import torch.nn.functional as F

    import repro_torch.config as C
    from repro_torch.configs import get_config
    from repro_torch.kernels.exit_head import ops as eh_ops
    from repro_torch.kernels.exit_head import ref as eh_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    cfg = get_config(ARCH)
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
    #    64-row tile), and a head dim of 128
    for dt in (torch.bfloat16, torch.float32):
        for B, S, h, kv, d in ((BATCH, SHORT_PROMPT, H, KV, hd),
                               (BATCH, LONG_PROMPT, H, KV, hd),
                               (2, 77, 4, 2, 128)):
            q, k, v = randn(B, S, h, d, dtype=dt), randn(B, S, kv, d, dtype=dt), \
                randn(B, S, kv, d, dtype=dt)
            out = fa_ops.flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            plain = fa_ref.attention(qt.float(), kt.float(), vt.float(),
                                     causal=True).transpose(1, 2)
            e, share = attn_err(out, plain, dt)
            log(f"check flash_attention {dt} B{B} S{S} H{h} KV{kv} hd{d}: "
                f"max_abs_err {e:.3g}, worst err/allowed {share:.3g} ({tol_text(dt)})")
            require(torch.isfinite(out).all().item(), "flash_attention: non-finite output")
            require(share <= 1.0, f"flash_attention {dt} S{S} hd{d} disagrees: "
                    f"{share} of the allowed error")
            if dt == torch.bfloat16 and h == H and d == hd:
                qc, kc, vc = (x.transpose(1, 2).contiguous() for x in (q, k, v))
                t = dict(
                    ms=timer.ms(lambda: fa_ops.flash_attention(q, k, v, causal=True)),
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

    # -- decode attention: the serving cache (T = 1000 + 16 + 1), read in
    #    place through a view of a [n_units, B, T, KV, hd] segment cache
    T = LONG_PROMPT + NEW_TOKENS + 1
    for dt in (torch.bfloat16, torch.float32):
        for B, Tc, h, kv, d, lens in ((BATCH, T, H, KV, hd, [T - 1] * BATCH),
                                      (BATCH, T, H, KV, hd, [T, 0, 5, T // 2]),
                                      (3, 200, 4, 1, 128, [200, 0, 63])):
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
            if dt == torch.bfloat16 and lens == [T - 1] * BATCH:
                qc, kc, vc = (x.contiguous() for x in (qt, kt, vt))
                valid = (torch.arange(Tc, device="cuda")[None, :] < lengths[:, None])
                mask = valid[:, None, None, :]
                t = dict(
                    ms=timer.ms(lambda: fa_ops.decode_attention(q, ck[1], cv[1], lengths)),
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
                record["decode_attention"] = t

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

                t = dict(ms=timer.ms(lambda: eh_ops.exit_confidence(h, emb)),
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
    return record


# ---------------------------------------------------------------- phases 4-5
def serving_setup():
    from repro_torch.configs import get_config
    from repro_torch.core import EdgentPlanner, lm_graph
    from repro_torch.core.latency_model import RooflineLatencyModel
    from repro_torch.data.bandwidth import dcn_trace
    from repro_torch.serving.tiers import Link

    cfg = get_config(ARCH)
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


def serve_main_path(torch):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.serving import Request, ServingEngine

    cfg, graph, planner, link = serving_setup()
    model = Model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init_params(gen, dtype=torch.bfloat16, device="cuda")
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"serve: {cfg.name} layers {cfg.num_layers} d {cfg.d_model} heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} vocab {cfg.padded_vocab} segments "
        f"{model.segment_lengths()} params {n_params / 1e9:.3f} B in bf16")
    engine = ServingEngine(model, params, graph, planner, link, batch_size=BATCH,
                           dtype=torch.bfloat16)
    # 8 short prompts and 4 long ones.  The long ones carry a 31 ms SLO that
    # their 1000-token prefill nearly spends (virtual time), so EDF serves
    # them first and deadline demotion decodes them at earlier exits: the
    # right-sized model runs on the card beside the full one.
    reqs = make_requests(Request, cfg.vocab_size,
                         [(SHORT_PROMPT, 0.4)] * 8 + [(LONG_PROMPT, 0.031)] * 4)
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
    log(f"serve decode variants (model exits run): {variants}")
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
    for name, n in counts.items():
        require(n > 0, f"serve: kernel {name} was never launched on the main path")
    require(variants > 1, "serve: no request was decoded at a demoted exit")
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


def kernel_vs_plain(torch, params_bf16):
    """Serve two batches of 4 requests in float32 through the kernels and
    through the plain path: the 12-token batch that decodes at the full
    exit, and phase 4's 1000-token batch whose deadline demotes it to the
    earlier exits.  Tokens equal except where the plain top-2 margin is
    below MARGIN_TOL, last hidden states allclose on the rows that did not
    flip."""
    from repro_torch.models import Model
    from repro_torch.serving import Request, ServingEngine

    params = _to_f32(params_bf16)
    for label, plan in (("12-token", [(SHORT_PROMPT, 0.4)] * BATCH),
                        ("1000-token demoted", [(LONG_PROMPT, 0.031)] * BATCH)):
        runs = {}
        for impl in ("kernel", "dense"):
            cfg, graph, planner, link = serving_setup()
            engine = ServingEngine(Model(cfg), params, graph, planner, link,
                                   batch_size=BATCH, dtype=torch.float32, impl=impl)
            picked, margin = [], []
            inner = engine.stepper.next_token

            def next_token(p, h, inner=inner, picked=picked, margin=margin,
                           impl=impl, model=engine.model):
                tok = inner(p, h)
                picked.append(tok[:, 0].tolist())
                if impl == "dense":
                    logits = model.logits(p, h)[:, -1].float()
                    top2 = logits.topk(2, dim=-1).values
                    margin.append((top2[:, 0] - top2[:, 1]).tolist())
                return tok

            engine.stepper.next_token = next_token
            stats = engine.serve(make_requests(Request, cfg.vocab_size, plan))
            torch.cuda.synchronize()
            variants = engine.stepper.cache_stats()["jit"]["variants"]["serial"]
            runs[impl] = (stats, picked, margin, engine.last_hidden, variants)
        (sk, pk, _, h_kernel, vk), (sd, pd, md, h_plain, _) = runs["kernel"], runs["dense"]
        require(sk.exits == sd.exits and sk.summary() == sd.summary(),
                f"{label}: kernel and plain paths planned differently")
        if plan[0][0] == LONG_PROMPT:
            require(vk > 1, f"{label}: no decode step ran at a demoted exit")
        flipped = set()
        for step, (a, b) in enumerate(zip(pk, pd)):
            for row, (x, y) in enumerate(zip(a, b)):
                if row in flipped or x == y:
                    continue
                log(f"token flip ({label}) step {step} row {row}: kernel {x} plain {y}, "
                    f"plain top-2 margin {md[step][row]:.3g}")
                require(md[step][row] < MARGIN_TOL, "token differs where the plain "
                        "path's margin is above tolerance")
                flipped.add(row)
        keep = [r for r in range(h_kernel.shape[0]) if r not in flipped]
        e = (h_kernel[keep] - h_plain[keep]).abs().max().item() if keep else 0.0
        log(f"kernel vs plain (f32, full width, {label}): {len(pd)} token steps x "
            f"{h_kernel.shape[0]} rows, decode variants {vk}, last exit {sk.exits[-1]}, "
            f"flips {sorted(flipped)}, last hidden max_abs_err {e:.3g} "
            f"(tol {HIDDEN_TOL}), min plain margin {min(min(m) for m in md):.3g}")
        require(e <= HIDDEN_TOL, f"{label}: last hidden states differ by {e}")


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

    # -- 3 kernel checks and times
    timer = Timer(torch)
    record = kernel_checks(torch, timer)
    del timer
    torch.cuda.empty_cache()

    # -- 4 the main path
    params, counts = serve_main_path(torch)

    # -- 5 kernel path against plain path
    kernel_vs_plain(torch, params)

    sources = {
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:68"),
        "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                             "src/repro/kernels/flash_attention/decode.py:69"),
        "exit_confidence": ("src/repro_torch/kernels/csrc/exit_head.cu",
                            "src/repro/kernels/exit_head/kernel.py:78"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        t = record[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
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
