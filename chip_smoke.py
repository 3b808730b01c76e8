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
   splits past every length, vocab ties; the exit head also over rows 1-65,
   vocabularies that are not a multiple of its 128-row tile, all logits
   negative and a tie across a chunk boundary, its ticket counters read
   back as 0 after phase 3 and after phase 16; attention also at zamba2-2.7b's
   head dim 80, its decode through views of the shared-attention cache;
   for the SSM scan both modes, rwkv6-3b's prefill and decode shapes from a
   non-zero state, zamba2-2.7b's Mamba-2 shapes read through stride-0
   broadcasts, chunk edges, the served model's weak decay and log_w = -8
   everywhere); then each kernel timed with CUDA
   events beside its plain version, one library call for the same function
   where there is one, and its bound on the card (attention also at the
   short serving shapes, S 12 and T 29, and at head dim 80; the exit head
   also over the rows sweep and at zamba2-2.7b's 4 x 2560 x 32000); then
   flash and decode attention at head dims 16 and 32 (the smoke configs'
   and the reference's kernel tests'), at the smoke stacks' G 2 and G 1, in
   both dtypes (the arena spec's 6-token prefill, a ragged tile, T > S
   causal and not, the serial cache, the arena's B 8 T 32 with a
   zero-length row, lengths on a split boundary, one past it, past T and
   zero), and the exit head at D 64 V 256, the served shapes timed; then
   phases 18-19's new shapes: flash and decode attention at starcoder2-15b's
   G 12 (48 heads over 4, hd 128: S 1000 and 12, T > S, a single ragged
   tile; the caches T 1017 and 29 with lengths on a split boundary, one
   past it, past T and zero) and granite-3-8b's G 4 hd 128 at B4 S1000, and
   the exit head at 4 x 2048 x 49280, 4 x 4096 x 49280 and 4 x 6144 x 49152
   with ties and with every logit negative, and at granite's real V 49155
   (its last tile 125 rows past V) with the last real row tied at 0 with
   what a padding row would score;
4. serve llama3.2-1b: full width in bfloat16 through ``ServingEngine.serve``
   (Edgent plan, prefill, right-sized decode, exit-head token) with every
   launch counter at zero before and its kernels' above zero after, each
   count equal to what the model's structure and the steps run give;
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
   same path with a float64 scan (see END_TO_END);
8. serve zamba2-2.7b: full width and depth in bfloat16, 54 Mamba-2 blocks
   through the scan kernels (the 1000-token prefill chunked) and the 9
   applications of the shared attention through flash and decode attention
   at head dim 80, the counters as in phase 4;
9. kernel path against plain path for zamba2-2.7b, as phase 5, end to end,
   with every scan launch also held as in phase 7.  The plain path never
   reaches the reference's chunked scan (which overflows at strong decay):
   its dispatch takes the sequential scan for 12 and 1000 tokens, neither
   a multiple of the 16-token chunk, and for decode;
10. the fleet with real decode for llama3.2-1b at full width: the arena
   suite's static scenario (53 requests over 8 devices and 2 edges of 8
   slots, 64-token prompts) through ``FleetEngine``, first the decode
   kernel checked and timed at the arena's shape (B 8, T 128, rows of
   length 1 among them); in bfloat16 through each decode strategy
   (serial, batched, the slot-resident ``DecodeArena``), each timed over
   one run after a warm-up run, with its tokens/s, its tokens that
   agree with serial, its flash and decode launches equal to what the
   prefills and decode calls give, and (serial) how often the exit-head
   kernel's token differs from the fleet's model-dtype argmax; in float32
   serial against arena, held: token streams equal except from a
   near-tie (MARGIN_TOL), summaries equal, every row outside an arena
   call's mask bit for bit unchanged, admits equal evicts, no padding, at
   most one arena variant per model exit;
11. the same for zamba2-2.7b at full width and depth over a 3 s horizon
   (serial and arena; the decode kernel at hd 80 and the
   stepped Mamba-2 scan at B 8 checked and timed at the arena's shapes),
   which puts the hybrid's shared attention cache, the masked commit of
   the Mamba-2 state and the stepped scan at B 8 on an arena path; then,
   for both models, the device idle share of one full-depth arena call
   at 8 active slots beside a serial step, every wall taken before the
   first profiler session (after phases 12-13, whose layer times are host
   walls too);
12. the paper's own Edgent path on BranchyAlexNet at its full size, in
   float32: parameters from ``torch.Generator`` seed 0 on the card; every
   layer of every branch on the card against the CPU on the same input,
   and each exit's logits over 1024 ``cifar_like`` images (a prediction
   may flip only below MARGIN_TOL); ``examples/quickstart.py``'s static
   pipeline (``offline_static`` profiled on the card, the Fig. 3 layer
   times, the factors and R^2, plans at 50-1000 kbps beside the CPU's)
   and ``examples/serve_dynamic_bandwidth.py``'s dynamic one (the
   configuration map over 428 Oboe-like traces, BOCD over a
   Belgium-LTE-like trace), every plan executed by ``TwoTierExecutor`` on
   the card and held against ``forward_exit``, its transfer and latency
   sum checked exactly;
13. the calibration loop on the card: ``measure_alexnet`` -> ``fit_table``
   (R^2 per kind) -> a planner on the raw fitted models, its plans beside
   phase 12's, and the table saved and loaded back equal; BranchyAlexNet's
   layers are cuDNN convolutions and cuBLAS products, as the reference's
   are XLA ops.  Then its LM half: ``measure_lm`` on llama3.2-1b's smoke
   stack (the one the reference measures and fits), its prefill and
   decode through flash and decode attention at head dim 16, and
   ``fit_table`` on the table;
14. training BranchyAlexNet, ``examples/train_branchy_alexnet.py``'s path:
   five of the example's steps (BranchyNet joint loss, AdamW) card against
   CPU with every dropout rate 0, each from the CPU's state, with
   ``cudnn.deterministic`` on and off, and five run free; then 300 steps
   of batch 64 with a failure injected at step 150 and the loop's restart
   from the checkpoint of step 100, the joint loss by step, the steps/s,
   the last checkpoint restored bit for bit, and the per-exit accuracy over
   1024 held-out images (the counterpart of Fig. 4/9);
15. training llama3.2-1b at full width and depth: its grads in float32 at
   B1 S2048, the flash path (flash backward) against the dense one and
   remat against none, per leaf; then ``launch/train.py --full``'s run
   (bf16 parameters, f32 moments, remat, flash blocks of 1024, the CE in
   chunks of 512), 6 steps of B4 S2048 with checkpoints every second step
   and a failure injected at step 3, the weights changed, the bf16
   checkpoint restored bit for bit; the median wall of 3 steps, tokens/s,
   peak memory and the step's FLOPs, and, after phase 11's profiles, the
   device idle share of one profiled step.  Training reaches none of the
   port's kernels: the reference's training path reaches no
   ``pl.pallas_call``, and the kernel wrappers refuse autograd;
16. the remaining families at full width, through the same kernels at
   shapes no earlier phase serves (phase 3 checks and times each kernel
   there first: hd 128 at G 4 and G 6, non-causal flash for an encoder and
   a cross-attention prefill of S 12 over T 1000, decode over a fixed
   1000-key memory, the exit head at D 4096 V 32000 and D 5120 V 202112):
   llava-next-mistral-7b (32 layers, a [2, 2880, 1024] image prefix through
   ``mm_proj`` in front of 32 text tokens, 16 decode steps at each exit
   with the exit heads' confidences, the same on the int8 KV cache, and
   ``ServingEngine.serve`` of its text backbone), seamless-m4t-large-v2 (24
   encoder layers over [4, 1000, 1024] frames, 24 decoder layers with
   cross-attention, a 12-token decoder prefill and 16 steps at each exit)
   and llama4-scout-17b-a16e (d 5120, 48 padded heads over 8, 16 experts;
   depth cut to 8 layers, ~35 GB of bf16 weights, as its 48 layers hold
   ~201 GB; a 1000-token prefill of 4 and 16 steps at each exit), each in
   bf16 with every launch counted against the model's structure; then each
   in float32 (llava at B1, scout at 4 layers), the kernel path against the
   plain path decoding the same tokens with every kernel launch held on its
   own inputs: last hidden states within HIDDEN_TOL, tokens equal unless
   the plain margin is below MARGIN_TOL, scout's router flips counted (with
   any, the paths part by design and scout is held launch by launch),
   padded heads exactly 0, the int8 decode within rel 0.05 of the
   unquantized cache's and its bytes under 0.6 of the bf16 cache's, and
   the gather dispatch against the einsum dispatch;
17. the simulator on the card, as a user drives it (after phase 16, before
   the profiler sessions): ``Simulation(spec).run()`` with real decode on
   the arena suite's static spec at the smoke size (4 heads of 16) in
   float32, serial, batched and arena, flash and decode launches counted
   and each run held against the port's own CPU run on the same
   parameters (tokens equal unless the CPU's top-2 margin is below
   MARGIN_TOL, summaries equal); ``run_sweep`` over planner.arch
   (llama3.2-1b, zamba2-2.7b, whose cells run the stepped Mamba-2 scan and
   G 1 decode) x engine.arena_decode over a spawn pool of two workers
   against inline, rows equal except ``wall_s``; ``python -m
   repro_torch.sim --scenario smoke-lm --set engine.real_decode=true
   --json`` as two subprocesses, with and without ``--trace``/``--timeline``,
   running beside the rest of the phase: metrics bit-identical and
   ``python -m repro_torch.obs validate`` passing;
   smoke-mobility in 8 geography tiles, timing-only, 4 processes against 1,
   bit-identical.  Its full-width part runs inside phase 10: the float32
   llama3.2-1b arena fleet again with a ``Tracer``, a ``Timeline`` and a
   ``SimProfiler`` attached, summary, handover log and tokens bit-identical
   to the unobserved run, the trace valid, the profiler's wall per event
   kind logged;
18. every other served config (after phase 17, before the profiler
   sessions): granite-3-2b (40 layers, V 49155), granite-3-8b (hd 128) and
   starcoder2-15b (G 12, D 6144; 43.4 GB of bf16 weights) at full width and
   depth in bf16 through ``ServingEngine.serve`` as phases 4, 6 and 8 (8
   short and 4 demoted 1000-token prompts, every launch count equal to what
   the structure and the steps give, the tokens that fall in the
   embedding's padding rows logged), each then kernel path against plain
   path in float32 as phase 5, end to end (starcoder2-15b at 20 of its 40
   layers, parameters drawn anew in float32); then llama4-maverick at full
   width and 2 of 48 layers (one dense/MoE unit of 128 experts, ~35 GB in
   bf16; its segments [0, 1]) through ``ServingEngine.serve``, and its MoE
   layer's gather dispatch against the einsum dispatch on the embedded
   1000-token prompts;
19. the fleet with real decode as phases 10-11 for llama4-scout (8 layers in
   bf16, 4 in float32, its MoE drops past capacity counted), llava's text
   backbone (whole; the fleet feeds no image prefix) and starcoder2-15b
   (whole in bf16, 20 layers in float32; its decode kernel checked and
   timed first at the arena's shape, G 12), serial and arena, over 1.5-2 s
   horizons;
20. the substrate (after phase 19, before the profiler sessions): the
   sharded steps of ``launch/steps.py`` on ``make_host_mesh()`` over the
   card (NCCL, a world of one, mesh 1x1).  llama3.2-1b at full width and
   depth in bf16: ``make_prefill_step`` at B4 S1024 through the flash
   kernel, then 16 ``make_serve_step`` steps at each exit through the
   decode-attention and exit-head kernels, every launch count zero before
   and equal after to what the structure and the steps give; the same in
   float32 against the mesh-less ``Model.prefill`` / ``decode_step``
   (last hidden within HIDDEN_TOL, tokens equal unless the top-2 margin is
   below MARGIN_TOL, bitwise equality logged); rwkv6-3b at full width in
   bf16, a 12-token prefill step and 8 serve steps through the scan
   kernel, each launch held against the plain scan; two llama3.2-1b
   float32 train steps at B1 S2048, with and without ``seq_parallel``,
   against the mesh-less step (loss and every parameter within 1e-5);
   ``decode_step_batch(sharded=True)`` bit for bit ``sharded=False``;
   ``PrefetchLoader(mesh=, spec=)``'s local shard equal to the host batch;
   and the dry run of llama3.2-1b decode_32k on a fake 256-rank group as a
   subprocess, with ``roofline.report`` on its record (analytic: shapes
   and H100 constants, not measured);
21. every family trained on the card (after phase 20, before the profiler
   sessions): rwkv6-3b, zamba2-2.7b and seamless-m4t-large-v2 whole,
   llava-next-mistral-7b and llama4-scout-17b-a16e at full width with their
   depth cut (TRAIN_LAYERS).  First the float32 holds at batch 1 with TF32
   off, per leaf of the grads within LM_GRAD_RTOL max|g| + LM_GRAD_ATOL
   and the losses within LM_LOSS_TOL (TRAIN_HOLDS, each at its S and
   depth): remat against none for every family, flash (attention "auto",
   past 1024² scores) against dense for zamba2's shared attention, seamless
   (encoder, decoder self- and cross-attention), llava and scout (its
   router flips counted and logged with their margins), the chunked scan
   against the sequential one for rwkv6-3b and zamba2-2.7b at S 256, every
   scan also held on its own inputs, forward and backward; then the card
   against the CPU on the same parameters for rwkv6-3b, zamba2-2.7b and
   seamless at S 128 (TRAIN_CPU_LAYERS).  rwkv6-3b's blocks amplify a
   rounding difference in their inputs (END_TO_END), so its end-to-end
   distances are logged with their worst leaf, and held instead are each
   scan and each block on its own inputs (card against CPU: the block run
   on both from the same inputs) and, card against CPU end to end, what
   lies outside the blocks (every block the identity).  Then
   ``launch/train.py --full``'s recipe through the step
   ``train(smoke=False)`` runs (``train.trainer_step``:
   ``make_train_step(remat=True, ce_chunk=512)``, bf16 parameters, f32
   moments, AdamW, the state donated) on batches ``train.train_batch``
   builds (frames for seamless, llava's prefix with its tokens cut): a
   warm-up step and 3 timed, every loss finite (else the step and the first
   non-finite leaf are named), every leaf's gradient non-zero and every
   leaf changed that bf16 can move at these learning rates, with each
   step's wall, tokens/s, peak memory and FLOP rate (FLOPs counted by
   ``torch.utils.flop_counter``); no kernel launched;
22. the port's five example scripts (``examples/torch_*.py``) as
   subprocesses on the card at their defaults, side by side, each to exit
   0 with the lines it promises (quickstart's five plans, the dynamic
   pipeline's SLO attainment, the LLM script's serving summary and exit-head
   line with conf in (0, 1] and entropy at most log V, with ``--dynamic``
   too, the fleet's summary and ten token rows, BranchyAlexNet's falling
   joint loss and five exit accuracies); meanwhile the LLM and fleet
   scripts in process, each kernel of their path launched (flash, decode
   and the exit head; flash and decode).

23. the shared pad prefix (after phase 22; it opens a profiler session for
   the engine's counters): one batch of llama3.2-1b at full width, prompts
   of PAD_PREFIX_LENGTHS, prefilled with the rows' pad prefix computed once
   (``Model.prefill``'s ``lengths``) and as left-padded rows.  In float32
   (TF32 off) the last hidden states and every row's cache over [0, S) in
   every segment within HIDDEN_TOL, and ``ServingEngine.serve``'s tokens
   equal unless the padded path's top-2 margin is below MARGIN_TOL.  In
   bfloat16 every flash launch of the shared path held against its plain
   version on its inputs (ATTN_ATOL + ATTN_RTOL, the B + 1 calls of a layer
   at T > S), the last hidden
   states no further from the float32 padded prefill than twice the
   padded bfloat16 prefill's distance, B + 1 flash launches a layer against
   the padded path's one, and ``engine.pad_prefix.batches`` counted.

The line before the last is the JSON record of every kernel; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside the
repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import gc
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

LLAMA, RWKV, ZAMBA = "llama3.2-1b", "rwkv6-3b", "zamba2-2.7b"
GRANITE2, GRANITE8, STARCODER = "granite-3-2b", "granite-3-8b", "starcoder2-15b"
LLAVA, SEAMLESS, SCOUT = "llava-next-mistral-7b", "seamless-m4t-large-v2", "llama4-scout-17b-a16e"
MAVERICK = "llama4-maverick-400b-a17b"
BATCH = 4
NEW_TOKENS = 16
SHORT_PROMPT, LONG_PROMPT = 12, 1000
SHORT_SLO = 0.4
# (short, long) SLOs of a served config at its depth.  The long prompts'
# SLO: their 1000-token prefill nearly spends it in the latency model's
# virtual time, so EDF serves them first and deadline demotion decodes them
# at earlier exits, and the right-sized model runs on the card beside the
# full one (llama3.2-1b: exits 2-4; rwkv6-3b and zamba2-2.7b: exits 2-3;
# granite and starcoder2: exits 3-4; two-layer
# llama4-maverick: exit 1, before its one unit, whose segments are [0, 1]).
# starcoder2-15b's 12-token batch takes ~0.54 s of virtual time at
# its full 40 layers, so at SHORT_SLO it too would be demoted: its short SLO
# is 1 s, and the short batches decode at the full exit as the others' do.
SERVE_SLO = {(LLAMA, 16): (SHORT_SLO, 0.031), (RWKV, 32): (SHORT_SLO, 0.068),
             (ZAMBA, 54): (SHORT_SLO, 0.0555), (GRANITE2, 40): (SHORT_SLO, 0.065),
             (GRANITE8, 40): (SHORT_SLO, 0.21), (STARCODER, 40): (1.0, 0.55),
             (STARCODER, 20): (SHORT_SLO, 0.28), (MAVERICK, 2): (SHORT_SLO, 0.2)}
# the kernels each served model's main path must launch
ATTN_PATH = ("flash_attention", "decode_attention", "exit_confidence")
PATH_KERNELS = {LLAMA: ATTN_PATH, RWKV: ("ssm_scan", "exit_confidence"),
                ZAMBA: ("flash_attention", "decode_attention", "ssm_scan", "exit_confidence"),
                GRANITE2: ATTN_PATH, GRANITE8: ATTN_PATH, STARCODER: ATTN_PATH,
                MAVERICK: ATTN_PATH}
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
# zamba2-2.7b is held end to end (phase 9): its gated RMSNorm normalises over
# all 5120 channels of a block, not over one head's 64, and its two paths
# stay within HIDDEN_TOL on the card (PERF.md, section 6).
END_TO_END = {LLAMA: True, RWKV: False, ZAMBA: True, GRANITE2: True, GRANITE8: True,
              STARCODER: True}
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


def attn_share(out, plain32, dt):
    """max |kernel - plain| and the largest share of the allowed error
    (ATTN_ATOL + ATTN_RTOL |plain|) any element takes; ``plain32`` is the
    plain version computed in float32."""
    diff = (out.float() - plain32).abs()
    allowed = ATTN_ATOL + ATTN_RTOL[str(dt)] * plain32.abs()
    return diff.max().item(), (diff / allowed).max().item()


def tol_text(dt):
    return f"allowed {ATTN_ATOL} + {ATTN_RTOL[str(dt)]:.4g} |plain f32|"


def flash_check(torch, timer, draw, dt, B, S, Tk, h, kv, d, causal=True, timed=False):
    """Flash attention on inputs from ``draw`` (q, then k, then v) against
    its plain version in float32; with ``timed`` (bf16 only) its times
    beside the plain version, SDPA and its bound, else None."""
    import torch.nn.functional as F

    import repro_torch.config as C
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    q, k, v = draw(B, S, h, d, dtype=dt), draw(B, Tk, kv, d, dtype=dt), \
        draw(B, Tk, kv, d, dtype=dt)
    out = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    plain = fa_ref.attention(qt.float(), kt.float(), vt.float(),
                             causal=causal).transpose(1, 2)
    e, share = attn_share(out, plain, dt)
    shape = f"B{B} S{S}" + (f" T{Tk}" if Tk != S else "") + f" H{h} KV{kv} hd{d}" \
        + ("" if causal else " non-causal")
    log(f"check flash_attention {dt} {shape}: max_abs_err {e:.3g}, worst err/allowed "
        f"{share:.3g} ({tol_text(dt)})")
    require(torch.isfinite(out).all().item(), "flash_attention: non-finite output")
    require(share <= 1.0, f"flash_attention {dt} {shape} disagrees: {share} of the "
            "allowed error")
    if not (timed and dt == torch.bfloat16):
        return None
    qc, kc, vc = (x.contiguous() for x in (qt, kt, vt))
    t = dict(**timer.kernel(lambda: fa_ops.flash_attention(q, k, v, causal=causal)),
             plain_ms=timer.ms(lambda: fa_ref.attention(qt, kt, vt, causal=causal)),
             library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                 qc, kc, vc, is_causal=causal, enable_gqa=True)))
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    # QK^T and PV over every (query, key) pair: the causal half at S == T
    pairs = S * (S + 1) // 2 if causal else S * Tk
    t["bound_ms"], t["bound_by"] = bound(nbytes, 4 * B * h * d * pairs, dt, C)
    t.update(max_abs_err=e, err_share=share, shape=shape, dtype=str(dt))
    log(f"time flash_attention {t}")
    return t


def decode_check(torch, timer, draw, dt, B, Tc, h, kv, d, lens, n_units=2, timed=False):
    """Decode attention over a view of a stacked [n_units, B, Tc, KV, hd]
    cache (drawn k, then v, then q) against its plain version in float32;
    a zero-length row must be exactly 0.  With ``timed`` (bf16 only) its
    times beside the plain version, SDPA and its bound, else None."""
    import torch.nn.functional as F

    import repro_torch.config as C
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    ck, cv = draw(n_units, B, Tc, kv, d, dtype=dt), draw(n_units, B, Tc, kv, d, dtype=dt)
    kc_, vc_ = ck[n_units // 2], cv[n_units // 2]
    q = draw(B, 1, h, d, dtype=dt)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    out = fa_ops.decode_attention(q, kc_, vc_, lengths)
    torch.cuda.synchronize()
    qt, kt, vt = q.transpose(1, 2), kc_.transpose(1, 2), vc_.transpose(1, 2)
    plain = fa_ref.decode_attention(qt.float(), kt.float(), vt.float(),
                                    lengths).transpose(1, 2)
    e, share = attn_share(out, plain, dt)
    log(f"check decode_attention {dt} B{B} T{Tc} H{h} KV{kv} hd{d} lengths {lens}: "
        f"max_abs_err {e:.3g}, worst err/allowed {share:.3g} ({tol_text(dt)})")
    require(torch.isfinite(out).all().item(), "decode_attention: non-finite output")
    require(share <= 1.0, f"decode_attention {dt} H{h}/{kv} hd{d} lengths {lens} "
            f"disagrees: {share} of the allowed error")
    if 0 in lens:
        z = out[lens.index(0)].abs().max().item()
        require(z == 0.0, f"decode_attention: zero-length row is not zero ({z})")
    if not (timed and dt == torch.bfloat16):
        return None
    qc, kc, vc = (x.contiguous() for x in (qt, kt, vt))
    mask = (torch.arange(Tc, device="cuda")[None, :] < lengths[:, None])[:, None, None]
    t = dict(**timer.kernel(lambda: fa_ops.decode_attention(q, kc_, vc_, lengths)),
             plain_ms=timer.ms(lambda: fa_ref.decode_attention(qt, kt, vt, lengths)),
             library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                 qc, kc, vc, attn_mask=mask, enable_gqa=True)))
    n_keys = sum(min(n, Tc) for n in lens)
    nbytes = (2 * q.numel() + 2 * n_keys * kv * d) * q.element_size() + 4 * B
    t["bound_ms"], t["bound_by"] = bound(nbytes, 4 * h * d * n_keys, dt, C)
    t.update(max_abs_err=e, err_share=share, dtype=str(dt),
             shape=f"B{B} T{Tc} H{h} KV{kv} hd{d} lengths {lens[0]}")
    log(f"time decode_attention {t}")
    return t


def exit_head_composite(h2, emb):
    """The exit head's library yardstick, never called by the port: the
    logits by one product (cuBLAS), then argmax, logsumexp and the entropy
    as PyTorch reductions."""
    import torch
    logits = (h2 @ emb.T).float()
    lse = torch.logsumexp(logits, -1)
    p = torch.softmax(logits, -1)
    return logits.argmax(-1), torch.exp(logits.max(-1).values - lse), \
        lse - (p * logits).sum(-1)


def exit_head_check(torch, timer, draw, dt, rows, d, vv, timed=False, negative=False,
                    boundary_tie=False, pad_tie=False):
    """The exit head over h [1, rows, d] (drawn first) against an embedding
    [vv, d] (drawn second) with exact ties across chunks and warps (row 0's
    maximum is a 3-way tie, which the first index must win), against its
    plain version on the same values widened to float32: tokens equal
    unless the plain top-2 margin is below MARGIN_TOL, conf within
    CONF_TOL, entropy within ENT_RTOL.  With ``negative`` every logit is
    negative (h >= 0, emb <= 0) and no tie is built: a zero-filled row past
    V would score 0 and win.  With ``boundary_tie`` the last row's maximum
    is a tie between the last vocab row of a chunk of the kernel's plan on
    this card and the first row of the next chunk, which the first must
    win (with one row, in place of row 0's tie).  With ``pad_tie`` (and
    ``negative``) the last vocab row scores exactly 0 on every row, the
    score of a zero-filled row past V: an unmasked padding row of the
    kernel's last tile would tie it (the first index still wins) and add
    its mass to conf and entropy; every row must pick V - 1.  With
    ``timed`` (bf16 only) its times beside the plain version, the library
    composite and its bound."""
    import repro_torch.config as C
    from repro_torch.kernels.exit_head import ops as eh_ops
    from repro_torch.kernels.exit_head import ref as eh_ref
    h = draw(1, rows, d, dtype=dt)
    emb = draw(vv, d, dtype=dt, scale=1.0 / math.sqrt(d))
    if negative:
        h, emb = h.abs(), -emb.abs()
        if pad_tie:
            emb[vv - 1] = 0.0
    else:
        emb[6] = emb[5]                      # same chunk, neighbouring warps
        emb[vv - 100] = emb[5]               # a chunk near the end
        h[0, 0] = emb[5].float().mul(40.0).to(dt)   # row 0's maximum: a 3-way tie
    tie = ""
    if boundary_tie:
        _, n_chunks = eh_ops.exit_head_plan(vv, eh_ops._sms(h.device))
        edge = eh_ops.chunk_tiles(n_chunks // 2, vv, n_chunks)[0] * eh_ops.TILE
        emb[edge] = emb[edge - 1]
        h[0, rows - 1] = emb[edge - 1].float().mul(40.0).to(dt)
        tie = (f", chunk-boundary tie {edge - 1}|{edge} of {n_chunks} chunks on row "
               f"{rows - 1}")
    got = eh_ops.exit_confidence(h, emb)
    torch.cuda.synchronize()
    hf, ef = h.float(), emb.float()
    plain = eh_ref.exit_confidence(hf, ef)
    require(((got["token"] >= 0) & (got["token"] < vv)).all().item(),
            f"exit head V{vv}: a token outside the vocab")
    if not negative and not (boundary_tie and rows == 1):
        require(got["token"][0, 0].item() == 5,
                f"exit head V{vv}: tie went to {got['token'][0, 0].item()}, not 5")
    if pad_tie:
        require(bool((got["token"] == vv - 1).all()), f"exit head V{vv}: the tie of row "
                f"{vv - 1} with the padding past V went to {got['token'].tolist()}")
    if boundary_tie:
        require(got["token"][0, rows - 1].item() == edge - 1,
                f"exit head V{vv}: the chunk-boundary tie went to "
                f"{got['token'][0, rows - 1].item()}, not {edge - 1}")
    diff = (got["token"] != plain["token"]).nonzero().tolist()
    if diff:
        top2 = torch.einsum("bsd,vd->bsv", hf, ef).topk(2, dim=-1).values
        m = top2[..., 0] - top2[..., 1]
        for b, s in diff:
            log(f"exit head token flip row {s}: kernel {got['token'][b, s].item()} "
                f"plain {plain['token'][b, s].item()} margin {m[b, s].item():.3g}")
            require(m[b, s].item() < MARGIN_TOL, "exit head: token differs "
                    "where the plain margin is above tolerance")
    ec = (got["conf"] - plain["conf"]).abs().max().item()
    ee = ((got["entropy"] - plain["entropy"]).abs()
          / plain["entropy"].abs().clamp_min(1.0)).max().item()
    log(f"check exit_confidence {dt} rows{rows} D{d} V{vv}"
        f"{' all logits negative' if negative else ''}"
        f"{f', row {vv - 1} tied with the padding at 0' if pad_tie else ''}{tie}: "
        f"tokens equal "
        f"{not diff}, conf err {ec:.3g} (tol {CONF_TOL}), entropy rel err "
        f"{ee:.3g} (tol {ENT_RTOL})")
    require(ec <= CONF_TOL and ee <= ENT_RTOL, f"exit head {dt} D{d} V{vv} disagrees")
    if not (timed and dt == torch.bfloat16):
        return None
    h2 = h.reshape(rows, d)
    t = dict(**timer.kernel(lambda: eh_ops.exit_confidence(h, emb)),
             plain_ms=timer.ms(lambda: eh_ref.exit_confidence(h, emb)),
             library_ms=timer.ms(lambda: exit_head_composite(h2, emb)))
    nbytes = (h.numel() + emb.numel()) * h.element_size() + 12 * rows
    t["bound_ms"], t["bound_by"] = bound(nbytes, 2 * rows * vv * d, dt, C)
    t.update(max_abs_err=max(ec, (got["entropy"] - plain["entropy"]).abs().max().item()),
             shape=f"rows{rows} D{d} V{vv}", dtype=str(dt))
    log(f"time exit_confidence {t}")
    return t


# ---------------------------------------------------------------- phase 3
def kernel_checks(torch, timer):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops

    cfg = get_config(LLAMA)
    H, KV, hd, D, V = cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_model, cfg.padded_vocab
    gen = torch.Generator(device="cuda").manual_seed(1234)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
        return (x * scale).to(dtype)

    record = {}
    zc = get_config(ZAMBA)
    ZH, ZKV, zhd = zc.num_heads, zc.num_kv_heads, zc.hd
    # the served models' attention shapes: llama3.2-1b's (the record) and
    # zamba2-2.7b's shared attention at head dim 80
    served = {(H, KV, hd): LLAMA, (ZH, ZKV, zhd): ZAMBA}
    timed = {}          # (model, kernel, shape kind) -> times

    def flash_case(dt, B, S, Tk, h, kv, d, draw):
        t = flash_check(torch, timer, draw, dt, B, S, Tk, h, kv, d,
                        timed=(h, kv, d) in served and S == Tk)
        if t is not None:
            timed[served[h, kv, d], "flash_attention", S == LONG_PROMPT] = t

    def decode_case(dt, B, Tc, h, kv, d, lens, n_units, draw):
        t = decode_check(torch, timer, draw, dt, B, Tc, h, kv, d, lens, n_units,
                         timed=(h, kv, d) in served and lens == [Tc - 1] * BATCH)
        if t is not None:
            timed[served[h, kv, d], "decode_attention", Tc == T] = t

    # -- prefill flash attention: S 12 and 1000 (both ragged against the
    #    64- and 128-row tiles), a head dim of 128, and T > S (the causal
    #    diagonal aligned bottom-right) at both head dims
    for dt in (torch.bfloat16, torch.float32):
        for case in ((BATCH, SHORT_PROMPT, SHORT_PROMPT, H, KV, hd),
                     (BATCH, LONG_PROMPT, LONG_PROMPT, H, KV, hd),
                     (2, 77, 77, 4, 2, 128),
                     (2, 100, 300, 4, 2, 64),
                     (2, 100, 300, 4, 2, 128)):
            flash_case(dt, *case, randn)

    # -- decode attention: the serving caches (T = 1000 + 16 + 1 and 12 + 16
    #    + 1, the short one 544 of the 635 served launches), read in place
    #    through a view of a [n_units, B, T, KV, hd] segment cache; the keys
    #    are split in blocks of SPLIT_KEYS: lengths on a split boundary, one
    #    past it, and splits past every length (empty partials)
    T = LONG_PROMPT + NEW_TOKENS + 1
    T_SHORT = SHORT_PROMPT + NEW_TOKENS + 1
    SK = fa_ops.SPLIT_KEYS
    for dt in (torch.bfloat16, torch.float32):
        for case in ((BATCH, T, H, KV, hd, [T - 1] * BATCH),
                     (BATCH, T, H, KV, hd, [T, 0, 5, T // 2]),
                     (3, 200, 4, 1, 128, [200, 0, 63]),
                     (BATCH, T, H, KV, hd, [SK, 2 * SK, 5 * SK, 1]),
                     (BATCH, T, H, KV, hd, [SK + 1, 2 * SK + 1, 5 * SK + 1, T + 7]),
                     (BATCH, T, H, KV, hd, [SK - 28, 5, 0, SK]),
                     (BATCH, T_SHORT, H, KV, hd, [T_SHORT - 1] * BATCH)):
            decode_case(dt, *case, 2, randn)

    # -- head dim 80, zamba2-2.7b's shared attention (32/32 heads of 80),
    #    from a generator of its own, so that the inputs of the checks above
    #    and below stay those of earlier runs.  Flash: the served S 12 and
    #    1000, a ragged tile and T > S; every head random, so that a tensor
    #    map reaching into the next head's columns would show.  Decode: the
    #    served caches T 1017 and 29, read through a view of the shared
    #    [napp, B, T, KV, hd] cache, with lengths on a split boundary, one
    #    past it, past T and zero
    gen80 = torch.Generator(device="cuda").manual_seed(80)

    def randn80(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen80, device="cuda").to(dtype)

    napp = zc.num_layers // zc.hybrid_attn_period
    for dt in (torch.bfloat16, torch.float32):
        for case in ((BATCH, SHORT_PROMPT, SHORT_PROMPT, ZH, ZKV, zhd),
                     (BATCH, LONG_PROMPT, LONG_PROMPT, ZH, ZKV, zhd),
                     (2, 77, 77, 4, 4, zhd),
                     (2, 100, 300, 4, 2, zhd)):
            flash_case(dt, *case, randn80)
        for case in ((BATCH, T, ZH, ZKV, zhd, [T - 1] * BATCH),
                     (BATCH, T, ZH, ZKV, zhd, [SK, SK + 1, T + 7, 0]),
                     (BATCH, T, ZH, ZKV, zhd, [5 * SK, 5 * SK + 1, 0, T]),
                     (BATCH, T_SHORT, ZH, ZKV, zhd, [T_SHORT - 1] * BATCH),
                     (BATCH, T_SHORT, ZH, ZKV, zhd, [0, 5, T_SHORT + 3, T_SHORT - 1])):
            decode_case(dt, *case, napp, randn80)

    record["flash_attention"] = timed[LLAMA, "flash_attention", True]
    record["decode_attention"] = timed[LLAMA, "decode_attention", True]
    for model, which in ((LLAMA, "the short serving shapes"),
                         (ZAMBA, "head dim 80 (zamba2-2.7b)")):
        log(f"time at {which}: " + "; ".join(
            f"{name} {t['shape']}: kernel {t['ms']} ms ({t['ms_unspun']} ms unspun, "
            f"{t['host_us']} us on the host), plain {t['plain_ms']} ms, library "
            f"{t['library_ms']} ms, bound {t['bound_ms']} ms ({t['bound_by']})"
            for (m, name, long_), t in timed.items()
            if m == model and (model == ZAMBA or not long_)))

    # -- exit head: the main path's rows against the full tied embedding,
    #    with exact ties across chunks and warps, and a ragged small vocab
    for dt in (torch.bfloat16, torch.float32):
        for rows, d, vv in ((BATCH, D, V), (7, 64, 1000)):
            t = exit_head_check(torch, timer, randn, dt, rows, d, vv, timed=vv == V)
            if t is not None:
                record["exit_confidence"] = t
    record["ssm_scan"] = scan_checks(torch, timer, randn)
    record["exit_confidence"]["at_shapes"] = exit_head_cases(torch, timer)
    return record


# phase 3's rows sweep of the exit head at llama3.2-1b's D and V: one m64n16
# group (1-16), one m64n64 group (17-64), two groups (65)
EXIT_ROWS = (1, 2, 4, 7, 8, 16, 17, 64, 65)
GRANITE_VOCAB = 49155         # granite-3-2b's vocab_size: 384 tiles of 128 and 3 rows


def exit_tickets_zero(torch):
    """Every exit-head ticket counter reads back as 0: a call that faulted
    would leave one set, and every later call would then merge early."""
    from repro_torch.kernels.exit_head import ops as eh_ops
    torch.cuda.synchronize()
    left = {str(k): int(t.count_nonzero()) for k, t in eh_ops._TICKETS.items()}
    log(f"exit head ticket buffers (device, stream) -> counters not zero: {left}")
    require(left and not any(left.values()), f"exit head tickets not zero: {left}")


def exit_head_cases(torch, timer):
    """The exit head's cases of its Hopper redesign, from a generator of its
    own (seed 20), so that the inputs of the checks before and after stay
    those of earlier runs, in both dtypes: the rows sweep at llama3.2-1b's
    D 2048 V 128256, vocabularies that are not a multiple of the 128-row
    tile (32001, granite's 49155), every logit negative over a ragged tail,
    and a tie across a chunk boundary of the plan.  Then zamba2-2.7b's
    shape (4 x 2560 x 32000).  Timed (bf16): the sweep and zamba2's shape.
    Ends with every ticket counter read back as 0.  Returns {label: times}."""
    from repro_torch.configs import get_config

    gen = torch.Generator(device="cuda").manual_seed(20)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    cfg, zc = get_config(LLAMA), get_config(ZAMBA)
    D, V = cfg.d_model, cfg.padded_vocab
    times = {}
    for dt in (torch.bfloat16, torch.float32):
        for rows in EXIT_ROWS:
            t = exit_head_check(torch, timer, randn, dt, rows, D, V, timed=True)
            if t is not None:
                times[f"rows {rows}"] = t
        for vv in (32001, GRANITE_VOCAB):
            exit_head_check(torch, timer, randn, dt, BATCH, D, vv)
        exit_head_check(torch, timer, randn, dt, BATCH, D, GRANITE_VOCAB, negative=True)
        exit_head_check(torch, timer, randn, dt, BATCH, D, V, boundary_tie=True)
        exit_head_check(torch, timer, randn, dt, 1, D, V, boundary_tie=True)
        t = exit_head_check(torch, timer, randn, dt, BATCH, zc.d_model, zc.padded_vocab,
                            timed=True)
        if t is not None:
            times[ZAMBA] = t
    sweep = {k: t["ms"] for k, t in times.items() if k.startswith("rows")}
    log(f"time exit_confidence rows sweep at D{D} V{V} (ms): {sweep}")
    exit_tickets_zero(torch)
    return times


# phase 3 at the smoke stacks' shapes, which the simulator builds (phase 17):
# 4 heads of 16 over 2 kv heads (llama3.2-1b's smoke config, G 2) or 4
# (zamba2-2.7b's, G 1), D 64, V 256; the arena suite's static spec has
# prompts of SIM_PROMPT tokens and budgets of 6 and 10 new tokens, so a serial
# cache holds SIM_PROMPT + 10 + 1 keys and the arena 8 slots of 32
SIM_PROMPT, SIM_SERIAL_T, SIM_SLOTS, SIM_ARENA_T = 6, 17, 8, 32
SIM_HEAD_DIMS = (16, 32)


def smoke_kernel_cases(torch, timer):
    """Flash and decode attention at head dims 16 and 32 (the smoke
    configs' and the reference's kernel tests'), in both dtypes, at the
    smoke stacks' G 2 and G 1: the arena spec's 6-token prefill, a ragged
    q-tile, T > S (causal and not), the serial cache, the arena's B 8 T 32
    with a zero-length row, and lengths on a split boundary, one past it,
    past T and zero.  Then the exit head at D 64 V 256.  Each against its
    plain version at the stated tolerances; the served shapes timed (bf16)
    beside the plain version, SDPA or the library composite and the bound.
    From a generator of its own (seed 17), so that the inputs of the other
    checks stay those of earlier runs.  Returns ``{kernel: {label: times}}``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    gen = torch.Generator(device="cuda").manual_seed(17)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    out = {"flash_attention": {}, "decode_attention": {}, "exit_confidence": {}}

    def keep(kernel, label, t):
        if t is not None:
            out[kernel][label] = t

    SK = fa_ops.SPLIT_KEYS
    lens_arena = [SIM_PROMPT + 1, 0, SIM_PROMPT + 10, SIM_ARENA_T, 1, SIM_PROMPT + 6,
                  SIM_ARENA_T - 1, SIM_PROMPT + 3]
    for dt in (torch.bfloat16, torch.float32):
        for d in SIM_HEAD_DIMS:
            for kv in (2, 4):
                g = f"G{4 // kv}"
                keep("flash_attention", f"hd{d} {g} sim prefill",
                     flash_check(torch, timer, randn, dt, 1, SIM_PROMPT, SIM_PROMPT, 4,
                                 kv, d, timed=True))
                keep("decode_attention", f"hd{d} {g} serial",
                     decode_check(torch, timer, randn, dt, 1, SIM_SERIAL_T, 4, kv, d,
                                  [SIM_PROMPT + 4], timed=True))
                keep("decode_attention", f"hd{d} {g} arena",
                     decode_check(torch, timer, randn, dt, SIM_SLOTS, SIM_ARENA_T, 4, kv,
                                  d, lens_arena, timed=True))
                for case in ((2, 77, 77, 4, kv, d, True),
                             (2, 100, 300, 4, kv, d, True),
                             (2, 100, 300, 4, kv, d, False),
                             (3, 300, 77, 4, kv, d, False)):
                    flash_check(torch, timer, randn, dt, *case[:6], causal=case[6])
                for lens in ([SK, 2 * SK, SK + 1, 0], [2 * SK + 1, 200 + 7, 5, 200]):
                    decode_check(torch, timer, randn, dt, 4, 200, 4, kv, d, lens, n_units=3)
        for rows in (1, SIM_SLOTS):
            keep("exit_confidence", f"rows{rows} D64 V256",
                 exit_head_check(torch, timer, randn, dt, rows, 64, 256, timed=True))
    for kernel, times in out.items():
        for label, t in times.items():
            log(f"time {kernel} {label} (smoke shapes): kernel {t['ms']} ms "
                f"({t['ms_unspun']} ms unspun, {t['host_us']} us on the host), plain "
                f"{t['plain_ms']} ms, library {t['library_ms']} ms, bound "
                f"{t['bound_ms']} ms ({t['bound_by']})")
    return out


def scan_checks(torch, timer, randn):
    """The SSM scan kernels against their plain version, in both modes, at
    rwkv6-3b's prefill (S 12, and S 1000, ragged against any power-of-two
    tile) and decode (S 1, from a non-zero state) shapes and zamba2-2.7b's
    Mamba-2 shapes (and the Mamba-2 mode with a per-channel decay); at the
    chunk edges S 16, 17, 64 and 65; with random
    decay (w near 0.37 on average), the served model's weak decay
    (log_w = -exp(-6 + 0.5 randn), w near 0.9975, so that the state sums
    rounding over all 1000 tokens) and log_w = -8 everywhere.  Each case
    logs the kernel the wrapper chose.  Then timed in bfloat16 with random
    decay at the served prefill (S 1000 and 12) and decode (S 1) shapes of
    both modes; rwkv6-3b's S 1000 prefill is the record."""
    import repro_torch.config as C
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan import ops as ss_ops
    from repro_torch.kernels.ssm_scan import ref as ss_ref
    from repro_torch.models import mamba2 as M2

    rc, zc = get_config(RWKV), get_config(ZAMBA)
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
                                      ("mamba2", mamba_inputs, 65, "random"),
                                      ("mamba2", mamba_inputs, SHORT_PROMPT, "random"),
                                      ("mamba2", mamba_inputs, 1, "random")):
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
            if dt == torch.bfloat16 and decay == "random" and S in (1, SHORT_PROMPT, LONG_PROMPT):
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
def serving_setup(cfg):
    from repro_torch.core import EdgentPlanner, lm_graph
    from repro_torch.core.latency_model import RooflineLatencyModel
    from repro_torch.data.bandwidth import dcn_trace
    from repro_torch.serving.tiers import Link

    graph = lm_graph(cfg, batch=BATCH, seq=1)
    planner = EdgentPlanner(graph, latency_req_s=0.4).with_models(
        RooflineLatencyModel(chips=8, efficiency=0.4),
        RooflineLatencyModel(chips=1, efficiency=0.4))
    return graph, planner, Link(trace_bps=dcn_trace(0, 2048))


def make_requests(Request, vocab, plan):
    rs = np.random.default_rng(0)
    return [Request(rid=i, prompt=rs.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=NEW_TOKENS, slo_s=slo)
            for i, (n, slo) in enumerate(plan)]


def expected_launches(model, prompts, steps):
    """The launches the serve phase must count, from the model's structure:
    ``prompts`` the prompt length of each batch (one prefill each),
    ``steps`` the number of segments each decode step ran.  A dense layer
    and a shared-attention application are one flash launch in a prefill
    and one decode launch in a step (a two-layer MoE unit, llama4-maverick's,
    two of each); an RWKV-6 or Mamba-2 block is one scan
    launch, chunked in a bfloat16 prefill of at least ssm_ops.CHUNK tokens;
    the exit head picks one token after each prefill and each step."""
    from repro_torch.kernels.ssm_scan import ops as ss_ops
    from repro_torch.models.transformer import unit_size
    cfg, segs = model.cfg, model.segment_lengths()
    attn_every = {"dense": 1, "vlm": 1, "moe": 1,
                  "hybrid": cfg.hybrid_attn_period}.get(cfg.family)
    scans = cfg.family in ("ssm", "hybrid")

    def attn(n_units):
        return n_units * unit_size(cfg) // attn_every if attn_every else 0

    out = {"flash_attention": attn(sum(segs)) * len(prompts),
           "decode_attention": sum(attn(sum(segs[:n])) for n in steps),
           "exit_confidence": len(prompts) + len(steps)}
    if scans:
        chunked = cfg.num_layers * sum(S >= ss_ops.CHUNK for S in prompts)
        stepped = cfg.num_layers * len(prompts) - chunked + sum(sum(segs[:n]) for n in steps)
        out.update({"ssm_scan": chunked + stepped, "ssm_scan.chunked": chunked,
                    "ssm_scan.stepped": stepped})
    return out


def serve_main_path(torch, arch, cfg=None):
    """``ServingEngine.serve`` of ``arch`` (its full config, or ``cfg``, a
    cut of its depth) in bfloat16, its launches held against the model's
    structure.  Returns (params, launch counts)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.serving import Request, ServingEngine

    cfg = cfg or get_config(arch)
    graph, planner, link = serving_setup(cfg)
    short_slo, long_slo = SERVE_SLO[cfg.name, cfg.num_layers]
    # zamba2-2.7b's attention launches are its shared block's, at head dim 80
    require(arch != ZAMBA or cfg.hd == 80, f"serve {arch}: head dim {cfg.hd}, not 80")
    model = Model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init_params(gen, dtype=torch.bfloat16, device="cuda")
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"serve: {cfg.name} ({cfg.family}) layers {cfg.num_layers} d {cfg.d_model} heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} vocab {cfg.padded_vocab} segments "
        f"{model.segment_lengths()} params {n_params / 1e9:.3f} B in bf16")
    engine = ServingEngine(model, params, graph, planner, link, batch_size=BATCH,
                           dtype=torch.bfloat16)
    # 8 short prompts and 4 long ones, whose SLO demotes them (SERVE_SLO)
    log(f"serve: SLOs {short_slo * 1e3:g} ms (short), {long_slo * 1e3:g} ms (long)")
    reqs = make_requests(Request, cfg.vocab_size, [(SHORT_PROMPT, short_slo)] * 8
                         + [(LONG_PROMPT, long_slo)] * 4)
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
    # the segments each decode step runs (the right-sized model's depth)
    steps = []
    stepper = engine.stepper
    decode_fn = stepper.decode_fn

    def counted_decode_fn(graph_exit):
        m = None if graph_exit is None else stepper.to_model_exit(graph_exit)
        steps.append(stepper.n_model if m is None else min(m, stepper.n_model))
        return decode_fn(graph_exit)

    stepper.decode_fn = counted_decode_fn
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
    expected = expected_launches(model, [s for _, s, _ in batches], steps)
    log(f"serve launches expected from the model's structure: {expected} "
        f"(decode steps by segments run: "
        f"{ {n: steps.count(n) for n in sorted(set(steps))} })")
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
    if cfg.padded_vocab > cfg.vocab_size:
        # the head scores every row of the padded embedding, as the
        # reference's does: the config's padding rows are random rows
        past = sum(t >= cfg.vocab_size for v in stats.tokens.values() for t in v)
        log(f"serve {arch}: {past} of {n_tok} tokens in the embedding's padding rows "
            f"[{cfg.vocab_size}, {cfg.padded_vocab})")
    h = engine.last_hidden
    require(h is not None and h.shape[1:] == (1, cfg.d_model)
            and torch.isfinite(h.float()).all().item(), "serve: bad last hidden state")
    for name in PATH_KERNELS[arch]:
        require(counts[name] > 0, f"serve {arch}: kernel {name} was never launched "
                "on the main path")
    for name, n in expected.items():
        require(counts[name] == n, f"serve {arch}: {counts[name]} {name} launches, "
                f"the model's structure gives {n}")
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


def shadowed_scan(launch, worst, widen=False):
    """``launch`` (the scan wrapper), with each call held against the plain
    version on the same inputs (see F32_UNIT); the worst shares of the
    allowed error and the largest error go to ``worst``.  ``widen``: the
    plain version takes the inputs in float32 (a bf16 launch is then held
    against an output that is not rounded to bf16 again)."""
    from repro_torch.kernels.ssm_scan import ref as ss_ref

    def scan(q, k, v, log_w, state, u=None):
        o, s = launch(q, k, v, log_w, state, u=u)
        w = (lambda t: t.float()) if widen else (lambda t: t)
        po, ps = ss_ref.ssm_scan(w(q), w(k), w(v), log_w, state, u=u)
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


def kernel_vs_plain(torch, params_bf16, arch, cfg=None):
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
    path from the same path with a float64 scan.  ``cfg``: a cut of the
    depth of ``arch``'s config, whose (float32) parameters are given."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssm_scan import ops as ss_ops
    from repro_torch.models import Model
    from repro_torch.models import linear_scan
    from repro_torch.serving import Request, ServingEngine

    cfg = cfg or get_config(arch)
    params = _to_f32(params_bf16)
    impls = ("kernel", "dense") + (() if END_TO_END[arch] else ("float64 scan",))
    short_slo, long_slo = SERVE_SLO[cfg.name, cfg.num_layers]
    for label, plan in (("12-token", [(SHORT_PROMPT, short_slo)] * BATCH),
                        ("1000-token demoted", [(LONG_PROMPT, long_slo)] * BATCH)):
        runs = {}
        worst = {"calls": 0, "o": 0.0, "state": 0.0, "err": 0.0, "tokens": 0}
        for impl in impls:
            graph, planner, link = serving_setup(cfg)
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
        log(f"kernel path ({arch}, f32, full width, {cfg.num_layers} layers, {label}): "
            f"{worst['calls']} scan launches held against the plain scan on their inputs, "
            f"o max_abs_err {worst['err']:.3g}, worst err/allowed o {worst['o']:.3g} state "
            f"{worst['state']:.3g}; {worst['tokens']} tokens held against the plain head on "
            "the same hidden state")
        for a, b in (("kernel", "dense"), ("dense", "float64 scan"),
                     ("kernel", "float64 scan")):
            if b not in runs:
                continue
            _, pa, _, ha, _ = runs[a]
            _, pb, mb, hb, _ = runs[b]
            flips, e = divergence((pa, ha), (pb, hb), mb)
            log(f"{a} vs {b} path ({arch}, f32, full width, {cfg.num_layers} layers, "
                f"{label}): {len(pb)} token steps x {hb.shape[0]} rows, decode variants {vk}, "
                f"last exit {sk.exits[-1]}, first flip (step, {b} top-2 margin) by row "
                f"{ {r: (st, round(m, 6)) for r, (st, m) in sorted(flips.items())} }, "
                f"last hidden max_abs_err {e:.3g} on the other rows (tol {HIDDEN_TOL}), "
                f"min {b} margin {min(min(m) for m in mb):.3g}")
            if END_TO_END[arch] and (a, b) == ("kernel", "dense"):
                require(all(m < MARGIN_TOL for _, m in flips.values()),
                        f"{label}: a token differs where the plain path's margin is "
                        "above tolerance")
                require(not e > HIDDEN_TOL, f"{label}: last hidden states differ by {e}")


# ---------------------------------------------------------------- phases 10-11
# The fleet with real decode: the arena suite's static scenario
# (tests/test_arena.py::_static_spec; seed 3, 8 devices, 2 edges of 8 slots,
# the lte trace, 10 Hz over FLEET_HORIZON seconds, two tenants of 6 and 10
# new tokens, bandwidth-aware routing, deadline demotion on), with
# FLEET_PROMPT-token prompts, served at full width through FleetEngine.
FLEET_PROMPT = 64
# zamba2-2.7b's horizon is cut to keep the script's time: its serial path
# takes ~0.06 s a token; so are phase 19's (the families and starcoder2-15b,
# whose serial paths take more a token than llama3.2-1b's)
FLEET_HORIZON = {LLAMA: 4.0, ZAMBA: 3.0, SCOUT: 2.0, LLAVA: 1.5, STARCODER: 1.5}
FLEET_STRATEGIES = {LLAMA: ("serial", "batched", "arena"), ZAMBA: ("serial", "arena"),
                    SCOUT: ("serial", "arena"), LLAVA: ("serial", "arena"),
                    STARCODER: ("serial", "arena")}
# the arena's slots (the edges' capacity) and its length: prompt + the larger
# token budget + 1, rounded up to a power of two
ARENA_SLOTS, ARENA_LEN = 8, 128
PROFILE_STEPS = 5
# the kernels a fleet path launches: the fleet takes each token from the
# model-dtype logits, as the reference's fleet does, not from the exit head
FLEET_KERNELS = {LLAMA: ("flash_attention", "decode_attention"),
                 ZAMBA: ("flash_attention", "decode_attention", "ssm_scan"),
                 SCOUT: ("flash_attention", "decode_attention"),
                 LLAVA: ("flash_attention", "decode_attention"),
                 STARCODER: ("flash_attention", "decode_attention")}


def fleet_spec(arch):
    from repro_torch.fleet.workload import TenantClass
    from repro_torch.sim import (PlannerSpec, RouterSpec, ScenarioSpec,
                                 TopologySpec, WorkloadSpec)
    tenants = (TenantClass("interactive", slo_s=1.0, max_new_tokens=6, weight=0.5),
               TenantClass("standard", slo_s=2.0, max_new_tokens=10, weight=0.5))
    return ScenarioSpec(
        name=f"arena-{arch}", seed=3, planner=PlannerSpec(arch=arch),
        topology=TopologySpec(num_devices=8, num_edges=2, trace="lte",
                              edge_capacity=ARENA_SLOTS, max_edge_slowdown=2.0),
        workload=WorkloadSpec(rate_hz=10.0, horizon_s=FLEET_HORIZON[arch],
                              device_skew=0.5, prompt_len=FLEET_PROMPT,
                              tenants=tenants),
        router=RouterSpec(name="bandwidth-aware"))


def fleet_engine(arch, model, params, dtype, strategy, **observers):
    """The spec's fleet, planned as ``repro_torch.sim.build_stack`` plans
    (the full config's graph), on ``model``: a ``FleetEngine`` and its
    workload (prompts over the full vocab).  ``observers`` (``tracer``,
    ``timeline``, ``profiler``) go to the engine."""
    from repro_torch.fleet import FleetEngine
    from repro_torch.sim.build import build_planner, build_topology, build_workload

    spec = fleet_spec(arch)
    seeds = spec.seeds()
    graph, planner = build_planner(model.cfg, spec.planner)
    topo, _ = build_topology(spec.topology, seeds.topology)
    workload = build_workload(spec.workload, topo, seeds.workload, model.cfg.vocab_size)
    engine = FleetEngine(topo, graph, planner, router=spec.router.name, model=model,
                         params=params, dtype=dtype,
                         batch_decode=strategy == "batched",
                         arena_decode=strategy == "arena", **observers)
    return engine, workload


def record_calls(model):
    """Wrap ``model``'s prefill and decode step to log each prefill's prompt
    length and the segments each decode call runs (what
    ``expected_launches`` takes)."""
    calls = {"prompts": [], "steps": []}
    prefill, decode = model.prefill, model.decode_step
    n_seg = model.num_segments

    def rec_prefill(params, tokens, cache, **kw):
        calls["prompts"].append(tokens.shape[1])
        return prefill(params, tokens, cache, **kw)

    def rec_decode(params, cache, tokens, pos, *, exit_point=None, **kw):
        calls["steps"].append(n_seg if exit_point is None else exit_point + 1)
        return decode(params, cache, tokens, pos, exit_point=exit_point, **kw)

    model.prefill, model.decode_step = rec_prefill, rec_decode
    return calls


def record_margins(engine):
    """Per request, the top-2 logit margin of each token the engine's serial
    path picks (after its prefill, then after each decode step)."""
    margins = {}
    argmax, prefill, decode = engine._argmax, engine._prefill_real, engine._decode_real

    def rec(h):
        top2 = engine.model.logits(engine.params, h)[:, -1].float().topk(2, dim=-1).values
        rec.last = (top2[:, 0] - top2[:, 1]).tolist()[0]
        return argmax(h)

    def pre(req):
        prefill(req)
        margins[req.rid] = [rec.last]

    def dec(req):
        decode(req)
        margins[req.rid].append(rec.last)

    engine._argmax, engine._prefill_real, engine._decode_real = rec, pre, dec
    return margins


def hold_masked_rows(torch, stepper, held):
    """Hold every arena call of ``stepper``: the rows outside its mask leave
    the call bit for bit as they entered it, in every cache leaf."""
    from repro_torch.serving.arena import tree_leaves
    inner = stepper.decode_fn_arena

    def fn_for(graph_exit, arena):
        fn = inner(graph_exit, arena)

        def run(p, cache, tok, pos, mask):
            keep = ~mask
            before = [leaf[:, keep].clone() for leaf in tree_leaves(cache)]
            h, new = fn(p, cache, tok, pos, mask)
            for b, leaf in zip(before, tree_leaves(new)):
                require(torch.equal(b, leaf[:, keep]), "arena: a call changed a row "
                        "outside its mask")
            held["calls"] += 1
            held["rows"] += int(keep.sum())
            held["leaves"] = len(before)
            return h, new
        return run

    stepper.decode_fn_arena = fn_for


def streams_held(label, want, got, margins):
    """``got``'s token streams equal ``want``'s request by request, except
    from a decode step whose own serial token was a near-tie (``margins``:
    prefill first, so step k's is ``margins[k + 1]``; the prefill is one
    B=1 path in every strategy and excuses nothing); returns (tokens
    compared equal, tokens, parted requests)."""
    equal = total = 0
    parted = {}
    require(want.keys() == got.keys(), f"{label}: other requests")
    for rid, w in want.items():
        g = got[rid]
        require(len(g) == len(w), f"{label}: request {rid} got {len(g)} tokens, not {len(w)}")
        k = next((j for j, (a, b) in enumerate(zip(w, g)) if a != b), None)
        if k is not None:
            m = margins[rid][k + 1]
            parted[rid] = (k, m)
            require(m < MARGIN_TOL, f"{label}: request {rid} token {k} is {g[k]}, the "
                    f"serial path's {w[k]} at top-2 margin {m}")
        equal += len(w) if k is None else k
        total += len(w)
    return equal, total, parted


def fleet_phase(torch, arch):
    """Phase 10 (llama3.2-1b), 11 (zamba2-2.7b) or 19 (scout, llava's text
    backbone, starcoder2-15b): the fleet with real decode at full width,
    through each decode strategy in bfloat16 (timed after a warm-up run),
    then serial against arena in float32, held (at the depths of
    CUT_LAYERS; an MoE's tokens dropped past capacity counted).  Returns
    the launches of the timed bf16 runs and the observed run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.exit_head import ops as eh_ops
    from repro_torch.models import Model

    cfg, cfg32 = family_config(arch), family_config(arch, "f32")
    model = Model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init_params(gen, dtype=torch.bfloat16, device="cuda")
    calls = record_calls(model)
    spec = fleet_spec(arch)
    log(f"fleet {arch}: {cfg.num_layers} layers ({cfg32.num_layers} in float32) d "
        f"{cfg.d_model} heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads} of {cfg.hd} vocab {cfg.padded_vocab}, segments "
        f"{model.segment_lengths()}; {spec.topology.num_devices} devices, "
        f"{spec.topology.num_edges} edges of {ARENA_SLOTS} slots, {spec.workload.rate_hz} Hz "
        f"over {spec.workload.horizon_s} s, prompts of {FLEET_PROMPT}, tenants "
        f"{[(t.name, t.max_new_tokens, t.slo_s) for t in spec.workload.tenants]}")
    engines, launches = {}, {}
    head = {"tokens": 0, "differ": 0, "margins": []}
    for strategy in FLEET_STRATEGIES[arch]:
        engine, workload = fleet_engine(arch, model, params, torch.bfloat16, strategy)
        if arch == LLAMA and strategy == "serial":
            # the exit-head kernel's token against the fleet's model-dtype
            # argmax, on the same hidden states (the warm-up run only)
            argmax = engine._argmax

            def both(h, argmax=argmax):
                tok = argmax(h)
                kt = eh_ops.exit_confidence(h, params["embed"])["token"][:, -1]
                diff = (kt != tok).nonzero().flatten().tolist()
                head["tokens"] += tok.numel()
                head["differ"] += len(diff)
                if diff:
                    top2 = model.logits(params, h)[:, -1].float().topk(2, dim=-1).values
                    head["margins"] += [(top2[r, 0] - top2[r, 1]).item() for r in diff]
                return tok
            engine._argmax = both
        engine.run(workload)                                   # warm-up
        engine.__dict__.pop("_argmax", None)
        engines[strategy] = (engine, workload)
    if head["tokens"]:
        log(f"fleet {arch} bf16 serial: the exit-head kernel's token differs from the "
            f"model-dtype argmax in {head['differ']} of {head['tokens']} tokens "
            f"(bf16 top-2 margins there: {head['margins']})")
    # one timed run of each strategy, after its warm-up run
    walls, runs = {}, {}
    for strategy, (engine, workload) in engines.items():
        torch.cuda.synchronize()
        calls["prompts"].clear()
        calls["steps"].clear()
        reset_launch_counts()
        t0 = time.perf_counter()
        metrics = engine.run(workload)
        torch.cuda.synchronize()
        walls[strategy] = time.perf_counter() - t0
        counts = launch_counts()
        expected = expected_launches(model, list(calls["prompts"]), list(calls["steps"]))
        log(f"fleet {arch} bf16 {strategy}: {len(workload)} requests, "
            f"{len(calls['prompts'])} prefills, {len(calls['steps'])} decode calls "
            f"by segments run "
            f"{ {n: calls['steps'].count(n) for n in sorted(set(calls['steps']))} }; "
            f"launches {counts}, expected {expected}")
        require(counts["exit_confidence"] == 0, f"fleet {arch}: the exit head ran on "
                "the fleet path")
        for name in FLEET_KERNELS[arch]:
            require(counts[name] > 0, f"fleet {arch} {strategy}: {name} never launched")
            for key in [k for k in expected if k.split(".")[0] == name]:
                require(counts[key] == expected[key], f"fleet {arch} {strategy}: "
                        f"{counts[key]} {key} launches, the calls give {expected[key]}")
        for name in counts:
            launches[name] = launches.get(name, 0) + counts[name]
        runs[strategy] = (metrics.summary(), {r.rid: list(r.tokens) for r in workload})
    serial_summary, serial_toks = runs["serial"]
    total = sum(len(v) for v in serial_toks.values())
    for strategy, (summary, toks) in runs.items():
        st = engines[strategy][0].stepper.cache_stats()
        agree = sum(a == b for rid in toks for a, b in zip(toks[rid], serial_toks[rid]))
        wall = walls[strategy]
        log(f"fleet {arch} bf16 {strategy}: {total / wall:.1f} decode tokens/s ({total} "
            f"tokens in {wall:.4f} s after a warm-up run, CUDA-synchronised, prefill "
            f"included); {agree} of "
            f"{total} tokens equal to serial; decode {st['decode']} arena {st['arena']} "
            f"variants {st['jit']['variants']}")
        require(summary == serial_summary, f"fleet {arch}: the {strategy} summary differs "
                "from the serial one (virtual time must not depend on the strategy)")
        if strategy == "arena":
            require(st["arena"]["calls"] > 0, f"fleet {arch}: no arena call")
    del engines, engine

    # -- float32: serial against arena, held
    if cfg32 == cfg:
        params32 = _to_f32(params)
        del params
    else:
        del params
        gc.collect()
        torch.cuda.empty_cache()
        model = Model(cfg32)
        params32 = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                                     dtype=torch.float32, device="cuda")
        log(f"fleet {arch} f32: reduced to {cfg32.num_layers} of its "
            f"{get_config(arch).num_layers} layers, parameters from seed 0 in float32, "
            f"segments {model.segment_lengths()}")
    torch.cuda.empty_cache()
    engine, workload = fleet_engine(arch, model, params32, torch.float32, "serial")
    margins = record_margins(engine)
    drops = {}
    with moe_drops(torch, drops) if cfg.num_experts else contextlib.nullcontext():
        m_serial = engine.run(workload)
    if drops:
        log(f"fleet {arch} f32 serial: MoE tokens dropped past capacity by tokens a call "
            f"(dropped, routed): {drops}")
    t_serial = {r.rid: list(r.tokens) for r in workload}
    del engine
    engine, workload = fleet_engine(arch, model, params32, torch.float32, "arena")
    held = {"calls": 0, "rows": 0}
    hold_masked_rows(torch, engine.stepper, held)
    m_arena = engine.run(workload)
    t_arena = {r.rid: list(r.tokens) for r in workload}
    st = engine.stepper.cache_stats()
    equal, total, parted = streams_held(f"fleet {arch} f32", t_serial, t_arena, margins)
    least = min(min(m) for m in margins.values())
    log(f"fleet {arch} f32 arena vs serial: {equal} of {total} tokens equal, parted "
        f"(request: step, serial margin) {parted}, least serial margin {least:.3g}; "
        f"{held['calls']} arena calls held {held['rows']} rows outside their masks bit for "
        f"bit over {held.get('leaves')} cache leaves; arena {st['arena']} decode "
        f"{st['decode']} variants {st['jit']['variants']}")
    require(json.dumps(m_arena.summary(), sort_keys=True)
            == json.dumps(m_serial.summary(), sort_keys=True),
            f"fleet {arch} f32: the arena summary differs from the serial one")
    ar = st["arena"]
    require(ar["admits"] == ar["evicts"] > 0, f"fleet {arch}: admits {ar['admits']}, "
            f"evicts {ar['evicts']}")
    require(st["decode"]["padded_rows"] == 0 and st["decode"]["batched_calls"] == 0,
            f"fleet {arch}: the arena run padded or batched: {st['decode']}")
    require(0 < st["jit"]["variants"]["arena"] <= model.num_segments,
            f"fleet {arch}: {st['jit']['variants']['arena']} arena variants for "
            f"{model.num_segments} model exits")
    require(held["calls"] == ar["calls"] and held["rows"] > 0,
            f"fleet {arch}: {held['calls']} of {ar['calls']} arena calls held")
    log(f"fleet {arch}: summary {m_serial.summary()}")
    del engine
    if arch == LLAMA:
        for name, n in observed_fleet(torch, arch, model, params32, m_arena,
                                      t_arena).items():
            launches[name] = launches.get(name, 0) + n
    # the engines' wrapped methods (record_margins, hold_masked_rows) close
    # over the engine: collect the cycles, so that the parameters go now
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def observed_fleet(torch, arch, model, params, m_want, t_want):
    """Phase 17 at full width: the float32 arena fleet of phase 10 again,
    with a ``Tracer``, a ``Timeline`` and a ``SimProfiler`` attached.  Its
    summary, handover log and tokens must equal the unobserved run's (which
    the arena's masked-row hold only reads) bit for bit, and its trace must
    be valid.  The profiler's walls are host walls, taken before any
    ``torch.profiler`` session.  Returns the run's launch counts."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import SimProfiler, Timeline, Tracer, validate_trace

    topo = fleet_spec(arch).topology
    tracer, profiler = Tracer(), SimProfiler()
    timeline = Timeline(topo.num_edges, num_devices=topo.num_devices)
    engine, workload = fleet_engine(arch, model, params, torch.float32, "arena",
                                    tracer=tracer, timeline=timeline,
                                    profiler=profiler)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    m = engine.run(workload)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    toks = {r.rid: list(r.tokens) for r in workload}
    require(json.dumps(m.summary(), sort_keys=True)
            == json.dumps(m_want.summary(), sort_keys=True),
            f"phase 17: {arch} observed summary differs from the unobserved run")
    require(m.handover_log == m_want.handover_log,
            f"phase 17: {arch} observed handover log differs")
    require(toks == t_want, f"phase 17: {arch} observed tokens differ")
    for name in FLEET_KERNELS[arch]:
        require(counts[name] > 0, f"phase 17: {arch} observed run launched no {name}")
    doc = tracer.to_chrome()
    problems = validate_trace(doc)
    require(not problems, f"phase 17: {arch} trace invalid: {problems[:5]}")
    rep = profiler.report(engine)
    by_kind = {k: (b["count"], b["wall_s"]) for k, b in rep["events"].items()}
    log(f"phase 17: {arch} full width f32 arena fleet observed (tracer, timeline, "
        f"profiler): summary, handover log ({len(m.handover_log)}) and "
        f"{sum(len(v) for v in toks.values())} tokens bit-identical to the unobserved "
        f"run; trace valid, {len(doc['traceEvents'])} events; timeline "
        f"{timeline.num_retained} samples; launches {counts}; run wall {wall:.4f} s, "
        f"profiler wall {rep['wall_s']} s, peak heap {rep['peak_heap']}; per event "
        f"kind (count, wall s): {by_kind}")
    return counts


def arena_steps(torch, arch):
    """One full-depth arena call at ARENA_SLOTS active slots (the call, the
    batched logits/argmax epilogue and the host read of the tokens), and
    one serial B=1 step, on ``arch`` in bfloat16: ``{label: (step, rows)}``."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving.arena import DecodeArena
    from repro_torch.serving.engine import CoInferenceStepper
    from repro_torch.sim.build import build_planner

    cfg = get_config(arch)
    model = Model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init_params(gen, dtype=torch.bfloat16, device="cuda")
    graph, planner = build_planner(cfg, fleet_spec(arch).planner)
    stepper = CoInferenceStepper(model, graph, planner)
    arena = DecodeArena(model, slots=ARENA_SLOTS, length=ARENA_LEN, dtype=torch.bfloat16,
                        stepper=stepper, device="cuda")
    rng = np.random.default_rng(0)
    n_steps = 2 + 3 * PROFILE_STEPS

    def argmax(h):
        return torch.argmax(model.logits(params, h)[:, -1], -1).to(torch.int32)[:, None]

    toks, serial = [], None
    for s in range(ARENA_SLOTS):
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, FLEET_PROMPT))
                                  .astype(np.int32)).cuda()
        cache = model.init_cache(1, FLEET_PROMPT + n_steps + 1, dtype=torch.bfloat16,
                                 device="cuda")
        h, cache = model.prefill(params, prompt, cache)
        toks.append(argmax(h))
        arena.admit(s, cache)
        serial = serial or {"cache": cache, "tok": toks[-1], "pos": FLEET_PROMPT}
    state = {"tok": torch.cat(toks), "pos": FLEET_PROMPT}
    decode = stepper.decode_fn(None)

    def arena_step():
        items = [(None, s, state["tok"][s:s + 1], state["pos"]) for s in range(ARENA_SLOTS)]
        (_, h_all), = stepper.decode_step_arena(params, arena, items)
        state["tok"] = argmax(h_all)
        state["tok"][:, 0].tolist()
        state["pos"] += 1

    def serial_step():
        h, serial["cache"] = decode(params, serial["cache"], serial["tok"], serial["pos"])
        serial["tok"] = argmax(h)
        serial["tok"][:, 0].tolist()
        serial["pos"] += 1

    return {"arena": (arena_step, ARENA_SLOTS), "serial": (serial_step, 1)}


def arena_profile(torch, archs):
    """The device idle share of one full-depth arena call at ARENA_SLOTS
    active slots beside a serial B=1 step (``arena_steps``), measured as
    ``tools/serve_profile.py`` measures a step: the median host-clock wall
    of PROFILE_STEPS CUDA-synchronised steps, and the device time of
    PROFILE_STEPS more from ``torch.profiler``.  Every wall is taken before
    the process's first profiler session; the walls after the sessions are
    logged beside them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def walls_ms(step):
        walls = []
        for _ in range(PROFILE_STEPS):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return walls

    def device_ms(step):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_STEPS):
                step()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation and e.self_device_time_total > 0]
        return (sum(e.self_device_time_total for e in kernels) / 1e3 / PROFILE_STEPS,
                sum(e.count for e in kernels) / PROFILE_STEPS)

    steps = {(arch, label): v for arch in archs
             for label, v in arena_steps(torch, arch).items()}
    for step, _ in steps.values():
        for _ in range(2):
            step()
    torch.cuda.synchronize()
    before = {key: walls_ms(step) for key, (step, _) in steps.items()}
    traced = {key: device_ms(step) for key, (step, _) in steps.items()}
    after = {key: walls_ms(step) for key, (step, _) in steps.items()}
    for (arch, label), (_, rows) in steps.items():
        wall = statistics.median(before[arch, label])
        dev, n_kernels = traced[arch, label]
        r = {
            "wall_ms": wall, "device_ms": dev, "idle_share": 1.0 - dev / wall,
            "kernels": n_kernels, "tokens_per_s": rows / wall * 1e3,
            "wall_ms_after_profiler": statistics.median(after[arch, label])}
        log(f"profile {arch} full-depth {label} step, {rows} active row(s) of {rows}: "
            f"{wall:.2f} ms wall (median of {[round(w, 2) for w in before[arch, label]]}), "
            f"{dev:.3f} ms of kernels on the device, idle share {r['idle_share']:.3f}, "
            f"{n_kernels:.0f} kernels, {r['tokens_per_s']:.1f} tokens/s; after the "
            f"profiler sessions {r['wall_ms_after_profiler']:.2f} ms wall")
        require(dev > 0, f"profile {arch} {label}: no device time traced")
    del steps
    torch.cuda.empty_cache()


def arena_kernel_times(torch, arch):
    """The decode-attention kernel (and for zamba2-2.7b the stepped Mamba-2
    scan) at the arena's shapes (starcoder2-15b's: G 12): checked against its plain version with
    masked rows of length 1 among them, then timed with ARENA_SLOTS active
    rows beside its plain version, SDPA and its bound: ``{kernel: times}``."""
    import torch.nn.functional as F

    import repro_torch.config as C
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.ssm_scan import ops as ss_ops
    from repro_torch.kernels.ssm_scan import ref as ss_ref
    from repro_torch.models import mamba2 as M2

    cfg = get_config(arch)
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    gen = torch.Generator(device="cuda").manual_seed(8)
    timer = Timer(torch)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    B, T = ARENA_SLOTS, ARENA_LEN
    n_units = cfg.num_layers // cfg.hybrid_attn_period if arch == ZAMBA else 2
    active = [FLEET_PROMPT + 1 + i for i in range(B)]
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        for lens in ([1, active[1], 1, 1, active[4], 1, 1, 1], active):
            ck, cv = randn(n_units, B, T, kv, d, dtype=dt), randn(n_units, B, T, kv, d, dtype=dt)
            kc, vc = ck[n_units // 2], cv[n_units // 2]
            q = randn(B, 1, h, d, dtype=dt)
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            o = fa_ops.decode_attention(q, kc, vc, lengths)
            torch.cuda.synchronize()
            qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
            plain = fa_ref.decode_attention(qt.float(), kt.float(), vt.float(),
                                            lengths).transpose(1, 2)
            diff = (o.float() - plain).abs()
            share = (diff / (ATTN_ATOL + ATTN_RTOL[str(dt)] * plain.abs())).max().item()
            log(f"check decode_attention {dt} arena B{B} T{T} H{h} KV{kv} hd{d} lengths "
                f"{lens}: max_abs_err {diff.max().item():.3g}, worst err/allowed {share:.3g}")
            require(torch.isfinite(o).all().item() and share <= 1.0,
                    f"decode_attention at the arena shape disagrees: {share}")
            if dt == torch.bfloat16 and lens == active:
                qc, kcc, vcc = (x.contiguous() for x in (qt, kt, vt))
                mask = (torch.arange(T, device="cuda")[None, :] < lengths[:, None])[:, None, None]
                t = dict(**timer.kernel(lambda: fa_ops.decode_attention(q, kc, vc, lengths)),
                         plain_ms=timer.ms(lambda: fa_ref.decode_attention(qt, kt, vt, lengths)),
                         library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                             qc, kcc, vcc, attn_mask=mask, enable_gqa=True)))
                n_keys = sum(lens)
                nbytes = (2 * q.numel() + 2 * n_keys * kv * d) * q.element_size() + 4 * B
                t["bound_ms"], t["bound_by"] = bound(nbytes, 4 * h * d * n_keys, dt, C)
                t.update(max_abs_err=diff.max().item(), dtype=str(dt),
                         shape=f"B{B} T{T} H{h} KV{kv} hd{d} lengths {lens[0]}-{lens[-1]}")
                log(f"time decode_attention arena {arch} {t}")
                out["decode_attention"] = t
    if arch == ZAMBA:
        Hm, N = M2.n_heads(cfg), cfg.ssm_state
        for dt in (torch.bfloat16, torch.float32):
            bc, cc = randn(B, 1, N, dtype=dt), randn(B, 1, N, dtype=dt)
            lw = -torch.exp(randn(B, 1, Hm, dtype=torch.float32, scale=0.5))
            args = (cc[:, :, None].expand(B, 1, Hm, N), bc[:, :, None].expand(B, 1, Hm, N),
                    randn(B, 1, Hm, M2.DH, dtype=dt), lw[..., None].expand(B, 1, Hm, N),
                    randn(B, Hm, N, M2.DH, dtype=torch.float32, scale=0.1), None)
            o, s = ss_ops.ssm_scan(*args)
            torch.cuda.synchronize()
            q_, k_, v_, lw_, s0, _ = args
            po, ps = ss_ref.ssm_scan(q_.float(), k_.float(), v_.float(), lw_, s0)
            diff = (o.float() - po).abs()
            share = (diff / (SCAN_ATOL + ATTN_RTOL[str(dt)] * po.abs())).max().item()
            sshare = ((s - ps).abs() / (SCAN_ATOL + STATE_RTOL * ps.abs())).max().item()
            log(f"check ssm_scan {dt} arena mamba2 B{B} S1 H{Hm} ({ss_ops.route(q_, v_)}): "
                f"o max_abs_err {diff.max().item():.3g}, worst err/allowed {share:.3g}; "
                f"state worst {sshare:.3g}")
            require(share <= 1.0 and sshare <= 1.0, "ssm_scan at the arena shape disagrees")
            if dt == torch.bfloat16:
                t = dict(**timer.kernel(lambda: ss_ops.ssm_scan(*args)),
                         plain_ms=timer.ms(lambda: ss_ref.ssm_scan(*args)), library_ms=None)
                nbytes = sum(distinct_bytes(x) for x in (q_, k_, v_, lw_, s0, o, s))
                t["bound_ms"], t["bound_by"] = bound(nbytes, 6 * B * Hm * N * M2.DH, dt, C)
                t.update(max_abs_err=diff.max().item(), dtype=str(dt),
                         shape=f"mamba2 B{B} S1 H{Hm} dk{N} dv{M2.DH}")
                log(f"time ssm_scan arena {arch} {t}")
                out["ssm_scan"] = t
    del timer
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phases 12-13
# The paper's own Edgent path on BranchyAlexNet (Fig. 4) at its full, paper
# size (CIFAR-10 scale, 5 exits), in float32 with TF32 off.  Stated
# tolerances:
#  * the card against the CPU, layer by layer from the same input and at
#    each exit's logits: |card - cpu| <= ALEX_ATOL + ALEX_RTOL |cpu|.  A
#    convolution sums up to 864 float32 products in another order on each
#    side (and cuDNN may take a Winograd or FFT algorithm); every other
#    layer computes the same formula.  The CPU tests hold the port against
#    the reference at 1e-5 a layer and 1e-4 at the logits.  A prediction
#    may differ only where the CPU's top-2 logit margin is below MARGIN_TOL;
#  * an executed plan against forward_exit on the card: the same tolerance
#    and the same argmax; its transfer time equals its bytes over the
#    bandwidth and its latency the sum of its parts, exactly.
ALEX_ATOL = ALEX_RTOL = 1e-4
ALEX_IMAGES, ALEX_NOISE, ALEX_DATA_SEED = 1024, 1.4, 99
ALEX_SLO = 1.0
ALEX_KBPS = (50, 100, 250, 500, 1000)         # examples/quickstart.py's
KBPS = 125                                    # bytes/s in one kbps


def alex_exit_logits(net, params, x):
    """Logits at every exit: each side branch runs from the main branch's
    activation at its prefix (forward_exit's layers, no prefix run twice)."""
    acts = [x]
    for i in range(len(net.main)):
        acts.append(net.run_layers(params, acts[-1], net.main, i, i + 1))
    return [net.run_layers(params, acts[prefix], side)
            for prefix, side in net.sides] + [acts[-1]]


def held_close(torch, label, got, want):
    """|got - want| <= ALEX_ATOL + ALEX_RTOL |want| element by element;
    returns the largest |got - want|."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    require(got.shape == want.shape,
            f"{label}: shape {tuple(got.shape)}, want {tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), f"{label}: non-finite values")
    err = (got - want).abs()
    worst = float(err.max()) if err.numel() else 0.0
    require(bool((err <= ALEX_ATOL + ALEX_RTOL * want.abs()).all()),
            f"{label}: max |difference| {worst:.3e} over the stated tolerance")
    return worst


def held_plan(torch, net, graph, params, x, plan, res, bw):
    """An executed plan: its output is forward_exit's on the same input,
    its transfer its bytes over ``bw``, its latency the sum of its parts."""
    label = f"plan (exit {plan.exit_point}, partition {plan.partition}) at {bw:.1f} B/s"
    with torch.no_grad():
        want = net.forward_exit(params, x, plan.exit_point)
    held_close(torch, label, res.output, want)
    require(torch.equal(res.output.argmax(-1), want.argmax(-1)), f"{label}: argmax differs")
    p = plan.partition
    transfer = (graph.input_bytes / bw + graph.cut_bytes(plan.exit_point, p) / bw
                if p > 0 else 0.0)
    require((res.exit_point, res.partition) == (plan.exit_point, p), f"{label}: ran another plan")
    require(res.transfer_s == transfer, f"{label}: transfer {res.transfer_s!r}, want {transfer!r}")
    require(res.latency_s == res.edge_s + res.device_s + res.transfer_s + res.hops_s,
            f"{label}: latency is not the sum of its parts")


def plan_str(plan):
    return (f"exit {plan.exit_point} partition {plan.partition:2d} "
            f"latency {plan.latency_s * 1e3:8.2f} ms feasible {plan.feasible}")


def edgent_phase(torch):
    """Phase 12: BranchyAlexNet held on the card against the CPU, then
    examples/quickstart.py's static pipeline and
    examples/serve_dynamic_bandwidth.py's dynamic one, every plan executed
    by the two-tier executor on the card.  Returns the graph and the
    card's static plans at ALEX_KBPS."""
    from repro_torch.configs import get_alexnet_config
    from repro_torch.core import EdgentPlanner, alexnet_graph
    from repro_torch.core.coinference import TwoTierExecutor
    from repro_torch.core.profiler import profile_all_branches
    from repro_torch.data.bandwidth import MBPS, belgium_lte_like, oboe_like_traces
    from repro_torch.data.synthetic import cifar_like
    from repro_torch.models.alexnet import BranchyAlexNet, apply_layer

    net = BranchyAlexNet(get_alexnet_config())
    params = net.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    params_cpu = {name: {k: v.cpu() for k, v in layer.items()}
                  for name, layer in params.items()}
    graph = alexnet_graph(net)
    x_np, _ = cifar_like(np.random.default_rng(ALEX_DATA_SEED), ALEX_IMAGES,
                         noise=ALEX_NOISE)
    x = torch.from_numpy(x_np).cuda()

    # -- every layer of every branch, card against CPU, from the same input
    worst, seen = {}, set()
    with torch.no_grad():
        for e in range(1, net.num_exits + 1):
            h = x
            for spec in net.branch_layers(e):
                y = apply_layer(spec, params.get(spec.name, {}), h)
                if spec.name not in seen:
                    seen.add(spec.name)
                    y_cpu = apply_layer(spec, params_cpu.get(spec.name, {}), h.cpu())
                    worst[spec.name] = held_close(torch, f"layer {spec.name}", y, y_cpu)
                h = y
        torch.cuda.synchronize()
        log(f"phase 12: {len(worst)} layers held card against CPU at {ALEX_IMAGES} images; "
            f"max |difference| {max(worst.values()):.3e} ({max(worst, key=worst.get)}); "
            f"by layer {{{', '.join(f'{k}: {v:.1e}' for k, v in worst.items())}}}")

        # -- each exit's logits, chained on each side
        cpu_logits = alex_exit_logits(net, params_cpu, x.cpu())
        for e in range(1, net.num_exits + 1):
            card = net.forward_exit(params, x, e)
            err = held_close(torch, f"exit {e} logits", card, cpu_logits[e - 1])
            top2 = cpu_logits[e - 1].topk(2, dim=-1).values
            margins = top2[:, 0] - top2[:, 1]
            flips = torch.nonzero(card.cpu().argmax(-1) != cpu_logits[e - 1].argmax(-1))
            for i in flips.flatten().tolist():
                log(f"phase 12: exit {e} image {i}: prediction flipped at CPU top-2 "
                    f"margin {float(margins[i]):.3e}")
                require(float(margins[i]) < MARGIN_TOL,
                        f"exit {e} image {i}: prediction flipped at margin "
                        f"{float(margins[i]):.3e} >= {MARGIN_TOL}")
            log(f"phase 12: exit {e} logits [{ALEX_IMAGES}, 10] max |card - cpu| "
                f"{err:.3e}, {len(flips)} prediction(s) flipped")

    # -- the static pipeline (examples/quickstart.py) on the card
    x1 = torch.randn((1, 32, 32, 3), generator=torch.Generator(device="cuda").manual_seed(1),
                     device="cuda")
    planner = EdgentPlanner(graph, latency_req_s=ALEX_SLO).offline_static(params, x1)
    host_full = 0.010 / planner.edge_factor       # offline_static's calibrate_to edge
    log(f"phase 12: offline_static on the card: host_full {host_full * 1e3:.4f} ms "
        f"(main branch), edge_factor {planner.edge_factor:.4f}, device_factor "
        f"{planner.device_factor:.2f}, R^2 {planner.f_edge.r2()}")
    profiles = profile_all_branches(graph, params, x1)
    main = {layer.name for layer in graph.branches[-1]}
    log("phase 12: Fig. 3 on the card (a second profile_all_branches, batch 1): "
        + ", ".join(f"{p.name} {p.latency_s * 1e6:.1f} us {p.out_bytes} B"
                    for p in profiles if p.name in main))
    log(f"phase 12: that profile's main branch {sum(p.latency_s for p in profiles if p.name in main) * 1e3:.4f} ms; "
        "side layers " + ", ".join(f"{p.name} {p.latency_s * 1e6:.1f} us"
                                   for p in profiles if p.name not in main))
    cpu_planner = EdgentPlanner(graph, latency_req_s=ALEX_SLO).offline_static(
        params_cpu, x1.cpu())
    log(f"phase 12: offline_static on this host's CPU: host_full "
        f"{0.010 / cpu_planner.edge_factor * 1e3:.4f} ms, R^2 {cpu_planner.f_edge.r2()}")
    plans = {}
    for kbps in ALEX_KBPS:
        bw = kbps * KBPS
        plan = plans[kbps] = planner.plan(bw)
        ex = TwoTierExecutor(graph, params, bandwidth_bps=bw,
                             device_slowdown=planner.device_factor,
                             edge_slowdown=planner.edge_factor)
        res = ex.run(plan, x1)
        held_plan(torch, net, graph, params, x1, plan, res, bw)
        log(f"phase 12: {kbps:4d} kbps card plan {plan_str(plan)}; CPU plan "
            f"{plan_str(cpu_planner.plan(bw))}; executed: edge {res.edge_s * 1e3:.3f} ms, "
            f"device {res.device_s * 1e3:.3f} ms, transfer {res.transfer_s * 1e3:.3f} ms "
            f"-> {res.latency_s * 1e3:.3f} ms")

    # -- the dynamic pipeline (examples/serve_dynamic_bandwidth.py) on the card
    planner.offline_dynamic([t.tolist() for t in oboe_like_traces(seed=0, num=428)])
    lte = belgium_lte_like(seed=3, length=120, transport="bus", hi_mbps=10.0)
    ex = TwoTierExecutor(graph, params, bandwidth_bps=1.0,
                         device_slowdown=planner.device_factor,
                         edge_slowdown=planner.edge_factor)
    met, used = 0, {}
    for bw in lte:
        plan = planner.plan(bw, dynamic=True)
        res = ex.run(plan, x1, bandwidth_bps=bw)
        held_plan(torch, net, graph, params, x1, plan, res, bw)
        met += res.latency_s <= ALEX_SLO
        key = (plan.exit_point, plan.partition)
        used[key] = used.get(key, 0) + 1
    dyn = planner.dynamic_opt
    log(f"phase 12: dynamic: configuration map of {len(dyn.cmap)} states; "
        f"{len(lte)} steps over {min(lte) / MBPS:.2f}-{max(lte) / MBPS:.2f} Mbps, "
        f"SLO attainment {met}/{len(lte)} ({100 * met / len(lte):.1f}%), "
        f"{dyn.transitions} state transitions, plans (exit, partition): steps {used}")
    require(dyn.transitions > 0 and len(dyn.cmap) == 428,
            "dynamic pipeline: no state transition or a short map")
    return graph, plans


def calib_phase(torch, graph, static_plans):
    """Phase 13: measure BranchyAlexNet on the card, fit the Table-I
    regressions, plan on the raw fitted models, and round-trip the table."""
    from repro_torch.calib import (CalibrationTable, fit_table, measure_alexnet,
                                   models_from_table)
    from repro_torch.core import EdgentPlanner

    table = measure_alexnet(device="cuda")
    require(table.meta["platform"] == "cuda" and len(table.samples) == 38,
            f"measure_alexnet: {len(table.samples)} samples on {table.meta['platform']}")
    fitted = fit_table(table)
    log(f"phase 13: measure_alexnet on {table.meta['device_name']}: {len(table.samples)} "
        f"layer samples (median of {table.meta['reps']}); fit R^2 "
        f"{ {k: round(v, 4) for k, v in fitted.r2.items()} }")
    f_edge, f_dev = models_from_table(table, None, graph=graph, anchor=False)
    planner = EdgentPlanner(graph, latency_req_s=ALEX_SLO).with_models(f_edge, f_dev)
    log(f"phase 13: calibrated main branch: edge {sum(f_edge.predict(l) for l in graph.branches[-1]) * 1e3:.4f} ms, "
        f"device {sum(f_dev.predict(l) for l in graph.branches[-1]) * 1e3:.4f} ms")
    for kbps in ALEX_KBPS:
        log(f"phase 13: {kbps:4d} kbps calibrated plan {plan_str(planner.plan(kbps * KBPS))}; "
            f"phase 12 plan {plan_str(static_plans[kbps])}")
    path = ROOT / "build" / "calib_branchy_alexnet.json"
    path.parent.mkdir(exist_ok=True)
    table.save(str(path))
    back = CalibrationTable.load(str(path))
    require(back.to_dict() == table.to_dict(), "calibration table: save/load changed it")
    log(f"phase 13: table saved to {path.relative_to(ROOT)} and loaded back equal")
    return calib_lm(torch)


def calib_lm(torch):
    """Phase 13's LM half: ``measure_lm`` on the smoke stack the reference
    measures and fits (``src/repro/calib/fit.py`` ``_lm_graph_for``), its
    prefill and decode through flash and decode attention at head dim 16
    on the card, then ``fit_table`` and the fitted branches' predictions
    beside the measured decode times.  Returns the launch counts."""
    from repro_torch.calib import fit_table, measure_lm
    from repro_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    table = measure_lm(arch=LLAMA, device="cuda")
    torch.cuda.synchronize()
    counts = launch_counts()
    require(table.meta["platform"] == "cuda", f"measure_lm on {table.meta['platform']}")
    for name in ("flash_attention", "decode_attention"):
        require(counts[name] > 0, f"phase 13: measure_lm launched no {name}")
    fitted = fit_table(table)
    require(all(math.isfinite(v) for th in fitted.theta.values() for v in th),
            f"phase 13: LM fit not finite: {fitted.theta}")
    decode = {(s.exit_point, s.batch): s.latency_s * 1e3 for s in table.by_phase("decode")}
    log(f"phase 13: measure_lm {LLAMA} smoke stack on {table.meta['device_name']} "
        f"({time.perf_counter() - t0:.1f} s): {len(table.samples)} samples (prefill, "
        f"decode by exit x batch, head), launches {counts}; decode ms by (exit, batch) "
        f"{ {k: round(v, 4) for k, v in sorted(decode.items())} }; fit_table kinds "
        f"{sorted(fitted.theta)} R^2 { {k: round(v, 4) for k, v in fitted.r2.items()} }")
    return counts


# ---------------------------------------------------------------- phases 14-15
# Training on the card.  Phase 14 is examples/train_branchy_alexnet.py's
# path (BranchyNet joint training of BranchyAlexNet at the paper size, in
# float32); phase 15 launch/train.py --full's (llama3.2-1b at full width and
# depth in bfloat16 with float32 moments).  Stated tolerances:
#  * phase 14, card against CPU, every dropout rate 0, TF32 off: each of
#    ALEX_HOLD_STEPS example steps taken on both from the CPU's state before
#    it, on the same batch: the joint loss within ALEX_LOSS_TOL, and every
#    parameter and moment within 2 lr of the CPU's, all but one in
#    ALEX_FAR_SHARE within ALEX_ATOL.  Adam divides each gradient by its
#    running RMS, so an element whose gradient is near zero takes a step of
#    up to lr in a direction rounding decides.  Run free from the same
#    initial state, the two part further (a ReLU or a max-pool window near
#    a tie switches on one side only): after ALEX_HOLD_STEPS steps every
#    element within 2 lr a step, the distance logged;
#  * phase 15, f32 at full width and depth, B1 S2048: per leaf, the grads
#    of the flash path (impl "auto") within LM_GRAD_RTOL max|g| +
#    LM_GRAD_ATOL of the dense path's, and with remat of those without;
#  * every checkpoint restored on the card equal bit for bit.
ALEX_TRAIN_STEPS, ALEX_TRAIN_BATCH, ALEX_FAIL_AT, ALEX_SAVE_EVERY = 300, 64, 150, 100
ALEX_LR, ALEX_WD, ALEX_HOLD_STEPS = 1e-3, 1e-4, 5
ALEX_LOSS_TOL, ALEX_ATOL, ALEX_FAR_SHARE = 1e-5, 1e-5, 1000
LM_TRAIN = dict(steps=6, batch=4, seq=2049, save_every=2, inject_failure_at=3)
LM_GRAD_RTOL, LM_GRAD_ATOL = 1e-4, 1e-6
LM_LOSS_TOL = 1e-5                 # two paths' f32 losses (phase 21)
LM_TIMED_STEPS = 3
#: leaves that stay ones under the --full recipe: bfloat16 spaces values
#: near 1 by 2^-8 to 2^-7, far above the recipe's steps (lr <= 3e-4)
NORM_LEAVES = ("ln", "final_norm", "exit_norms")


def branchy_step(torch, net, params, opt, x, y, gen):
    """The example's step: the joint loss over every exit, its backward,
    AdamW at lr 1e-3 and weight decay 1e-4."""
    from repro_torch import tree as T
    from repro_torch.optim import adamw_update
    params = T.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = net.loss(params, (x, y), gen)
    loss.backward()
    grads = T.tree_map(lambda p: p.grad, params)
    params, opt = adamw_update(grads, opt, params, lr=ALEX_LR, weight_decay=ALEX_WD)
    return params, opt, loss.detach()


def state_to(torch, state, device):
    from repro_torch import tree as T
    return T.tree_map(lambda t: t.detach().to(device, copy=True), state)


def held_adam_step(torch, label, got, want):
    """Every element of ``got`` within 2 lr of ``want``, all but one in
    ALEX_FAR_SHARE within ALEX_ATOL; returns (max |diff|, elements beyond
    ALEX_ATOL, elements)."""
    from repro_torch import tree as T
    worst, far, n = 0.0, 0, 0
    for (key, g), w in zip(T.leaves_with_paths(got), T.leaves(want)):
        err = (g.detach().float().cpu() - w.detach().float().cpu()).abs()
        require(bool(torch.isfinite(g).all()), f"{label} {key}: non-finite values")
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
        far += int((err > ALEX_ATOL).sum())
        n += err.numel()
    return worst, far, n


def bits_equal(torch, a, b):
    from repro_torch import tree as T
    la, lb = T.leaves_with_paths(a), T.leaves_with_paths(b)
    return [k for (k, x), (_, y) in zip(la, lb)
            if x.dtype != y.dtype or x.shape != y.shape
            or not torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                               y.view(torch.int16) if y.dtype == torch.bfloat16 else y)]


def branchy_train_phase(torch):
    """Phase 14: examples/train_branchy_alexnet.py on the card."""
    import dataclasses
    import shutil

    from repro_torch.checkpointing import CheckpointManager
    from repro_torch.configs import get_alexnet_config
    from repro_torch.data.synthetic import cifar_like
    from repro_torch.models.alexnet import BranchyAlexNet
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.fault_tolerance import FailureInjector, ResilientLoop

    # -- card against CPU, every dropout rate 0 (set on the net's own specs)
    net0 = BranchyAlexNet(get_alexnet_config())

    def no_drop(specs):
        return [dataclasses.replace(sp, drop_rate=0.0) if sp.kind == "dropout" else sp
                for sp in specs]
    net0.main = no_drop(net0.main)
    net0.sides = [(prefix, no_drop(side)) for prefix, side in net0.sides]
    t0 = time.perf_counter()
    p_cpu = net0.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    batches = [tuple(torch.from_numpy(a) for a in cifar_like(rng, ALEX_TRAIN_BATCH,
                                                               noise=ALEX_NOISE))
               for _ in range(ALEX_HOLD_STEPS)]
    cpu_states, cpu_losses = [(p_cpu, adamw_init(p_cpu))], []
    gen_cpu = torch.Generator().manual_seed(0)
    for x, y in batches:
        p, o, loss = branchy_step(torch, net0, *cpu_states[-1], x, y, gen_cpu)
        cpu_states.append((p, o))
        cpu_losses.append(float(loss))
    gen = torch.Generator(device="cuda").manual_seed(0)
    held = {}
    for det in (True, False):
        torch.backends.cudnn.deterministic = det
        worst = far = n = 0
        for i, (x, y) in enumerate(batches):
            p, o, loss = branchy_step(torch, net0, *state_to(torch, cpu_states[i], "cuda"),
                                      x.cuda(), y.cuda(), gen)
            require(abs(float(loss) - cpu_losses[i]) <= ALEX_LOSS_TOL,
                    f"phase 14: step {i} joint loss {float(loss)!r} against the CPU's "
                    f"{cpu_losses[i]!r}")
            w, f, m = held_adam_step(torch, f"phase 14 step {i}", (p, o.mu, o.nu),
                                     (cpu_states[i + 1][0], cpu_states[i + 1][1].mu,
                                      cpu_states[i + 1][1].nu))
            worst, far, n = max(worst, w), far + f, n + m
        held[det] = (worst, far, n, p)
        require(worst <= 2 * ALEX_LR and far <= n // ALEX_FAR_SHARE,
                f"phase 14: card against CPU (cudnn.deterministic={det}): max |diff| "
                f"{worst:.3e}, {far} of {n} elements beyond {ALEX_ATOL}")
        log(f"phase 14: {ALEX_HOLD_STEPS} example steps card against CPU from the CPU's "
            f"state, dropout rate 0, cudnn.deterministic={det}: joint losses within "
            f"{ALEX_LOSS_TOL}; params and moments max |diff| {worst:.3e}, {far} of {n} "
            f"elements beyond {ALEX_ATOL}")
    torch.backends.cudnn.deterministic = False
    same = not bits_equal(torch, held[True][3], held[False][3])
    log(f"phase 14: the last held step's params with cudnn.deterministic on and off "
        f"{'equal bit for bit' if same else 'differ'}")
    state = state_to(torch, cpu_states[0], "cuda")
    for x, y in batches:
        state = branchy_step(torch, net0, *state, x.cuda(), y.cuda(), gen)[:2]
    worst = held_adam_step(torch, "phase 14 free run", state, cpu_states[-1])[0]
    require(worst <= 2 * ALEX_LR * ALEX_HOLD_STEPS,
            f"phase 14: free-running card and CPU {worst:.3e} apart after "
            f"{ALEX_HOLD_STEPS} steps")
    log(f"phase 14: run free from the same initial state for {ALEX_HOLD_STEPS} steps, "
        f"card and CPU end {worst:.3e} apart at most (bound {2 * ALEX_LR * ALEX_HOLD_STEPS}); "
        f"the holds took {time.perf_counter() - t0:.1f} s")

    # -- the example: 300 steps with a failure injected at 150
    net = BranchyAlexNet(get_alexnet_config())
    params = net.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    opt = adamw_init(params)
    data_rng = np.random.default_rng(0)
    drop_gen = torch.Generator(device="cuda").manual_seed(0)
    ckdir = ROOT / "build" / "ckpt_branchy_alexnet"
    shutil.rmtree(ckdir, ignore_errors=True)
    ckpt = CheckpointManager(str(ckdir))
    loop = ResilientLoop(ckpt, save_every=ALEX_SAVE_EVERY)
    losses, restarts_at = {}, []

    def step_fn(state, i):
        x, y = cifar_like(data_rng, ALEX_TRAIN_BATCH, noise=ALEX_NOISE)
        p, o, loss = branchy_step(torch, net, *state, torch.from_numpy(x).cuda(),
                                  torch.from_numpy(y).cuda(), drop_gen)
        if i % 50 == 0 or i == ALEX_TRAIN_STEPS - 1:
            losses[i] = float(loss)
        return p, o

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (params, opt), info = loop.run((params, opt), step_fn, ALEX_TRAIN_STEPS,
                                   injector=FailureInjector(fail_at=(ALEX_FAIL_AT,)),
                                   on_restart=restarts_at.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = ALEX_TRAIN_STEPS + ALEX_FAIL_AT - restarts_at[0] if restarts_at else ALEX_TRAIN_STEPS
    require(info == {"restarts": 1, "final_step": ALEX_TRAIN_STEPS},
            f"phase 14: loop info {info}")
    require(all(math.isfinite(v) for v in losses.values())
            and losses[ALEX_TRAIN_STEPS - 1] < losses[0],
            f"phase 14: joint loss did not fall: {losses}")
    log(f"phase 14: {ALEX_TRAIN_STEPS} steps, batch {ALEX_TRAIN_BATCH}, noise {ALEX_NOISE}, "
        f"failure injected at step {ALEX_FAIL_AT}, resumed at {restarts_at}: "
        f"{info['restarts']} restart; joint loss by step "
        f"{ {k: round(v, 4) for k, v in sorted(losses.items())} }; {run} steps run in "
        f"{wall:.2f} s ({run / wall:.1f} steps/s, checkpoints included)")
    back, step = ckpt.restore((params, opt))
    bad = bits_equal(torch, back, (params, opt))
    require(step == ALEX_TRAIN_STEPS and not bad,
            f"phase 14: checkpoint of step {step} restored unequal: {bad[:5]}")
    xv, yv = cifar_like(np.random.default_rng(ALEX_DATA_SEED), ALEX_IMAGES, noise=ALEX_NOISE)
    xv, yv = torch.from_numpy(xv).cuda(), torch.from_numpy(yv).cuda()
    with torch.no_grad():
        acc = {e: float(net.accuracy(params, xv, yv, e)) for e in range(1, net.num_exits + 1)}
        final = float(net.loss(params, (xv, yv), drop_gen))
    require(all(math.isfinite(a) for a in acc.values()) and math.isfinite(final),
            f"phase 14: accuracy {acc}, loss {final}")
    log(f"phase 14: checkpoint of step {step} restored on the card bit for bit; "
        f"per-exit accuracy over {ALEX_IMAGES} held-out images (seed {ALEX_DATA_SEED}): "
        + ", ".join(f"exit {e} ({len(net.branch_layers(e))} layers) {a:.3f}"
                    for e, a in acc.items())
        + f"; the joint loss on them (dropout on) {final:.4f}")
    shutil.rmtree(ckdir, ignore_errors=True)


def lm_train_flops(cfg, B, S, remat):
    """FLOPs of one train step as the code runs it: the projections
    forward, again under remat, and twice backward; flash attention at
    every block (none pruned), forward (again under remat) and a backward
    of five products; the tied-head CE of every exit forward, again under
    its checkpoint, and twice backward."""
    d, hd, L_ = cfg.d_model, cfg.hd, cfg.num_layers
    h, kv = cfg.padded_heads, cfg.num_kv_heads
    per_layer = d * h * hd * 2 + d * kv * hd * 2 + 3 * d * cfg.d_ff
    tokens = B * S
    matmul = 2 * per_layer * L_ * tokens * (4 if remat else 3)
    attn_prod = 2 * B * h * S * S * hd                     # one product over all blocks
    attn = L_ * attn_prod * (2 * (2 if remat else 1) + 5)
    from repro_torch.models.transformer import segment_lengths
    ce = len(segment_lengths(cfg)) * 2 * tokens * d * cfg.padded_vocab * 4
    return {"matmul": matmul, "attention": attn, "ce": ce, "total": matmul + attn + ce}


def lm_train_phase(torch):
    """Phase 15: llama3.2-1b trained at full width and depth through
    launch/train.py --full's recipe, after the f32 holds of its grads.
    Returns the numbers the end-of-run profile needs."""
    import shutil

    from repro_torch import tree as T
    from repro_torch.checkpointing import CheckpointManager
    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.api import Model

    cfg = get_config(LLAMA)
    model = Model(cfg)

    # -- f32 holds at B1 S2048: flash against dense, remat against none
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               dtype=torch.float32, device="cuda")
    leaves = [p.requires_grad_() for p in T.leaves(params)]
    keys = [k for k, _ in T.leaves_with_paths(params)]
    tokens = torch.from_numpy(next(token_batches(0, 1, LM_TRAIN["seq"], cfg.vocab_size)))
    batch = {"tokens": tokens.cuda()}

    def grads(impl, remat):
        loss, _ = model.loss(params, batch, remat=remat, attn_impl=impl)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    def held(label, got, want):
        worst = (0.0, "")
        for k, g, w in zip(keys, got, want):
            tol = LM_GRAD_RTOL * float(w.abs().max()) + LM_GRAD_ATOL
            err = float((g - w).abs().max())
            require(math.isfinite(err) and err <= tol,
                    f"phase 15: {label}: {k} max |diff| {err:.3e} > {tol:.3e}")
            worst = max(worst, (err / tol, k))
        log(f"phase 15: {label}: every leaf within {LM_GRAD_RTOL} max|g| + {LM_GRAD_ATOL}; "
            f"worst leaf {worst[1]} at {worst[0]:.3e} of its tolerance"
            + ("" if worst[0] else " (every leaf equal bit for bit)"))

    l_dense, g_dense = grads("dense", False)
    l_flash, g_flash = grads("auto", False)
    held("f32 B1 S2048 grads, flash (auto) against dense", g_flash, g_dense)
    del g_dense
    l_remat, g_remat = grads("auto", True)
    held("f32 B1 S2048 grads, remat against none (flash)", g_remat, g_flash)
    log(f"phase 15: f32 losses dense {l_dense:.6f}, flash {l_flash:.6f}, flash + remat "
        f"{l_remat:.6f}; the holds took {time.perf_counter() - t0:.1f} s")
    del params, leaves, g_flash, g_remat
    torch.cuda.empty_cache()

    # -- launch/train.py --full: bf16 params, f32 moments, remat, flash, CE chunks
    ckdir = ROOT / "build" / "ckpt_llama"
    shutil.rmtree(ckdir, ignore_errors=True)
    t0 = time.perf_counter()
    out = train_mod.train(LLAMA, smoke=False, ckpt_dir=ckdir, device="cuda", **LM_TRAIN)
    wall = time.perf_counter() - t0
    info, losses = out["info"], out["losses"]
    require(info == {"restarts": 1, "final_step": LM_TRAIN["steps"]},
            f"phase 15: loop info {info}")
    require(len(losses) == LM_TRAIN["steps"] + 1 and all(math.isfinite(v) for v in losses),
            f"phase 15: losses {losses}")
    t_chk = time.perf_counter()
    init = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                             dtype=torch.bfloat16, device="cuda")
    changed = {k: float((a != b).float().mean())
               for (k, a), b in zip(T.leaves_with_paths(out["params"]), T.leaves(init))}
    frozen = [k for k, v in changed.items() if v == 0.0]
    require(all(k.split("/")[-1] in NORM_LEAVES for k in frozen),
            f"phase 15: weights left unchanged: {frozen}")
    log(f"phase 15: {LM_TRAIN['steps']} steps of B{LM_TRAIN['batch']} x "
        f"{LM_TRAIN['seq'] - 1} tokens, failure injected at step "
        f"{LM_TRAIN['inject_failure_at']}: {info['restarts']} restart; losses "
        f"{[round(v, 4) for v in losses]}; {len(losses)} steps in {wall:.1f} s with "
        f"checkpoints of every second step (the loop {out['seconds']:.1f} s; the check of "
        f"the weights {time.perf_counter() - t_chk:.1f} s); share of elements changed by leaf "
        f"{ {k: round(v, 4) for k, v in changed.items()} }; unchanged leaves "
        f"(RMSNorm weights at 1.0 in bf16): {frozen}")
    del init
    t0 = time.perf_counter()
    back, step = CheckpointManager(str(ckdir)).restore((out["params"], out["opt"]))
    bad = bits_equal(torch, back, (out["params"], out["opt"]))
    require(step == LM_TRAIN["steps"] and not bad,
            f"phase 15: checkpoint of step {step} restored unequal: {bad[:5]}")
    log(f"phase 15: bf16 checkpoint of step {step} restored on the card bit for bit "
        f"({sum(t.numel() * t.element_size() for t in T.leaves(back)) / 1e9:.2f} GB, "
        f"{time.perf_counter() - t0:.1f} s)")
    del back
    shutil.rmtree(ckdir, ignore_errors=True)

    # -- step walls, before any profiler session
    B, S = LM_TRAIN["batch"], LM_TRAIN["seq"] - 1
    step, _ = make_train_step(model, None, ShapeConfig("phase15", LM_TRAIN["seq"], B, "train"),
                              device="cuda", remat=True, ce_chunk=512)
    state = (out["params"], out["opt"])
    del out
    data = token_batches(1, B, LM_TRAIN["seq"], cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(next(data)).cuda()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(LM_TIMED_STEPS + 1):
        t0 = time.perf_counter()
        p, o, m = step(*state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        state = (p, o)
        del p, o
    peak = torch.cuda.max_memory_allocated()
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
                             "temperature.gpu", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60).stdout.strip()
    wall = statistics.median(walls[1:])
    flops = lm_train_flops(cfg, B, S, remat=True)
    log(f"phase 15: train step B{B} S{S}: median wall {wall * 1e3:.1f} ms of "
        f"{[round(w * 1e3, 1) for w in walls[1:]]} (warm-up {walls[0] * 1e3:.1f} ms), "
        f"{B * S / wall:.0f} tokens/s, peak memory {peak / 1e9:.2f} GB; FLOPs a step "
        f"{flops['total']:.4g} (projections {flops['matmul']:.4g}, attention "
        f"{flops['attention']:.4g}, CE {flops['ce']:.4g}) = {flops['total'] / wall / 1e12:.1f} "
        f"TFLOP/s; after them clocks.sm, clocks.max.sm, power.draw, temperature {clocks}")
    del state, step
    torch.cuda.empty_cache()
    return {"wall_s": wall, "flops": flops["total"]}


def lm_train_profile(torch, walls):
    """Phase 15's device idle share: one train step under one profiler
    session, against the median wall phase 15 took before any session.
    The process is warm from phase 15, so no step runs first: the
    allocator's growth in this one shows in its wall, not in the device's
    kernel time, which is what the share reads."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_batches
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.api import Model
    from repro_torch.optim import adamw_init

    cfg = get_config(LLAMA)
    model = Model(cfg)
    B = LM_TRAIN["batch"]
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               dtype=torch.bfloat16, device="cuda")
    state = (params, adamw_init(params))
    del params
    step, _ = make_train_step(model, None, ShapeConfig("phase15", LM_TRAIN["seq"], B, "train"),
                              device="cuda", remat=True, ce_chunk=512)
    batch = {"tokens": torch.from_numpy(
        next(token_batches(1, B, LM_TRAIN["seq"], cfg.vocab_size))).cuda()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = step(*state, batch)[:2]
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation and e.self_device_time_total > 0]
    dev = sum(e.self_device_time_total for e in kernels) / 1e6
    require(dev > 0, "phase 15: no device time traced")
    by_kind = {}
    for e in kernels:
        name = e.key.lower()
        kind = ("products" if any(w in name for w in ("gemm", "nvjet", "xmma", "cutlass"))
                else "reductions" if "reduce" in name
                else "elementwise" if "elementwise" in name else "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + e.self_device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    log(f"phase 15: profiled train step: {dev * 1e3:.1f} ms of kernels on the device "
        f"({sum(e.count for e in kernels)} launches), idle share "
        f"{1 - dev / walls['wall_s']:.3f} of the {walls['wall_s'] * 1e3:.1f} ms wall "
        f"({traced_wall * 1e3:.1f} ms under the profiler); device FLOP rate "
        f"{walls['flops'] / dev / 1e12:.1f} TFLOP/s; device ms by kind "
        f"{ {k: round(v, 1) for k, v in sorted(by_kind.items())} }; top kernels "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms x{e.count}"
                    for e in top))
    del state, step
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- main
# ---------------------------------------------------------------- phase 16
# The remaining model families at full width: llava-next-mistral-7b (the VLM:
# 2880 precomputed patch embeddings through mm_proj in front of the text, 32
# layers at head dim 128, 32/8 heads), seamless-m4t-large-v2 (the enc-dec: 24
# non-causal encoder layers over 1000 frames, 24 decoder layers with
# cross-attention over that memory) and llama4-scout-17b-a16e (a top-1 MoE of
# 16 experts every layer, 40 heads padded to 48 over 8 kv heads: G = 6),
# with the int8 KV cache on llava.  Random weights from torch.Generator seed 0.
FAMILY_STEPS = 16                  # decode steps at each exit
LLAVA_BATCH, LLAVA_TEXT = 2, 32    # text tokens after the 2880-embedding prefix
ENC_FRAMES, DEC_PROMPT = 1000, 12
# scout's depth is cut: its 48 layers hold ~201 GB of bf16 weights, beyond one
# card's 80 GB (the full depth waits for the torch.distributed substrate);
# 8 layers are ~35 GB in bf16, 4 layers ~37 GB in f32
SCOUT_LAYERS = {"bf16": 8, "f32": 4}
# phases 18-19's depth cuts: starcoder2-15b's float32 holds at 20 of its 40
# layers (40 are 86.8 GB in float32, 20 ~44 GB; in bf16 it runs whole, 43.4
# GB), llama4-maverick at 2 of 48 layers, its one dense/MoE unit (16.4 B
# parameters, ~35 GB in bf16: one MoE layer of 128 experts is 16.1 B), in
# bf16 only.  By config and precision; a config not named runs whole
CUT_LAYERS = {SCOUT: SCOUT_LAYERS, STARCODER: {"f32": 20}, MAVERICK: {"bf16": 2}}
# the int8 cache's holds: decode within rel INT8_REL of the unquantized
# cache's (the reference's bound, tests/test_perf_features.py), its bytes
# under INT8_BYTES of the unquantized bf16 cache's
INT8_REL, INT8_BYTES = 0.05, 0.6
# the kernels each family's main path launches (seamless picks its tokens
# from the plain logits: its decode step reports no exit confidences)
FAMILY_KERNELS = {LLAVA: ("flash_attention", "decode_attention", "exit_confidence"),
                  SEAMLESS: ("flash_attention", "decode_attention"),
                  SCOUT: ("flash_attention", "decode_attention", "exit_confidence")}


def family_config(arch, precision="bf16"):
    """The full config of ``arch``, its depth cut as CUT_LAYERS says."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    layers = CUT_LAYERS.get(arch, {}).get(precision)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def family_kernel_times(torch):
    """Phase 3 at the new families' shapes: each kernel against its plain
    version in bfloat16 and float32, then timed (bf16) beside its plain
    version, SDPA or the library composite, and its bound.  Flash: llava's
    prefill (B2 S2912, hd 128, G 4, causal), scout's (B4 S1000, 48 padded
    heads over 8: G 6), seamless's encoder (S = T = 1000, non-causal) and
    its cross-attention at prefill (S 12 over T 1000: one ragged q-tile, T
    not a multiple of the key tile), and non-causal S 77 over T 300 and S
    300 over T 77 at hd 128.  Decode: llava's cache (T 2929), scout's at G
    6 (lengths on a split boundary, one past it, past T and zero too), and
    the cross-attention over the memory (lengths = T = 1000).  Exit head:
    llava's D 4096 V 32000 and scout's D 5120 V 202112 with exact ties.
    From a generator of its own (seed 16), so that phase 3's inputs stay
    those of earlier runs.  Returns ``{kernel: {label: times}}``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    gen = torch.Generator(device="cuda").manual_seed(16)
    timer = Timer(torch)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    out = {"flash_attention": {}, "decode_attention": {}, "exit_confidence": {}}

    def keep(kernel, label, t):
        if t is not None:
            out[kernel][label] = t

    lv, sc, sm = family_config(LLAVA), family_config(SCOUT), family_config(SEAMLESS)
    lH, lKV, lhd = lv.num_heads, lv.num_kv_heads, lv.hd
    sH, sKV, shd = sc.padded_heads, sc.num_kv_heads, sc.hd
    mH, mKV, mhd = sm.num_heads, sm.num_kv_heads, sm.hd
    S_llava = lv.num_prefix_tokens + LLAVA_TEXT
    T_llava = S_llava + FAMILY_STEPS + 1
    T_scout = LONG_PROMPT + FAMILY_STEPS + 1
    SK = fa_ops.SPLIT_KEYS
    for dt in (torch.bfloat16, torch.float32):
        for label, case in (
                (f"{LLAVA} prefill", (LLAVA_BATCH, S_llava, S_llava, lH, lKV, lhd, True)),
                (f"{SCOUT} prefill", (BATCH, LONG_PROMPT, LONG_PROMPT, sH, sKV, shd, True)),
                (f"{SEAMLESS} encoder", (BATCH, ENC_FRAMES, ENC_FRAMES, mH, mKV, mhd, False)),
                (f"{SEAMLESS} cross prefill",
                 (BATCH, DEC_PROMPT, ENC_FRAMES, mH, mKV, mhd, False)),
                (None, (2, 77, 300, 4, 2, 128, False)),
                (None, (2, 300, 77, 6, 1, 128, False))):
            keep("flash_attention", label,
                 flash_check(torch, timer, randn, dt, *case, timed=label is not None))
        for label, case in (
                (f"{LLAVA} decode",
                 (LLAVA_BATCH, T_llava, lH, lKV, lhd, [T_llava - 1] * LLAVA_BATCH)),
                (f"{SCOUT} decode", (BATCH, T_scout, sH, sKV, shd, [T_scout - 1] * BATCH)),
                (None, (BATCH, T_scout, sH, sKV, shd, [SK, SK + 1, T_scout + 7, 0])),
                (f"{SEAMLESS} cross decode",
                 (BATCH, ENC_FRAMES, mH, mKV, mhd, [ENC_FRAMES] * BATCH))):
            keep("decode_attention", label,
                 decode_check(torch, timer, randn, dt, *case, timed=label is not None))
        for label, (rows, cfg) in ((f"{LLAVA} exit head", (LLAVA_BATCH, lv)),
                                   (f"{SCOUT} exit head", (BATCH, sc))):
            keep("exit_confidence", label,
                 exit_head_check(torch, timer, randn, dt, rows, cfg.d_model,
                                 cfg.padded_vocab, timed=True))
    for kernel, times in out.items():
        for label, t in times.items():
            log(f"time {kernel} {label}: {t}")
    del timer
    torch.cuda.empty_cache()
    return out


def shadowed_kernels(torch, worst):
    """Context: every attention and exit-head launch held against its plain
    version on the same inputs (attention at ATTN_ATOL, float32; the exit
    head's token equal unless the plain top-2 margin is below MARGIN_TOL,
    its confidence at CONF_TOL).  ``worst`` gathers the largest share of
    the allowed error and the launches held, by kind: non-causal flash,
    G = 6, head dim 128."""
    from repro_torch.kernels.exit_head import ops as eh_ops
    from repro_torch.kernels.exit_head import ref as eh_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    flash, dec, head = fa_ops.flash_attention, fa_ops.decode_attention, eh_ops.exit_confidence

    def note(kind, q, k, share, err):
        G, hd = q.shape[2] // k.shape[2], q.shape[3]
        for tag, on in ((kind, True), ("G6", G == 6), ("hd128", hd == 128)):
            if on:
                n, s, e = worst.get(tag, (0, 0.0, 0.0))
                worst[tag] = (n + 1, max(s, share), max(e, err))

    def flash_held(q, k, v, *, causal=True):
        o = flash(q, k, v, causal=causal)
        plain = fa_ref.attention(q.transpose(1, 2).float(), k.transpose(1, 2).float(),
                                 v.transpose(1, 2).float(), causal=causal).transpose(1, 2)
        e, share = attn_share(o, plain, q.dtype)
        note("flash causal" if causal else "flash non-causal", q, k, share, e)
        return o

    def decode_held(q, k, v, lengths):
        o = dec(q, k, v, lengths)
        plain = fa_ref.decode_attention(q.transpose(1, 2).float(), k.transpose(1, 2).float(),
                                        v.transpose(1, 2).float(), lengths).transpose(1, 2)
        e, share = attn_share(o, plain, q.dtype)
        note("decode", q, k, share, e)
        return o

    def head_held(h, emb):
        got = head(h, emb)
        plain = eh_ref.exit_confidence(h.float(), emb.float())
        logits = torch.einsum("bsd,vd->bsv", h.float(), emb.float())
        top2 = logits.topk(2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        bad = (got["token"] != plain["token"]) & (margin >= MARGIN_TOL)
        require(not bad.any().item(), "exit head: a token differs from the plain head's on "
                "its inputs where the margin is above tolerance")
        ec = (got["conf"] - plain["conf"]).abs().max().item()
        require(ec <= CONF_TOL, f"exit head: conf {ec} from the plain head's on its inputs")
        n, s, e = worst.get("exit head", (0, 0.0, 0.0))
        worst["exit head"] = (n + 1, max(s, ec / CONF_TOL), max(e, ec))
        return got

    stack = contextlib.ExitStack()
    stack.enter_context(patched(fa_ops, "flash_attention", flash_held))
    stack.enter_context(patched(fa_ops, "decode_attention", decode_held))
    stack.enter_context(patched(eh_ops, "exit_confidence", head_held))
    return stack


def recorded_routes(torch, routes):
    """Context: every MoE call records its router's expert per token and the
    top-2 router-probability margin, in call order (``routes``)."""
    from repro_torch.models import moe as MOE
    inner = MOE.moe_ffn

    def moe_ffn(p, cfg, x, **kw):
        probs, _ = MOE.route(p, cfg, x)
        top2 = probs.topk(2, dim=-1)
        routes.append((top2.indices[..., 0].cpu(),
                       (top2.values[..., 0] - top2.values[..., 1]).cpu()))
        return inner(p, cfg, x, **kw)
    return patched(MOE, "moe_ffn", moe_ffn)


def moe_drops(torch, drops):
    """Context: every MoE call adds, under its tokens a group (S), the
    tokens its capacity drops and the tokens it routes (``drops``), from
    the router's choices as ``moe_ffn`` takes them (the first expert on a
    tie, in token order within a group)."""
    import torch.nn.functional as F

    from repro_torch.models import moe as MOE
    inner = MOE.moe_ffn

    def moe_ffn(p, cfg, x, **kw):
        probs, _ = MOE.route(p, cfg, x)
        per_expert = F.one_hot(probs.argmax(-1), cfg.num_experts).sum(1)     # [G, E]
        over = (per_expert - MOE._capacity(x.shape[1], cfg)).clamp_min(0).sum().item()
        d, n = drops.get(x.shape[1], (0, 0))
        drops[x.shape[1]] = (d + over, n + x.shape[0] * x.shape[1])
        return inner(p, cfg, x, **kw)
    return patched(MOE, "moe_ffn", moe_ffn)


def family_inputs(torch, cfg, B, S):
    """The family's prefill inputs, from generator seed 1 on the card:
    tokens [B, S] and the VLM's prefix [B, 2880, 1024] or the enc-dec's
    frames [B, 1000, 1024], in float32 (the model casts them)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    extra = {}
    if cfg.frontend == "vision":
        extra["prefix_emb"] = torch.randn((B, cfg.num_prefix_tokens, 1024), generator=gen,
                                          device="cuda")
    if cfg.is_encdec:
        extra["frames"] = torch.randn((B, ENC_FRAMES, 1024), generator=gen, device="cuda")
    return toks, extra


def family_run(torch, model, params, toks, extra, *, impl="kernel", quant=False,
               feed=None, margins=False):
    """Prefill, then FAMILY_STEPS greedy decode steps at each exit (every
    exit restarts from the prefill: a step writes its position before it
    attends, so a later run overwrites what an earlier one left).  Tokens
    come from the exit head (the plain argmax of the logits for the
    enc-dec, whose steps report no exit confidences); ``feed``: the tokens
    to feed instead, {exit: [B] lists by step} (teacher forcing, so that
    two paths decode the same sequence).  Returns {"prefill": h, "cache":
    cache, "calls": (prefills, exit-head picks, segments run by step), exit:
    (picked tokens by step, top-2 margins by step or None, last hidden)}."""
    from repro_torch.kernels.exit_head import ops as eh_ops
    from repro_torch.kernels.exit_head import ref as eh_ref
    cfg = model.cfg
    B, S = toks.shape
    P = cfg.num_prefix_tokens if "prefix_emb" in extra else 0
    dtype = params["embed"].dtype
    kw = {"enc_len": ENC_FRAMES} if cfg.is_encdec else {"quant": quant} if quant else {}
    cache = model.init_cache(B, P + S + FAMILY_STEPS + 1, dtype=dtype, device="cuda", **kw)
    h0, cache = model.prefill(params, toks, cache, impl=impl, **extra)
    head = eh_ops.exit_confidence if impl == "kernel" else eh_ref.exit_confidence
    n_seg = model.num_segments
    picks, steps = 0, []

    def pick(h):
        nonlocal picks
        if cfg.is_encdec:
            return model.logits(params, h)[:, -1].float().argmax(-1)
        picks += 1
        return head(h, params["embed"])["token"][:, -1]

    def margin(h):
        top2 = model.logits(params, h)[:, -1].float().topk(2, dim=-1).values
        return (top2[:, 0] - top2[:, 1]).tolist()

    out = {"prefill": h0}
    for e in list(range(n_seg - 1)) + [None]:
        tok, got, mar = pick(h0), [], []
        if margins:
            mar.append(margin(h0))
        got.append(tok.tolist())
        for i in range(FAMILY_STEPS):
            nxt = tok if feed is None else torch.tensor(feed[e][i], device="cuda")
            h, cache, confs = model.decode_step(params, cache, nxt[:, None].int(), P + S + i,
                                                exit_point=e, impl=impl,
                                                with_exit_confidence=not cfg.is_encdec)
            steps.append(n_seg if e is None else e + 1)
            tok = pick(h)
            got.append(tok.tolist())
            if margins:
                mar.append(margin(h))
        out[e] = (got, mar if margins else None, h)
    out["cache"], out["calls"] = cache, (1, picks, steps)
    return out


def family_expected(model, calls):
    """The launches a ``family_run`` must count, from the model's structure:
    a prefill launches flash once a layer (the enc-dec: once an encoder
    layer, and twice a decoder layer, self and cross); a decode step runs
    decode attention once a layer it reaches (the enc-dec twice); the exit
    head picks each token and scores each intermediate exit a step passes
    (none for the enc-dec)."""
    cfg, segs = model.cfg, model.segment_lengths()
    prefills, picks, steps = calls
    if cfg.is_encdec:
        return {"flash_attention": prefills * (cfg.num_encoder_layers + 2 * cfg.num_layers),
                "decode_attention": sum(2 * sum(segs[:n]) for n in steps),
                "exit_confidence": 0}
    from repro_torch.models.transformer import unit_size
    u = unit_size(cfg)
    return {"flash_attention": prefills * cfg.num_layers,
            "decode_attention": sum(u * sum(segs[:n]) for n in steps),
            "exit_confidence": picks + sum(n - 1 for n in steps)}


def counted_run(torch, arch, label, model, params, toks, extra, **kw):
    """``family_run`` with every launch counter at zero before it; checks
    the counts against ``family_expected`` and that the family's kernels
    all ran.  Returns (result, counts)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    reset_launch_counts()
    require(not any(launch_counts().values()), "a launch counter did not reset")
    t0 = time.perf_counter()
    res = family_run(torch, model, params, toks, extra, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in launch_counts().items() if v}
    want = family_expected(model, res["calls"])
    label = f"{arch} {label}"
    log(f"phase 16 {label}: {wall:.2f} s for the prefill and {len(res['calls'][2])} decode "
        f"steps; launches {counts}, from the model's structure {want}")
    for name in FAMILY_KERNELS[arch]:
        require(counts.get(name, 0) > 0, f"{label}: kernel {name} was never launched")
    for name, n in want.items():
        require(counts.get(name, 0) == n, f"{label}: {counts.get(name, 0)} {name} launches, "
                f"the model's structure gives {n}")
    for e in [k for k in res if k not in ("prefill", "cache", "calls")]:
        require(torch.isfinite(res[e][2].float()).all().item(),
                f"{label}: non-finite hidden state at exit {e}")
    return res, counts


def held_paths(torch, label, kern, plain, routes=None):
    """Hold the float32 kernel path against the plain path, both decoding
    the plain path's tokens: last hidden states within HIDDEN_TOL (the
    prefill's and each exit's last step's) and each picked token equal
    unless the plain top-2 margin is below MARGIN_TOL (every flip logged).
    ``routes``: the MoE's router choices on the kernel and the plain path,
    call by call; with any token routed differently the paths part by
    design (a flip moves whole tokens and the capacity slots after them),
    and the end-to-end distances are logged, not held: every launch is
    then held on its own inputs (``shadowed_kernels``)."""
    flips_r = 0
    if routes is not None:
        rk, rp = routes
        require(len(rk) == len(rp), f"{label}: {len(rk)} MoE calls on the kernel path, "
                f"{len(rp)} on the plain path")
        for call, ((ek, _), (ep, mp)) in enumerate(zip(rk, rp)):
            diff = (ek != ep).nonzero().tolist()
            for b, s in diff:
                log(f"phase 16 {label}: MoE call {call} row {b} token {s}: expert "
                    f"{ek[b, s].item()} on the kernel path, {ep[b, s].item()} on the plain "
                    f"path, plain top-2 router margin {mp[b, s].item():.3g}")
            flips_r += len(diff)
        log(f"phase 16 {label}: {flips_r} router flips over {len(rk)} MoE calls "
            f"(smallest plain top-2 router margin "
            f"{min(m.min().item() for _, m in rp):.3g})")
    end_to_end = flips_r == 0
    e0 = (kern["prefill"].float() - plain["prefill"].float()).abs().max().item()
    worst_h, flips_t = e0, []
    for e in [k for k in plain if k not in ("prefill", "cache", "calls")]:
        (tk, _, hk), (tp, mp, hp) = kern[e], plain[e]
        for step, (a, b, m) in enumerate(zip(tk, tp, mp)):
            for row, (x, y) in enumerate(zip(a, b)):
                if x != y:
                    flips_t.append((e, step, row, m[row]))
        worst_h = max(worst_h, (hk.float() - hp.float()).abs().max().item())
    for e, step, row, m in flips_t:
        log(f"phase 16 {label}: token flip at exit {e} step {step} row {row}, plain "
            f"top-2 margin {m:.3g}")
    log(f"phase 16 {label}: kernel vs plain path, f32: prefill last hidden max_abs_err "
        f"{e0:.3g}, worst last hidden over the exits {worst_h:.3g} (tol {HIDDEN_TOL}), "
        f"{len(flips_t)} token flips; held end to end: {end_to_end}")
    if end_to_end:
        require(worst_h <= HIDDEN_TOL, f"{label}: last hidden states differ by {worst_h}")
        require(all(m < MARGIN_TOL for *_, m in flips_t),
                f"{label}: a token differs where the plain path's margin is above tolerance")


def padded_heads_zero(torch, model, params):
    """Scout's padding query heads (8 of 48) come out of attention exactly
    0, at a prefill through flash and a decode through decode attention:
    layer 0 with ``wo`` the identity shows attention's output itself."""
    from repro_torch.models import layers as L
    cfg = model.cfg
    h, kv, hd = cfg.padded_heads, cfg.num_kv_heads, cfg.hd
    pad = (torch.arange(h, device="cuda") % (h // kv)) >= cfg.num_heads // kv
    p = {k: v[0] for k, v in params["segments"][0]["attn"].items()}
    dt = p["wq"].dtype
    p["wo"] = torch.eye(h * hd, dtype=dt, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((BATCH, 13, cfg.d_model), generator=gen, device="cuda").to(dt)
    pos = torch.arange(13, device="cuda")[None].expand(BATCH, 13)
    ck = torch.zeros((BATCH, 13, kv, hd), dtype=dt, device="cuda")
    cv = torch.zeros_like(ck)
    o1, _ = L.attention(p, cfg, x[:, :12], pos[:, :12], kv_cache=(ck, cv), cache_pos=0,
                        prefill_mode=True)
    o2, _ = L.attention(p, cfg, x[:, 12:], pos[:, 12:], kv_cache=(ck, cv), cache_pos=12)
    for o in (o1, o2):
        o = o.reshape(BATCH, -1, h, hd)
        require(bool((o[:, :, pad] == 0).all()) and bool((o[:, :, ~pad] != 0).any()),
                "scout: a padding head's attention output is not exactly 0")
    log(f"phase 16 scout {dt}: {int(pad.sum())} padding heads of {h} exactly 0 at prefill "
        "(flash) and decode")


def family_serve(torch, arch, model, params):
    """``ServingEngine.serve`` of llava's text backbone (the engine feeds no
    prefix, as the reference's): 8 requests of 12-token prompts, batch 4,
    16 new tokens, bf16, the counts as phase 4's.  Returns its launches."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import Request, ServingEngine
    cfg = model.cfg
    graph, planner, link = serving_setup(cfg)
    engine = ServingEngine(model, params, graph, planner, link, batch_size=BATCH,
                           dtype=torch.bfloat16)
    calls = record_calls(model)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    stats = engine.serve(make_requests(Request, cfg.vocab_size,
                                       [(SHORT_PROMPT, SHORT_SLO)] * 8))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del model.prefill, model.decode_step         # record_calls' wrappers
    counts = {k: v for k, v in launch_counts().items() if v}
    want = expected_launches(model, calls["prompts"], calls["steps"])
    n_tok = sum(len(v) for v in stats.tokens.values())
    log(f"phase 16 serve {cfg.name} (text backbone): {stats.summary()}; exits "
        f"{stats.exits}; {n_tok} tokens in {wall:.3f} s, {n_tok / wall:.1f} tokens/s; "
        f"launches {counts}, from the model's structure {want}")
    require(len(stats.tokens) == 8 and all(len(t) == NEW_TOKENS and
                                           all(0 <= x < cfg.padded_vocab for x in t)
                                           for t in stats.tokens.values()),
            "serve llava: bad tokens")
    for name, n in want.items():
        require(counts.get(name, 0) == n, f"serve llava: {counts.get(name, 0)} {name} "
                f"launches, the model's structure gives {n}")
    return counts


def cache_bytes(cache):
    return sum(t.numel() * t.element_size() for t in _leaves(cache))


def family_phase(torch):
    """Phase 16: llava, seamless and scout at full width (scout's depth cut,
    SCOUT_LAYERS), each in bf16 through the kernels with its launches
    counted, then in float32 kernel path against plain path, held.
    Returns the launches of the bf16 runs, by kernel and by model."""
    from repro_torch.models import Model

    launches = {}

    def add(arch, counts):
        for name, n in counts.items():
            launches.setdefault(name, {}).setdefault(arch, 0)
            launches[name][arch] += n

    def shadow_log(label, worst):
        log(f"phase 16 {label}: launches held on their own inputs (count, worst share "
            f"of the allowed error, max_abs_err) {worst}")
        require(all(s <= 1.0 for _, s, _ in worst.values()),
                f"{label}: a launch disagrees with its plain version on its inputs")

    def gen0():
        return torch.Generator(device="cuda").manual_seed(0)

    # -- llava-next-mistral-7b: full width and depth
    cfg = family_config(LLAVA)
    model = Model(cfg)
    params = model.init_params(gen0(), dtype=torch.bfloat16, device="cuda")
    log(f"phase 16 {LLAVA}: {cfg.num_layers} layers d {cfg.d_model} heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} of {cfg.hd} d_ff {cfg.d_ff} vocab "
        f"{cfg.padded_vocab}, segments {model.segment_lengths()}, "
        f"{sum(p.numel() for p in _leaves(params)) / 1e9:.3f} B params in bf16; prefix "
        f"[{LLAVA_BATCH}, {cfg.num_prefix_tokens}, 1024] + {LLAVA_TEXT} text tokens; "
        "nothing cut")
    toks, extra = family_inputs(torch, cfg, LLAVA_BATCH, LLAVA_TEXT)
    res, counts = counted_run(torch, LLAVA, "bf16", model, params, toks, extra)
    add(LLAVA, counts)
    full_bytes = cache_bytes(res["cache"])
    del res
    res, counts = counted_run(torch, LLAVA, "bf16 int8 cache", model, params, toks, extra,
                              quant=True)
    add(LLAVA, counts)
    q_bytes = cache_bytes(res["cache"])
    log(f"phase 16 {LLAVA}: int8 cache {q_bytes / 1e6:.1f} MB against the bf16 cache's "
        f"{full_bytes / 1e6:.1f} MB: {q_bytes / full_bytes:.4f} (tol {INT8_BYTES})")
    require(q_bytes < INT8_BYTES * full_bytes, "llava: the int8 cache is not under "
            f"{INT8_BYTES} of the bf16 cache's bytes")
    del res
    add(LLAVA, family_serve(torch, LLAVA, model, params))
    # f32 hold at B1: kernel path against plain path, and the int8 cache
    params32 = _to_f32(params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    toks1, extra1 = toks[:1], {k: v[:1] for k, v in extra.items()}
    plain = family_run(torch, model, params32, toks1, extra1, impl="dense", margins=True)
    feed = {e: v[0] for e, v in plain.items() if e not in ("prefill", "cache", "calls")}
    worst = {}
    with shadowed_kernels(torch, worst):
        kern = family_run(torch, model, params32, toks1, extra1, feed=feed)
    shadow_log(f"{LLAVA} f32", worst)
    held_paths(torch, f"{LLAVA} f32 B1", kern, plain)
    q8 = family_run(torch, model, params32, toks1, extra1, quant=True, feed=feed)
    rel = max((q8[e][2] - kern[e][2]).abs().max().item() / kern[e][2].abs().max().item()
              for e in feed)
    log(f"phase 16 {LLAVA} f32 B1: int8-cache decode against the unquantized cache's "
        f"(same tokens), worst rel of the last hidden over the exits {rel:.4g} "
        f"(tol {INT8_REL})")
    require(rel < INT8_REL, f"llava: int8 decode rel {rel} >= {INT8_REL}")
    del plain, kern, q8, params32, model
    gc.collect()
    torch.cuda.empty_cache()

    # -- seamless-m4t-large-v2: full width and depth
    cfg = family_config(SEAMLESS)
    model = Model(cfg)
    params = model.init_params(gen0(), dtype=torch.bfloat16, device="cuda")
    log(f"phase 16 {SEAMLESS}: {cfg.num_encoder_layers} encoder + {cfg.num_layers} decoder "
        f"layers d {cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} of {cfg.hd} vocab "
        f"{cfg.padded_vocab}, decoder segments {model.segment_lengths()}, "
        f"{sum(p.numel() for p in _leaves(params)) / 1e9:.3f} B params in bf16; frames "
        f"[{BATCH}, {ENC_FRAMES}, 1024], {DEC_PROMPT}-token decoder prefill; nothing cut")
    toks, extra = family_inputs(torch, cfg, BATCH, DEC_PROMPT)
    res, counts = counted_run(torch, SEAMLESS, "bf16", model, params, toks, extra)
    add(SEAMLESS, counts)
    del res
    params32 = _to_f32(params)
    del params
    plain = family_run(torch, model, params32, toks, extra, impl="dense", margins=True)
    feed = {e: v[0] for e, v in plain.items() if e not in ("prefill", "cache", "calls")}
    worst = {}
    with shadowed_kernels(torch, worst):
        kern = family_run(torch, model, params32, toks, extra, feed=feed)
    shadow_log(f"{SEAMLESS} f32", worst)
    require(worst.get("flash non-causal", (0,))[0] > 0, "seamless: no non-causal flash ran")
    held_paths(torch, f"{SEAMLESS} f32", kern, plain)
    del plain, kern, params32, model
    gc.collect()
    torch.cuda.empty_cache()

    # -- llama4-scout-17b-a16e: full width, depth cut (SCOUT_LAYERS)
    cfg = family_config(SCOUT, "bf16")
    model = Model(cfg)
    params = model.init_params(gen0(), dtype=torch.bfloat16, device="cuda")
    log(f"phase 16 {SCOUT}: d {cfg.d_model} heads {cfg.num_heads} padded to "
        f"{cfg.padded_heads} over {cfg.num_kv_heads} of {cfg.hd}, {cfg.num_experts} experts "
        f"of d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}; reduced: depth 48 -> "
        f"{SCOUT_LAYERS['bf16']} layers in bf16 ({SCOUT_LAYERS['f32']} for the f32 hold), "
        "as 48 layers hold ~201 GB of bf16 weights, beyond one card's 80 GB; segments "
        f"{model.segment_lengths()}, {sum(p.numel() for p in _leaves(params)) / 1e9:.3f} B "
        "params in bf16; einsum dispatch")
    toks, extra = family_inputs(torch, cfg, BATCH, LONG_PROMPT)
    res, counts = counted_run(torch, SCOUT, "bf16", model, params, toks, extra)
    add(SCOUT, counts)
    del res
    padded_heads_zero(torch, model, params)
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    cfg = family_config(SCOUT, "f32")
    model = Model(cfg)
    params32 = model.init_params(gen0(), dtype=torch.float32, device="cuda")
    padded_heads_zero(torch, model, params32)
    # the gather dispatch against the einsum dispatch on the embedded
    # 1000-token prompts
    from repro_torch.models import transformer as TF
    gather_vs_einsum(f"phase 16 {SCOUT} f32", cfg,
                     {k: v[0] for k, v in params32["segments"][0]["moe"].items()},
                     TF._embed_inputs(cfg, params32, toks, None))
    routes_p, routes_k = [], []
    with recorded_routes(torch, routes_p):
        plain = family_run(torch, model, params32, toks, extra, impl="dense", margins=True)
    feed = {e: v[0] for e, v in plain.items() if e not in ("prefill", "cache", "calls")}
    worst = {}
    with shadowed_kernels(torch, worst), recorded_routes(torch, routes_k):
        kern = family_run(torch, model, params32, toks, extra, feed=feed)
    shadow_log(f"{SCOUT} f32", worst)
    require(worst.get("G6", (0,))[0] > 0, "scout: no G = 6 launch was held")
    held_paths(torch, f"{SCOUT} f32", kern, plain, routes=(routes_k, routes_p))
    del plain, kern, params32, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 17
# The simulator on the card, as a user drives it: ``Simulation`` with real
# decode at the smoke size the reference's sim defines (every smoke config
# has 4 heads of 16), a sweep over a spawn pool, the command line and the
# observers, and a sharded timing-only run.  The real-decode spec is the
# arena suite's static scenario (tests/test_arena.py::_static_spec): seed 3,
# 8 devices, 2 edges of 8 slots, 6-token prompts, 53 requests.
SIM_STRATEGIES = {"serial": (False, False), "batched": (True, False),
                  "arena": (True, True)}           # (batch_decode, arena_decode)
# smoke-mobility reshaped as tests/test_shard.py's scale smoke: 400 devices
# over 8 edges in 8 geography tiles, a 15 s horizon
SHARD_TILES, SHARD_DEVICES, SHARD_EDGES, SHARD_HORIZON = 8, 400, 8, 15.0


def sim_spec(strategy="arena", arch=LLAMA):
    from repro_torch.fleet.workload import TenantClass
    from repro_torch.sim import (EngineSpec, PlannerSpec, RouterSpec, ScenarioSpec,
                                 TopologySpec, WorkloadSpec)
    batch, arena = SIM_STRATEGIES[strategy]
    tenants = (TenantClass("interactive", slo_s=1.0, max_new_tokens=6, weight=0.5),
               TenantClass("standard", slo_s=2.0, max_new_tokens=10, weight=0.5))
    return ScenarioSpec(
        name="arena-static", seed=3, planner=PlannerSpec(arch=arch),
        topology=TopologySpec(num_devices=8, num_edges=2, trace="lte",
                              edge_capacity=SIM_SLOTS, max_edge_slowdown=2.0),
        workload=WorkloadSpec(rate_hz=10.0, horizon_s=4.0, device_skew=0.5,
                              prompt_len=SIM_PROMPT, tenants=tenants),
        router=RouterSpec(name="bandwidth-aware"),
        engine=EngineSpec(real_decode=True, batch_decode=batch, arena_decode=arena))


@contextlib.contextmanager
def one_cpu_thread(torch):
    """One intra-op thread for the smoke model's CPU runs: its products are
    a few KB, and more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def sim_real_decode(torch):
    """``Simulation(spec).run()`` with real decode on the card in float32,
    serial, batched and arena, each held against the port's own CPU run of
    the same spec on the same parameters (the card's, copied): token
    streams equal except from a step whose CPU serial top-2 margin is below
    MARGIN_TOL (every flip logged with its margin), summaries equal when no
    stream flips.  Returns the launches of the card runs."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.sim import Simulation
    from repro_torch.tree import tree_map

    launches, margins = {}, None
    for strategy in SIM_STRATEGIES:
        spec = sim_spec(strategy)
        sim = Simulation(spec)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        m_card = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        require(sim.scenario.cfg.hd == 16, f"phase 17: smoke head dim {sim.scenario.cfg.hd}")
        for name in ("flash_attention", "decode_attention"):
            require(counts[name] > 0, f"phase 17: {strategy} real decode launched no {name}")
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        t_card = {r.rid: list(r.tokens) for r in sim.scenario.workload}
        cpu = Simulation(spec, device="cpu")
        sc = cpu.build()
        sc.params = sc.engine.params = tree_map(lambda t: t.detach().cpu(),
                                                sim.scenario.params)
        if strategy == "serial":
            margins = record_margins(sc.engine)
        with one_cpu_thread(torch):
            m_cpu = sc.engine.run(sc.workload)
        t_cpu = {r.rid: list(r.tokens) for r in sc.workload}
        equal, total, parted = streams_held(f"phase 17 {strategy}", t_cpu, t_card, margins)
        if not parted:
            require(json.dumps(m_card.summary(), sort_keys=True)
                    == json.dumps(m_cpu.summary(), sort_keys=True),
                    f"phase 17: {strategy} summary on the card differs from the CPU's")
        st = sim.scenario.engine.stepper.cache_stats()
        log(f"phase 17: Simulation real decode {strategy} f32 on the card (hd 16, G 2): "
            f"{len(t_card)} requests, {equal} of {total} tokens equal to the CPU run, "
            f"flips (request: step, CPU margin) {parted}, summaries equal "
            f"{m_card.summary() == m_cpu.summary()}; launches {counts}; wall {wall:.4f} s; "
            f"decode {st['decode']} arena {st['arena']}")
    return launches


def sim_sweep(torch):
    """``run_sweep`` over planner.arch x engine.arena_decode on the card,
    inline (one arch at a time, its launches counted) and over a spawn pool
    of two workers, each with its own CUDA context: rows equal except
    ``wall_s``.  Returns {arch: launches}."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.sim import grid_cells, run_sweep

    cells, inline, by_arch = [], [], {}
    for arch in (LLAMA, ZAMBA):
        arch_cells = grid_cells(sim_spec("batched", arch),
                                {"engine.arena_decode": [False, True]})
        torch.cuda.synchronize()
        reset_launch_counts()
        inline += run_sweep(arch_cells)
        torch.cuda.synchronize()
        by_arch[arch] = launch_counts()
        cells += arch_cells
    t0 = time.perf_counter()
    pooled = run_sweep(cells, processes=2)
    t_pool = time.perf_counter() - t0

    def strip(rows):
        return json.loads(json.dumps([{k: v for k, v in r.items() if k != "wall_s"}
                                      for r in rows], default=float))
    require(strip(inline) == strip(pooled), "phase 17: the spawn-pool sweep's rows "
            "differ from the inline sweep's")
    for name in ("flash_attention", "decode_attention"):
        require(all(c[name] > 0 for c in by_arch.values()),
                f"phase 17: a sweep arch launched no {name}: {by_arch}")
    require(by_arch[ZAMBA]["ssm_scan.stepped"] > 0, "phase 17: zamba2's sweep cells "
            f"ran no stepped scan: {by_arch[ZAMBA]}")
    for row in inline:
        log(f"phase 17: sweep cell {row['spec']['planner']['arch']} arena "
            f"{row['spec']['engine']['arena_decode']}: requests "
            f"{row['metrics']['requests']}, decode {row['decode']}, wall {row['wall_s']} s")
    log(f"phase 17: sweep of {len(cells)} cells: processes=2 (spawn, two CUDA contexts, "
        f"{t_pool:.1f} s) rows equal to inline except wall_s; launches inline by arch "
        f"{by_arch}")
    return by_arch


def sim_cli_start():
    """Start ``python -m repro_torch.sim --scenario smoke-lm --set
    engine.real_decode=true --json`` with real decode on the card, twice
    at once: with ``--trace``/``--timeline`` and without.  They run beside
    the rest of phase 17 (each is host-bound, ~40 s); their output goes to
    files under ``build/phase17``."""
    import os
    out = ROOT / "build" / "phase17"
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    base = [sys.executable, "-m", "repro_torch.sim", "--scenario", "smoke-lm",
            "--set", "engine.real_decode=true", "--json"]
    cli = {"out": out, "env": env, "t0": time.perf_counter(), "procs": []}
    for tag, extra in (("observed", ["--trace", str(out / "trace.json"),
                                     "--timeline", str(out / "timeline.jsonl")]),
                       ("plain", [])):
        stdout, stderr = open(out / f"{tag}.out", "w"), open(out / f"{tag}.err", "w")
        cli["procs"].append((tag, subprocess.Popen(base + extra, stdout=stdout, stderr=stderr,
                                                   env=env, cwd=str(ROOT)), stdout, stderr))
    return cli


def sim_cli_stop(cli):
    """Stop whatever ``sim_cli_start`` started and is still running."""
    for _tag, p, stdout, stderr in cli["procs"]:
        if p.poll() is None:
            p.kill()
        p.wait()
        stdout.close()
        stderr.close()


def sim_cli_finish(cli):
    """Wait for both commands: exit 0, metrics bit-identical with and
    without the observers, and ``python -m repro_torch.obs validate``
    passing on the trace; then delete the artifacts."""
    out = {}
    for tag, p, _stdout, _stderr in cli["procs"]:
        rc = p.wait(timeout=300)
        err = (cli["out"] / f"{tag}.err").read_text()
        require(rc == 0, f"phase 17: python -m repro_torch.sim ({tag}) exited {rc}: "
                f"{err[-2000:]}")
        out[tag] = json.loads((cli["out"] / f"{tag}.out").read_text())
    wall = time.perf_counter() - cli["t0"]
    require(out["observed"]["metrics"] == out["plain"]["metrics"], "phase 17: "
            "--trace/--timeline changed the CLI's metrics")
    trace = cli["out"] / "trace.json"
    val = subprocess.run([sys.executable, "-m", "repro_torch.obs", "validate", str(trace)],
                         capture_output=True, text=True, env=cli["env"], cwd=str(ROOT),
                         timeout=120)
    require(val.returncode == 0, f"phase 17: obs validate failed: {val.stderr[-2000:]}")
    m = out["plain"]
    log(f"phase 17: python -m repro_torch.sim --scenario smoke-lm real decode on the card "
        f"(two processes beside the rest of phase 17, {wall:.1f} s from their start): exit 0, "
        f"metrics bit-identical with and without --trace/--timeline (requests "
        f"{m['metrics']['requests']}, events {m['events']['processed']}); "
        f"{val.stdout.strip()}")
    sim_cli_stop(cli)
    import shutil
    shutil.rmtree(cli["out"])


def sim_sharded(torch):
    """smoke-mobility in SHARD_TILES geography tiles, timing-only: a spawn
    pool of 4 workers against one process, merged summaries and handover
    logs bit-identical."""
    import dataclasses

    from repro_torch.sim import get_scenario
    from repro_torch.sim.shard import run_sharded_info

    base = get_scenario("smoke-mobility")
    spec = dataclasses.replace(
        base, topology=dataclasses.replace(base.topology, shards=SHARD_TILES,
                                           num_devices=SHARD_DEVICES,
                                           num_edges=SHARD_EDGES),
        workload=dataclasses.replace(base.workload, horizon_s=SHARD_HORIZON),
        engine=dataclasses.replace(base.engine, retain_records=False))
    t0 = time.perf_counter()
    seq, info = run_sharded_info(spec, processes=1)
    t1 = time.perf_counter()
    par, _ = run_sharded_info(spec, processes=4)
    t2 = time.perf_counter()
    require(json.dumps(seq.summary(), sort_keys=True) == json.dumps(par.summary(), sort_keys=True),
            "phase 17: sharded summaries differ between processes=4 and 1")
    require(seq.handover_log == par.handover_log, "phase 17: sharded handover logs differ")
    log(f"phase 17: smoke-mobility in {SHARD_TILES} tiles ({SHARD_DEVICES} devices, "
        f"{SHARD_EDGES} edges, {SHARD_HORIZON} s): {info['requests']} requests, "
        f"{info['events_processed']} events, handovers {seq.summary().get('handovers')}; "
        f"processes=4 ({t2 - t1:.1f} s) bit-identical to processes=1 ({t1 - t0:.1f} s)")


def sim_phase(torch):
    """Phase 17 (see the module docstring): returns the launches of its
    real-decode runs and, by arch, those of its inline sweep."""
    t0 = time.perf_counter()
    cli = sim_cli_start()
    try:
        launches = sim_real_decode(torch)
        t1 = time.perf_counter()
        by_arch = sim_sweep(torch)
        t2 = time.perf_counter()
        sim_sharded(torch)
        t3 = time.perf_counter()
        sim_cli_finish(cli)
    finally:
        sim_cli_stop(cli)
    t4 = time.perf_counter()
    log(f"chip_smoke: phase 17 took {t4 - t0:.1f} s (real decode {t1 - t0:.1f}, sweep "
        f"{t2 - t1:.1f}, sharded {t3 - t2:.1f}, then waiting on the CLI {t4 - t3:.1f}); "
        f"launches of the real-decode runs {launches}, of the inline sweep by arch "
        f"{by_arch}")
    return launches, by_arch


# ---------------------------------------------------------------- phases 18-19
# Every other served config at full width: granite-3-2b (llama3.2-1b's
# attention, 32/8 heads of 64, at 40 layers; V 49155, padded to 49280),
# granite-3-8b (32/8 heads of 128; the same V) and starcoder2-15b (48 heads
# over 4: G 12, hd 128; D 6144, V 49152) through ``ServingEngine.serve`` as
# phases 4-9, llama4-maverick-400b-a17b at 2 of 48 layers (CUT_LAYERS), and
# the fleet with real decode for scout, llava's text backbone and
# starcoder2-15b as phases 10-11.  Random weights from torch.Generator seed 0.
DENSE_CONFIGS = (GRANITE2, GRANITE8, STARCODER)


def config_kernel_times(torch):
    """Phase 3 at phases 18-19's new shapes: each kernel against its plain
    version in bfloat16 and float32, then timed (bf16) beside its plain
    version, SDPA or the library composite, and its bound.  Flash at G 12
    (starcoder2-15b, hd 128): its prefills S 1000 (a ragged last q-tile) and
    S 12 (one q-tile, the second consumer warpgroup's rows all past S), T >
    S, and a single ragged tile; granite-3-8b's S 1000 at G 4 hd 128.
    Decode at G 12 (384 threads a block, ~75 KB of shared memory): the
    serving caches T 1017 and 29 with lengths on a split boundary, one past
    it, past T and zero; granite-3-8b's T 1017.  The exit head at the three
    served (D, V): 4 x 2048 x 49280, 4 x 4096 x 49280, 4 x 6144 x 49152 with
    exact ties and with every logit negative (the f32 head at D 6144 stages
    4 x 6144 floats, 98 KB, a block), and at granite's real V 49155, where
    the kernel's last 128-row tile holds 125 rows past V: all logits
    negative, and the last real row tied at 0 with what an unmasked padding
    row would score.  From a generator of its own (seed 18), so that the
    other phase-3 inputs stay those of earlier runs.  Returns ``{kernel:
    {label: times}}``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops

    gen = torch.Generator(device="cuda").manual_seed(18)
    timer = Timer(torch)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    out = {"flash_attention": {}, "decode_attention": {}, "exit_confidence": {}}

    def keep(kernel, label, t):
        if t is not None:
            out[kernel][label] = t

    sc, g8 = get_config(STARCODER), get_config(GRANITE8)
    H, KV, hd = sc.num_heads, sc.num_kv_heads, sc.hd
    gH, gKV, ghd = g8.num_heads, g8.num_kv_heads, g8.hd
    T = LONG_PROMPT + NEW_TOKENS + 1
    T_SHORT = SHORT_PROMPT + NEW_TOKENS + 1
    SK = fa_ops.SPLIT_KEYS
    for dt in (torch.bfloat16, torch.float32):
        for label, case in (
                (f"{STARCODER} prefill", (BATCH, LONG_PROMPT, LONG_PROMPT, H, KV, hd)),
                (f"{STARCODER} short prefill", (BATCH, SHORT_PROMPT, SHORT_PROMPT, H, KV, hd)),
                (f"{GRANITE8} prefill", (BATCH, LONG_PROMPT, LONG_PROMPT, gH, gKV, ghd)),
                (None, (2, 100, 300, H, KV, hd)),
                (None, (2, 77, 77, H, KV, hd))):
            keep("flash_attention", label,
                 flash_check(torch, timer, randn, dt, *case, timed=label is not None))
        for label, case in (
                (f"{STARCODER} decode", (BATCH, T, H, KV, hd, [T - 1] * BATCH)),
                (f"{STARCODER} short decode", (BATCH, T_SHORT, H, KV, hd,
                                               [T_SHORT - 1] * BATCH)),
                (None, (BATCH, T, H, KV, hd, [SK, SK + 1, T + 7, 0])),
                (None, (BATCH, T, H, KV, hd, [5 * SK, 5 * SK + 1, 0, T])),
                (None, (BATCH, T_SHORT, H, KV, hd, [0, 5, T_SHORT + 3, T_SHORT - 1])),
                (f"{GRANITE8} decode", (BATCH, T, gH, gKV, ghd, [T - 1] * BATCH))):
            keep("decode_attention", label,
                 decode_check(torch, timer, randn, dt, *case, timed=label is not None))
        for arch in DENSE_CONFIGS:
            cfg = get_config(arch)
            keep("exit_confidence", f"{arch} exit head",
                 exit_head_check(torch, timer, randn, dt, BATCH, cfg.d_model,
                                 cfg.padded_vocab, timed=True))
            exit_head_check(torch, timer, randn, dt, BATCH, cfg.d_model, cfg.padded_vocab,
                            negative=True)
        for arch in (GRANITE2, GRANITE8):
            cfg = get_config(arch)
            exit_head_check(torch, timer, randn, dt, BATCH, cfg.d_model, cfg.vocab_size,
                            negative=True, pad_tie=True)
    for kernel, times in out.items():
        for label, t in times.items():
            log(f"time {kernel} {label}: {t}")
    exit_tickets_zero(torch)
    del timer
    torch.cuda.empty_cache()
    return out


def gather_vs_einsum(label, cfg, lp, x):
    """An MoE layer's gather dispatch against its einsum dispatch on ``x``,
    at the reference's own tolerance for the pair (tests/test_layers.py:
    2e-4, the aux loss 1e-5 relative); logs the tokens dropped past
    capacity."""
    from repro_torch.models import moe as MOE
    ye, ae = MOE.moe_ffn(lp, cfg, x, dispatch_mode="einsum")
    yg, ag = MOE.moe_ffn(lp, cfg, x, dispatch_mode="gather")
    ge = (ye.float() - yg.float()).abs().max().item()
    B, S, D = x.shape
    log(f"{label}: gather against einsum dispatch at E {cfg.num_experts} on [{B}, {S}, "
        f"{D}]: max_abs_err {ge:.3g} (tol 2e-4), aux {ae.item():.6g} / {ag.item():.6g}, "
        f"{int((yg == 0).all(-1).sum())} tokens dropped past capacity "
        f"{MOE._capacity(S, cfg)}")
    require(ge <= 2e-4 and abs(ae.item() - ag.item()) <= 1e-5 * abs(ae.item()),
            f"{label}: the gather dispatch disagrees with the einsum dispatch")


def maverick_phase(torch):
    """llama4-maverick at full width and 2 of its 48 layers (CUT_LAYERS) in
    bf16 through ``ServingEngine.serve`` as phases 4, 6 and 8, then its MoE
    layer's gather dispatch against the einsum dispatch (E 128) on the
    embedded 1000-token prompts: both feed the same slabs to the same expert
    products, and their one-hot dispatch and combine products are exact, so
    they are held at the reference's tolerance for the pair (2e-4; the aux
    loss at 1e-5 relative) in bf16.  Returns the serve's launches."""
    from repro_torch.models import transformer as TF

    cfg = family_config(MAVERICK)
    log(f"phase 18 {MAVERICK}: d {cfg.d_model}, {cfg.num_experts} experts of d_ff "
        f"{cfg.d_ff} every second layer; reduced: depth 48 -> {cfg.num_layers} layers "
        f"(one dense/MoE unit: its 24 MoE layers hold ~386 B parameters)")
    params, counts = serve_main_path(torch, MAVERICK, cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (BATCH, LONG_PROMPT), generator=gen,
                         device="cuda")
    seg = next(sp for sp in params["segments"] if sp["moe"]["wg"].shape[0])
    gather_vs_einsum(f"phase 18 {MAVERICK} bf16", cfg,
                     {k: v[0] for k, v in seg["moe"].items()},
                     TF._embed_inputs(cfg, params, toks, None))
    del params, seg
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def dense_phase(torch):
    """Phase 18: granite-3-2b, granite-3-8b and starcoder2-15b at full width
    and depth in bf16 through ``ServingEngine.serve`` (every launch counter
    equal to what the model's structure and the steps give), each then
    kernel path against plain path in float32 as phase 5 (starcoder2-15b at
    the depth of CUT_LAYERS, parameters drawn anew in float32); then
    maverick (``maverick_phase``).  Returns the launches by kernel and by
    config."""
    from repro_torch.models import Model

    launches = {}
    for arch in DENSE_CONFIGS:
        t0 = time.perf_counter()
        params, counts = serve_main_path(torch, arch)
        for name, n in counts.items():
            launches.setdefault(name, {})[arch] = n
        t1 = time.perf_counter()
        cfg32 = family_config(arch, "f32")
        if cfg32 != family_config(arch):
            del params
            gc.collect()
            torch.cuda.empty_cache()
            params = Model(cfg32).init_params(torch.Generator(device="cuda").manual_seed(0),
                                              dtype=torch.float32, device="cuda")
            log(f"phase 18 {arch} f32: reduced to {cfg32.num_layers} layers, parameters "
                "from seed 0 in float32")
        kernel_vs_plain(torch, params, arch, cfg32)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        log(f"chip_smoke: phase 18 {arch}: serve {t1 - t0:.1f} s, kernel vs plain path "
            f"{time.perf_counter() - t1:.1f} s")
    t0 = time.perf_counter()
    for name, n in maverick_phase(torch).items():
        launches.setdefault(name, {})[MAVERICK] = n
    log(f"chip_smoke: phase 18 {MAVERICK}: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 20
# the substrate on the card: the sharded steps of launch/steps.py on
# make_host_mesh() over the one card (NCCL, a world of one, mesh 1x1)
SUB_PREFILL = (1024, 4)            # llama3.2-1b prefill step: seq, batch
SUB_STEPS = 16                     # serve steps at each exit
SUB_DECODE_AT = 1008               # first decode position in the 1024 cache
SUB_RWKV = (12, 8, 4)              # rwkv6-3b: prompt, steps, batch
SUB_TRAIN_SEQ = 2049               # B1 S2048 train steps (the model sees 2048)
SUB_TRAIN_TOL = 1e-5               # loss and every parameter, mesh against mesh-less
SUB_TRAIN_KW = dict(peak_lr=1e-2, warmup=1, total_steps=10, remat=True)
SUB_DRYRUN = ("llama3.2-1b", "decode_32k", "single")


def substrate_counts(model, steps_at):
    """The launches phase 20's llama3.2-1b steps must count: one flash
    launch a layer in the prefill step; in a serve step at exit e one
    decode launch a layer of segments [0, e] and one exit-head launch at
    each exit passed before e."""
    segs = model.segment_lengths()
    dec = sum(steps_at[e] * sum(segs[:e + 1]) for e in steps_at)
    heads = sum(steps_at[e] * e for e in steps_at)
    return {"flash_attention": sum(segs), "decode_attention": dec,
            "exit_confidence": heads}


def substrate_llama(torch, mesh, dtype, params, dev="cuda"):
    """The prefill step at SUB_PREFILL with the kernels, then SUB_STEPS
    serve steps at every exit from its cache, greedy.  Returns (h, the
    tokens of every exit, the counts of the serve steps by exit)."""
    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.api import Model

    model = Model(get_config(LLAMA))
    S, B = SUB_PREFILL
    prefill, _ = make_prefill_step(model, mesh, ShapeConfig("p", S, B, "prefill"),
                                   attn_impl="kernel")
    batch = model.make_inputs(ShapeConfig("p", S, B, "prefill"),
                              generator=torch.Generator(device=dev).manual_seed(20),
                              device=dev)
    h, cache = prefill(params, batch)
    toks, shape = {}, ShapeConfig("d", S, B, "decode")
    for e in range(model.num_segments):
        step, _ = make_serve_step(model, mesh, shape, exit_point=e,
                                  with_exit_confidence=True, use_exit_kernel=True)
        c = _tree_clone(cache)
        tok = batch["tokens"][:, SUB_DECODE_AT:SUB_DECODE_AT + 1]
        out = []
        for i in range(SUB_STEPS):
            pos = torch.tensor(SUB_DECODE_AT + i, dtype=torch.int32, device=dev)
            tok, c = step(params, c, {"tokens": tok, "pos": pos})
            tok = _local(tok)
            out.append(tok[:, 0].tolist())
        toks[e] = out
    return _local(h), toks, {e: SUB_STEPS for e in toks}, batch, cache


def _local(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_clone(v) for v in tree)
    return _local(tree).clone()


def substrate_meshless(torch, params, batch, toks, dev="cuda"):
    """The mesh-less path on phase 20's llama3.2-1b inputs: ``Model.prefill``
    and, at every exit, ``decode_step`` fed the mesh path's tokens.  Returns
    (h, tokens by exit, top-2 margins by exit)."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import Model

    model = Model(get_config(LLAMA))
    S, B = SUB_PREFILL
    cache = model.init_cache(B, S, device=dev)
    h, cache = model.prefill(params, batch["tokens"], cache, impl="kernel")
    want, margins = {}, {}
    for e, steps in toks.items():
        c = _tree_clone(cache)
        tok = batch["tokens"][:, SUB_DECODE_AT:SUB_DECODE_AT + 1]
        out, mar = [], []
        for i in range(SUB_STEPS):
            hh, c, _ = model.decode_step(params, c, tok, SUB_DECODE_AT + i, exit_point=e,
                                         with_exit_confidence=True, impl="kernel")
            logits = model.logits(params, hh)[:, -1].float()
            top2 = logits.topk(2, dim=-1).values
            out.append(logits.argmax(-1).tolist())
            mar.append((top2[:, 0] - top2[:, 1]).tolist())
            tok = torch.tensor(steps[i], dtype=batch["tokens"].dtype, device=dev)[:, None]
        want[e], margins[e] = out, mar
    return h, want, margins


def substrate_phase(torch, dev="cuda"):
    """Phase 20: the multi-device substrate on the card.  Returns the
    launches of its main-path runs by kernel."""
    import shutil
    import types

    import torch.distributed as dist

    from repro_torch import tree as T
    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PrefetchLoader
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ssm_scan import ops as ss_ops
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
    from repro_torch.models.api import Model
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.serving.engine import CoInferenceStepper
    from repro_torch.spmd import is_dtensor

    t_phase = time.perf_counter()
    mesh = make_host_mesh(device=dev)
    log(f"phase 20: mesh {tuple(mesh.mesh_dim_names)} {tuple(mesh.shape)} over a world of "
        f"{dist.get_world_size()} on {dist.get_backend()}")
    totals = {}
    model = Model(get_config(LLAMA))

    # -- llama3.2-1b prefill + serve at full width and depth, bf16, counted
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dtype=torch.bfloat16, device=dev)
    reset_launch_counts()
    require(not any(launch_counts().values()), "phase 20: counters not zero")
    h, toks, steps_at, _, _ = substrate_llama(torch, mesh, torch.bfloat16, params, dev)
    got = launch_counts()
    want = substrate_counts(model, steps_at)
    for name, n in want.items():
        require(got[name] == n, f"phase 20: {name} launched {got[name]} times, the "
                                f"structure and the steps give {n}")
    require(bool(torch.isfinite(h.float()).all()), "phase 20: bf16 hidden not finite")
    for k, n in want.items():
        totals[k] = totals.get(k, 0) + n
    log(f"phase 20: llama3.2-1b bf16 prefill step B{SUB_PREFILL[1]} S{SUB_PREFILL[0]} "
        f"(flash kernel) and {SUB_STEPS} serve steps at each of {len(toks)} exits (decode "
        f"and exit-head kernels) on the mesh: launches {want}, each as the structure gives; "
        f"{time.perf_counter() - t0:.1f} s")
    del params, h
    torch.cuda.empty_cache() if dev == "cuda" else None

    # -- the same in f32 against the mesh-less path
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dtype=torch.float32, device=dev)
    h, toks, _, batch, _ = substrate_llama(torch, mesh, torch.float32, params, dev)
    h0, want_toks, margins = substrate_meshless(torch, params, batch, toks, dev)
    err = (h.float() - h0.float()).abs().max().item()
    require(err <= HIDDEN_TOL, f"phase 20: f32 prefill hidden {err:.3e} > {HIDDEN_TOL}")
    flips, same = [], True
    for e in toks:
        for i, (a, b, m) in enumerate(zip(toks[e], want_toks[e], margins[e])):
            for r, (x, y, mm) in enumerate(zip(a, b, m)):
                if x != y:
                    same = False
                    require(mm < MARGIN_TOL, f"phase 20: exit {e} step {i} row {r}: token "
                                             f"{x} against {y} at margin {mm:.3e}")
                    flips.append((e, i, r, mm))
    log(f"phase 20: f32 mesh against mesh-less: last hidden max |diff| {err:.3e} "
        f"(bitwise equal: {bool(torch.equal(h, h0))}); tokens at every exit "
        f"{'equal' if same else f'equal but at {flips} (margins under {MARGIN_TOL})'}; "
        f"{time.perf_counter() - t0:.1f} s")
    del params, h, h0
    torch.cuda.empty_cache() if dev == "cuda" else None

    # -- rwkv6-3b at full width, bf16: the scan kernel under the mesh, each
    #    launch held against its plain version
    t0 = time.perf_counter()
    rmodel = Model(get_config(RWKV))
    rparams = rmodel.init_params(torch.Generator(device=dev).manual_seed(0),
                                 dtype=torch.bfloat16, device=dev)
    S, n_steps, B = SUB_RWKV
    worst = {"calls": 0, "o": 0.0, "state": 0.0, "err": 0.0}
    ss_ops_launch = ss_ops.ssm_scan
    # each local launch against the plain scan on the same inputs taken to
    # float32, so the plain output is not rounded to bf16 a second time
    held = shadowed_scan(lambda q, k, v, lw, st, u=None: ss_ops_launch(q, k, v, lw, st, u=u),
                         worst, widen=True)

    def local_held(*a, **k):            # hold the local launches only
        return ss_ops_launch(*a, **k) if is_dtensor(a[0]) else held(*a, **k)

    reset_launch_counts()
    with patched(ss_ops, "ssm_scan", local_held):
        pre, _ = make_prefill_step(rmodel, mesh, ShapeConfig("p", S, B, "prefill"),
                                   use_kernel=True)
        rb = rmodel.make_inputs(ShapeConfig("p", S, B, "prefill"),
                                generator=torch.Generator(device=dev).manual_seed(21),
                                device=dev)
        h, cache = pre(rparams, rb)
        serve, _ = make_serve_step(rmodel, mesh, ShapeConfig("d", S, B, "decode"),
                                   use_kernel=True)
        tok = rb["tokens"][:, -1:]
        for i in range(n_steps):
            pos = torch.tensor(S + i, dtype=torch.int32, device=dev)
            tok, cache = serve(rparams, cache, {"tokens": _local(tok), "pos": pos})
    got = launch_counts()
    n_layers = rmodel.cfg.num_layers
    want_scan = n_layers * (1 + n_steps)
    require(got["ssm_scan"] == want_scan and worst["calls"] == want_scan,
            f"phase 20: rwkv6-3b scan launches {got['ssm_scan']} (held {worst['calls']}), "
            f"want {want_scan}")
    require(worst["o"] <= 1.0 and worst["state"] <= 1.0,
            f"phase 20: rwkv6-3b scan off its plain version: {worst}")
    totals["ssm_scan"] = totals.get("ssm_scan", 0) + want_scan
    log(f"phase 20: rwkv6-3b bf16 on the mesh: {S}-token prefill step and {n_steps} serve "
        f"steps, B{B}: {want_scan} scan launches ({ {k: got[k] for k in got if k.startswith('ssm')} }), "
        f"each held against the plain scan: worst share of the tolerance output "
        f"{worst['o']:.3e}, state {worst['state']:.3e}, max |err| {worst['err']:.3e}; "
        f"{time.perf_counter() - t0:.1f} s")
    del rparams, cache, h
    torch.cuda.empty_cache() if dev == "cuda" else None

    # -- training, llama3.2-1b f32 B1 S2048: mesh against mesh-less
    t0 = time.perf_counter()
    shape = ShapeConfig("t", SUB_TRAIN_SEQ - 1, 1, "train")
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dtype=torch.float32, device=dev)
    tb = model.make_inputs(shape, generator=torch.Generator(device=dev).manual_seed(22),
                           device=dev)
    plain, _ = make_train_step(model, None, shape, device=dev, **SUB_TRAIN_KW)

    def timed(step):
        """The step's outputs and the wall of its second call (the first
        warms the allocator and, on a mesh, DTensor's sharding cache), each
        call on a copy of the parameters: the step donates the state."""
        step(T.tree_map(torch.clone, params), adamw_init(params), tb)
        sync()
        t1 = time.perf_counter()
        out = step(T.tree_map(torch.clone, params), adamw_init(params), tb)
        sync()
        return out, time.perf_counter() - t1

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    (p0, _, m0), wall0 = timed(plain)
    want_p = [x.detach() for x in T.leaves(p0)]
    del p0
    log(f"phase 20: the mesh-less f32 train step B1 S{SUB_TRAIN_SEQ - 1}: wall {wall0:.3f} s")
    walls = {}
    for sp in (False, True):
        step, _ = make_train_step(model, mesh, shape, seq_parallel=sp, **SUB_TRAIN_KW)
        (p1, _, m1), walls[sp] = timed(step)
        dl = abs(float(m1["loss"]) - float(m0["loss"]))
        require(dl <= SUB_TRAIN_TOL, f"phase 20: seq_parallel={sp} loss {dl:.3e} off")
        worst_p = max((_local(a).float() - b.float()).abs().max().item()
                      for a, b in zip(T.leaves(p1), want_p))
        require(worst_p <= SUB_TRAIN_TOL,
                f"phase 20: seq_parallel={sp} params {worst_p:.3e} off the mesh-less step")
        log(f"phase 20: llama3.2-1b f32 train step B1 S{SUB_TRAIN_SEQ - 1} on the mesh, "
            f"seq_parallel={sp}: loss {float(m1['loss']):.6f} (|diff| {dl:.3e} from the "
            f"mesh-less step), worst parameter |diff| {worst_p:.3e}; wall {walls[sp]:.3f} s, "
            f"{walls[sp] / wall0:.3f} of the mesh-less step's")
        del p1
        torch.cuda.empty_cache() if dev == "cuda" else None
    del params, want_p
    log(f"phase 20: training holds took {time.perf_counter() - t0:.1f} s")

    # -- sharded batched decode on the world of one: the plain variant
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    items = []
    for _ in range(4):
        tokens = torch.randint(0, model.cfg.vocab_size, (1, 12), generator=gen, device=dev)
        cache = model.init_cache(1, 32, device=dev)
        hh, cache = model.prefill(params, tokens, cache)
        items.append((None, cache, model.logits(params, hh)[:, -1].argmax(-1, keepdim=True), 12))
    graph = types.SimpleNamespace(num_exits=model.num_segments)
    outs = {}
    for sharded in (False, True):
        stepper = CoInferenceStepper(model, graph, None)
        outs[sharded] = stepper.decode_step_batch(params, items, sharded=sharded)
    bits = all(torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(
        _leaves(a[1]), _leaves(b[1]))) for a, b in zip(outs[False], outs[True]))
    require(bits, "phase 20: decode_step_batch(sharded=True) differs from sharded=False")
    log(f"phase 20: decode_step_batch(sharded=True) over 4 rows on the world of one: bit for "
        f"bit sharded=False; {time.perf_counter() - t0:.1f} s")
    del params, items, outs

    # -- PrefetchLoader on the mesh
    host = [{"tokens": np.arange(4 * 9, dtype=np.int32).reshape(4, 9) + i} for i in range(2)]
    loader = PrefetchLoader(iter(host), mesh=mesh, spec=T.P(("data",), None))
    for want_b in host:
        b = next(loader)["tokens"]
        require(is_dtensor(b) and torch.equal(b.to_local().cpu(),
                                              torch.from_numpy(want_b["tokens"])),
                "phase 20: PrefetchLoader's local shard differs from the host batch")
    loader.close()
    log(f"phase 20: PrefetchLoader(mesh, P(('data',), None)) placed {len(host)} batches as "
        f"DTensors {tuple(b.placements)} on {b.to_local().device}, local shards equal to the "
        f"host batches")

    # -- the dry run on a fake 256-rank group, then its roofline
    out_dir = ROOT / "build" / "phase20"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    arch, shp, msh = SUB_DRYRUN
    t0 = time.perf_counter()
    env = dict(__import__("os").environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                          "--shape", shp, "--mesh", msh, "--out", str(out_dir / "dryrun.json")],
                         capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=600)
    wall_dry = time.perf_counter() - t0
    require(res.returncode == 0, f"phase 20: dry run failed: {res.stderr[-2000:]}")
    rec = json.loads((out_dir / "dryrun.json").read_text())[f"{arch}|{shp}|{msh}"]
    require(rec.get("status") == "ok" and rec["flops"] > 0
            and rec["collectives"]["total_link_bytes"] > 0,
            f"phase 20: dry-run record {str(rec)[:500]}")
    t0 = time.perf_counter()
    table = roofline.report(out_dir / "dryrun.json", msh)
    wall_roof = time.perf_counter() - t0
    log(f"phase 20: dry run {arch} {shp} on a fake {rec['mesh']} group ({rec['chips']} ranks), "
        f"wall {wall_dry:.1f} s (step {rec['step_s']:.2f} s); ANALYTIC, from shapes and H100 "
        f"constants, not measured: {json.dumps({k: rec[k] for k in ('flops', 'bytes_walked', 'bytes_literal', 'analytic_state_bytes_per_chip')})}, "
        f"collectives {json.dumps(rec['collectives'])}, memory {json.dumps(rec['memory'])}")
    log(f"phase 20: roofline.report ({wall_roof * 1e3:.1f} ms), ANALYTIC (H100 constants, "
        f"not measured):\n{table}")
    shutil.rmtree(out_dir, ignore_errors=True)
    dist.destroy_process_group()
    log(f"phase 20: took {time.perf_counter() - t_phase:.1f} s; launches {totals}")
    return totals


# ---------------------------------------------------------------- phase 21
# Every family trained on the card, the reference's ``launch/train.py
# --arch`` for rwkv6-3b (ssm), zamba2-2.7b (hybrid: Mamba-2 and a shared
# attention at hd 80), seamless-m4t-large-v2 (enc-dec), llava-next-mistral-7b
# (VLM: a 2880-embedding prefix) and llama4-scout-17b-a16e (MoE, 16 experts),
# at full width; random weights from torch.Generator seed 0.  Training
# reaches none of the port's kernels (the reference's reaches no
# pl.pallas_call): the chunked scan and the flash blocks run in torch ops.
TRAIN_FAMILIES = (RWKV, ZAMBA, SEAMLESS, LLAVA, SCOUT)
# depth by precision (a family not named runs whole).  The --full recipe
# holds 12 B a parameter (bf16 parameters and grads, f32 moments; the step
# donates its state): llava's 32 layers are 85.4 GB, 16 are 43.5; scout's 48
# layers hold ~201 GB of bf16 weights alone, 2 layers 62.5 GB.  The f32 holds
# keep the parameters and two sets of grads, 12 B a parameter: llava at 8
# layers (22.6 GB), scout at 1 (37.5 GB)
TRAIN_LAYERS = {LLAVA: {"bf16": 16, "f32": 8}, SCOUT: {"bf16": 2, "f32": 1}}
# the f32 holds (B1, TF32 off): (label, path A, path B), each path the
# keywords of Model.loss, "scan": "sequential" forcing the sequential scan in
# every RWKV-6 and Mamba-2 block; by family, each hold at S model positions
# and a depth (None: the family's f32 depth).  Flash needs S·T > 1024² (and
# blocks of 1024 that divide S).  The ssm and hybrid stacks' chunked scan
# runs a python loop over chunks of 16 (host-bound: a zamba2 step at S 1024
# took ~11 s on NVIDIA H100 80GB HBM3, 700.00 W), so their holds are at S
# 256, where the sequential scan is affordable, and at 8 layers (rwkv6-3b)
# and 12 (zamba2-2.7b: two units of six Mamba-2 blocks, each followed by
# the shared attention), each scan also held on its own inputs
HOLD_REMAT = ("remat against none", {"remat": True}, {"remat": False})
HOLD_FLASH = ("flash (auto) against dense", {"remat": True},
              {"remat": True, "attn_impl": "dense"})
HOLD_SCAN = ("chunked scan against sequential", {"remat": False},
             {"remat": False, "scan": "sequential"})
TRAIN_HOLDS = {RWKV: ((HOLD_REMAT, 256, 8), (HOLD_SCAN, 256, 8)),
               ZAMBA: ((HOLD_REMAT, 256, 12), (HOLD_SCAN, 256, 12),
                       (HOLD_FLASH, 2048, 12)),
               SEAMLESS: ((HOLD_REMAT, 2048, None), (HOLD_FLASH, 2048, None)),
               LLAVA: ((HOLD_REMAT, 3072, None), (HOLD_FLASH, 3072, None)),
               SCOUT: ((HOLD_REMAT, 2048, None), (HOLD_FLASH, 2048, None))}
# card against CPU: the same f32 parameters and batch on both, at S 128 and
# these depths (zamba2's smallest cut of whole units is 12 layers: two units
# of six Mamba-2 blocks, each followed by the shared attention); the
# enc-dec's encoder is cut with its decoder
TRAIN_CPU_LAYERS = {RWKV: 2, ZAMBA: 12, SEAMLESS: 2}
TRAIN_CPU_SEQ = 128
# the --full recipe's step (train.trainer_step: make_train_step(remat=True,
# ce_chunk=512), bf16 parameters, f32 moments, AdamW, donated state) at
# batch 1 and the trainer's seq (tokens a row: the model sees seq - 1
# positions, the VLM's 2880-row prefix and seq - 2880 text tokens, seq in
# all).  The ssm and hybrid steps wait on the chunked scan's python loop
# (~5-6 s a step at seq 513 on NVIDIA H100 80GB HBM3, 700.00 W), so they
# run at 257 to keep the script's time.  The trainer gives the enc-dec seq
# frames and its decoder seq - 1 tokens, so past 1024 no flash block
# divides both (in either package): seamless trains at 1024, its attention
# dense
TRAIN_SEQ = {RWKV: 257, ZAMBA: 257, SEAMLESS: 1024, LLAVA: 3072, SCOUT: 2049}
TRAIN_BATCH = 1
# a leaf of the bf16 recipe that no step can move: every element's half
# bf16 spacing is above TRAIN_MOVE_BOUND times the sum of the steps'
# learning rates (an Adam step moves an element by at most a few lr)
TRAIN_MOVE_BOUND = 4.0


def cut_config(arch, layers):
    """``arch``'s full config at ``layers`` layers (the enc-dec's encoder
    cut with its decoder), whole when ``layers`` is None."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers is None:
        return cfg
    cut = {"num_layers": layers}
    if cfg.is_encdec:
        cut["num_encoder_layers"] = layers
    return dataclasses.replace(cfg, **cut)


@contextlib.contextmanager
def sequential_scans():
    """Context: every RWKV-6 and Mamba-2 block's plain scan forced to the
    sequential one (``linear_scan(mode="sequential")``)."""
    from repro_torch.models import linear_scan as LS
    from repro_torch.models import mamba2, rwkv6

    def seq(*a, **kw):
        return LS.linear_scan(*a, **dict(kw, mode="sequential"))
    with patched(rwkv6, "linear_scan", seq), patched(mamba2, "linear_scan", seq):
        yield


@contextlib.contextmanager
def shadowed_train_scans(torch, worst):
    """Context: every RWKV-6 and Mamba-2 block's scan, as training runs it,
    also held on its own inputs, forward and backward, against the
    sequential scan: the output and the state by phase 7's rule (SCAN_ATOL
    + 2 n F32_UNIT sum|terms|, sum|terms| the scan of the inputs' absolute
    values), and each input's grads for one seeded cotangent within
    LM_GRAD_RTOL of their largest + LM_GRAD_ATOL.  The worst shares of the
    allowed error go to ``worst``."""
    from repro_torch.models import linear_scan as LS
    from repro_torch.models import mamba2, rwkv6
    names = ("q", "k", "v", "log_w", "state", "u")

    def scan(q, k, v, log_w, state, u=None, **kw):
        out = LS.linear_scan(q, k, v, log_w, state, u=u, **kw)
        ins = [t for t in (q, k, v, log_w, state, u) if t is not None]
        gen = torch.Generator(device=q.device).manual_seed(worst["calls"])
        with torch.enable_grad():
            paths = []
            for mode in (kw.get("mode", "auto"), "sequential"):
                xs = [t.detach().clone().requires_grad_() for t in ins]
                o, s = LS.linear_scan(*xs[:5], u=xs[5] if u is not None else None,
                                      **dict(kw, mode=mode))
                paths.append((xs, o, s))
            cot = [torch.randn(t.shape, generator=gen, device=t.device, dtype=t.dtype)
                   for t in paths[0][1:]]
            (xa, oa, sa), (xb, ob, sb) = paths
            ga = torch.autograd.grad((oa, sa), xa, cot)
            gb = torch.autograd.grad((ob, sb), xb, cot)
        with torch.no_grad():
            mo, ms = LS.scan_sequential(q.abs(), k.abs(), v.abs(), log_w, state.abs(),
                                        u=None if u is None else u.abs())
            S, dk = q.shape[1], q.shape[3]
            worst["o"] = max(worst["o"], ((oa - ob).abs() / (
                SCAN_ATOL + 2 * (S + dk + 2) * F32_UNIT * mo)).max().item())
            worst["state"] = max(worst["state"], ((sa - sb).abs() / (
                SCAN_ATOL + 2 * (S + 2) * F32_UNIT * ms)).max().item())
            for name, a, b in zip(names, ga, gb):
                share = ((a - b).abs().max() / (LM_GRAD_RTOL * b.abs().max()
                                                + LM_GRAD_ATOL)).item()
                if share > worst["grad"][0]:
                    worst["grad"] = (share, name)
        worst["calls"] += 1
        return out
    with patched(rwkv6, "linear_scan", scan), patched(mamba2, "linear_scan", scan):
        yield


@contextlib.contextmanager
def identity_blocks():
    """Context: every RWKV-6 block the identity (its input, state and last
    tokens passed through), leaving what lies outside the blocks: the
    embedding, the norms, the tied exit heads and the CE."""
    from repro_torch.models import rwkv6
    with patched(rwkv6, "block", lambda p, cfg, x, state, lasts, **kw: (x, state, lasts)):
        yield


def loss_grads(torch, model, params, batch, path):
    """(loss, grads by leaf) of ``Model.loss`` on ``path``'s keywords;
    ``"scan": "sequential"`` forces the sequential scan, ``"blocks":
    "identity"`` makes every RWKV-6 block the identity."""
    from repro_torch import tree as T
    kw = {k: v for k, v in path.items() if k not in ("scan", "blocks")}
    leaves = [p.requires_grad_() for p in T.leaves(params)]
    with contextlib.ExitStack() as ctx:
        if path.get("scan") == "sequential":
            ctx.enter_context(sequential_scans())
        if path.get("blocks") == "identity":
            ctx.enter_context(identity_blocks())
        loss, _ = model.loss(params, batch, **kw)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    for p in leaves:
        p.requires_grad_(False)
    return float(loss.detach()), grads


def grads_held(label, keys, got, want, hold=True):
    """Every leaf of ``got`` within LM_GRAD_RTOL of the leaf's largest
    |want| + LM_GRAD_ATOL of ``want``; returns the worst share of the
    tolerance and its leaf.  ``hold=False`` logs without requiring."""
    worst = (0.0, "")
    for k, g, w in zip(keys, got, want):
        if not w.numel():                  # an empty stack (a segment of no units)
            continue
        tol = LM_GRAD_RTOL * float(w.abs().max()) + LM_GRAD_ATOL
        err = float((g.float() - w.float()).abs().max())
        if hold:
            require(math.isfinite(err) and err <= tol,
                    f"{label}: {k} max |diff| {err:.3e} > {tol:.3e}")
        worst = max(worst, (err / tol if math.isfinite(err) else math.inf, k))
    return worst


def train_holds(torch, arch, cfg, holds, dev="cuda"):
    """Phase 21's float32 holds (B1): each (hold, S, layers) of ``holds``
    on ``cfg`` (cut to ``layers`` when given), path A's grads against path
    B's, per leaf.  The scan hold also holds every scan of path A on its
    own inputs against the sequential scan (``shadowed_train_scans``), and
    holds the grads end to end where END_TO_END says (rwkv6-3b's are
    logged: its blocks amplify the two scans' rounding differences into
    the grads of the later blocks' weights, see ``train_vs_cpu``).  Scout's router choices are recorded on the flash
    hold's two paths, every flip logged with its margin; with any, the
    paths part by design: the grads are then logged, not held, and every
    flip must be at a margin below MARGIN_TOL."""
    import dataclasses

    from repro_torch import tree as T
    from repro_torch.config import ShapeConfig
    from repro_torch.models.api import Model

    out, depth, params = [], None, None
    for (label, path_a, path_b), S, layers in holds:
        t0 = time.perf_counter()
        if params is None or layers != depth:
            depth, params = layers, None
            cut = cfg if layers is None else dataclasses.replace(
                cfg, num_layers=layers, **({"num_encoder_layers": layers}
                                           if cfg.is_encdec else {}))
            model = Model(cut)
            params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                                       dtype=torch.float32, device=dev)
            keys = [k for k, _ in T.leaves_with_paths(params)]
        batch = model.make_inputs(ShapeConfig("hold", S, 1, "train"),
                                  generator=torch.Generator(device=dev).manual_seed(21),
                                  device=dev)
        routes = {"a": [], "b": []} if cfg.family == "moe" and label == HOLD_FLASH[0] else None
        scans = ({"calls": 0, "o": 0.0, "state": 0.0, "grad": (0.0, "")}
                 if label == HOLD_SCAN[0] else None)
        with contextlib.ExitStack() as ctx:
            if routes:
                ctx.enter_context(recorded_routes(torch, routes["a"]))
            if scans:
                ctx.enter_context(shadowed_train_scans(torch, scans))
            la, ga = loss_grads(torch, model, params, batch, path_a)
        with recorded_routes(torch, routes["b"]) if routes else contextlib.nullcontext():
            lb, gb = loss_grads(torch, model, params, batch, path_b)
        what = f"phase 21 {arch} ({model.cfg.num_layers} layers) f32 B1 S{S} {label}"
        if scans:
            require(scans["calls"] == model.cfg.num_layers and scans["o"] <= 1
                    and scans["state"] <= 1 and scans["grad"][0] <= 1,
                    f"{what}: a scan off the sequential one on its own inputs: {scans}")
        flips = []
        if routes:
            require(len(routes["a"]) == len(routes["b"]),
                    f"{what}: {len(routes['a'])} MoE calls on one path, "
                    f"{len(routes['b'])} on the other")
            for call, ((ea, _), (eb, mb)) in enumerate(zip(routes["a"], routes["b"])):
                flips += [(call, b, s, mb[b, s].item())
                          for b, s in (ea != eb).nonzero().tolist()]
            for call, b, s, m in flips:
                log(f"{what}: router flip at MoE call {call} row {b} token {s}, top-2 "
                    f"router margin {m:.3g}")
            require(all(m < MARGIN_TOL for *_, m in flips),
                    f"{what}: a token routed apart at a margin above {MARGIN_TOL}")
        end_to_end = not flips and (not scans or END_TO_END.get(arch, True))
        worst = grads_held(what, keys, ga, gb, hold=end_to_end)
        dl = abs(la - lb)
        if end_to_end:
            require(dl <= LM_LOSS_TOL, f"{what}: losses {la!r} and {lb!r}")
        bitwise = all(torch.equal(a, b) for a, b in zip(ga, gb))
        log(f"{what}: losses {la:.6f} / {lb:.6f} (|diff| {dl:.3e}); every leaf "
            + ("within" if end_to_end else "LOGGED, not held, against")
            + f" {LM_GRAD_RTOL} max|g| + {LM_GRAD_ATOL}; worst leaf {worst[1]} at "
            f"{worst[0]:.3e} of its tolerance"
            + ("; every leaf equal bit for bit" if bitwise else "")
            + (f"; {len(flips)} router flips over {len(routes['a'])} MoE calls, smallest "
               f"top-2 router margin {min(m.min().item() for _, m in routes['b']):.3g}"
               if routes else "")
            + (f"; each of {scans['calls']} scans on its own inputs: output at "
               f"{scans['o']:.3e}, state at {scans['state']:.3e} of the allowed error, "
               f"grads at {scans['grad'][0]:.3e} of their tolerance ({scans['grad'][1]})"
               if scans else "")
            + f"; {time.perf_counter() - t0:.1f} s")
        out.append({"hold": label, "S": S, "worst": worst[0], "flips": len(flips),
                    **({"scans": scans} if scans else {})})
        del ga, gb
    del params
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def shadowed_blocks_on_cpu(torch, worst):
    """Context: every RWKV-6 block run on the card also run again, on the
    card and on the CPU, from copies of its inputs, forward and backward
    (one seeded cotangent): its outputs and the grads of its input, state
    and weights, CPU against card, within LM_GRAD_RTOL of their largest +
    LM_GRAD_ATOL.  The worst share goes to ``worst``."""
    from repro_torch.models import rwkv6
    inner = rwkv6.block

    def block(p, cfg, x, state, lasts, **kw):
        out = inner(p, cfg, x, state, lasts, **kw)
        names = ["x", "state", "last_tm", "last_cm", *p]
        ins = [x, state, *lasts, *p.values()]
        gen = torch.Generator().manual_seed(worst["calls"])
        runs, cot = [], None
        for dev in ("cuda", "cpu"):
            xs = [t.detach().to(dev, copy=True).requires_grad_() for t in ins]
            with torch.enable_grad():
                o = inner(dict(zip(p, xs[4:])), cfg, xs[0], xs[1], (xs[2], xs[3]), **kw)
                flat = [o[0], o[1], *o[2]]
                if cot is None:
                    cot = [torch.randn(t.shape, generator=gen, dtype=t.dtype) for t in flat]
                g = torch.autograd.grad(flat, xs, [c.to(dev) for c in cot], allow_unused=True)
            runs.append([t.detach().cpu() for t in flat]
                        + [torch.zeros(()) if t is None else t.cpu() for t in g])
        for name, a, b in zip(["out", "out state", "out last_tm", "out last_cm"]
                              + [f"grad {n}" for n in names], *runs):
            share = ((a - b).abs().max() / (LM_GRAD_RTOL * b.abs().max()
                                            + LM_GRAD_ATOL)).item()
            if share > worst["share"][0]:
                worst["share"] = (share, name)
        worst["calls"] += 1
        return out
    with patched(rwkv6, "block", block):
        yield


def train_vs_cpu(torch, arch, cfg):
    """The same f32 parameters and batch (S TRAIN_CPU_SEQ) through
    ``Model.loss`` and its backward on the card and on the CPU (remat,
    attention auto): the loss within LM_LOSS_TOL and every leaf's grads
    within LM_GRAD_RTOL max|g| + LM_GRAD_ATOL.  Where END_TO_END says no
    (rwkv6-3b), those are logged with their worst leaf, and held instead:
    each block on its own inputs (``shadowed_blocks_on_cpu``), and end to
    end what lies outside the blocks (``identity_blocks``).  Its blocks'
    per-head group norms divide each head's WKV output by its spread over
    the head's channels, which some heads with random weights barely have:
    a rounding difference in a block's input, from the device or from the
    scan's order alike, comes out amplified in the grads of the weights
    that feed the WKV (u, wk, wr) of the blocks after it
    (``tools/rwkv6_grad_drift.py`` reads it by depth)."""
    from repro_torch import tree as T
    from repro_torch.config import ShapeConfig
    from repro_torch.models.api import Model

    t0 = time.perf_counter()
    model = Model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               dtype=torch.float32, device="cuda")
    batch = model.make_inputs(ShapeConfig("cpu", TRAIN_CPU_SEQ, 1, "train"),
                              generator=torch.Generator(device="cuda").manual_seed(21),
                              device="cuda")
    p_cpu = T.tree_map(lambda t: t.detach().cpu(), params)
    b_cpu = {k: v.cpu() for k, v in batch.items()}
    keys = [k for k, _ in T.leaves_with_paths(params)]
    what = f"phase 21 {arch} ({cfg.num_layers} layers) f32 B1 S{TRAIN_CPU_SEQ} card against CPU"

    def on_both(path, label, hold):
        l_card, g_card = loss_grads(torch, model, params, batch, path)
        l_cpu, g_cpu = loss_grads(torch, model, p_cpu, b_cpu, path)
        if hold:
            require(abs(l_card - l_cpu) <= LM_LOSS_TOL,
                    f"{label}: losses {l_card!r} and {l_cpu!r}")
        worst = grads_held(label, keys, [g.cpu() for g in g_card], g_cpu, hold=hold)
        return (f"losses {l_card:.6f} / {l_cpu:.6f} (|diff| {abs(l_card - l_cpu):.3e}); "
                f"every leaf " + ("within" if hold else "LOGGED, not held, against")
                + f" {LM_GRAD_RTOL} max|g| + {LM_GRAD_ATOL}; worst leaf {worst[1]} at "
                f"{worst[0]:.3e} of its tolerance"), worst[0]

    end_to_end = END_TO_END.get(arch, True)
    held = ""
    if not end_to_end:
        blocks = {"calls": 0, "share": (0.0, "")}
        with torch.no_grad(), shadowed_blocks_on_cpu(torch, blocks):
            model.loss(params, batch, remat=False)
        require(blocks["calls"] == cfg.num_layers and blocks["share"][0] <= 1,
                f"{what}: a block on the CPU off the card's: {blocks}")
        outside, _ = on_both({"remat": True, "blocks": "identity"},
                             f"{what}, every block the identity", hold=True)
        held = (f"; each of {blocks['calls']} blocks on its own inputs, CPU against card, "
                f"forward and backward: worst at {blocks['share'][0]:.3e} of the tolerance "
                f"({blocks['share'][1]}); outside the blocks (every block the identity), end "
                f"to end: {outside}")
    text, worst = on_both({"remat": True}, what, hold=end_to_end)
    log(f"{what}: {text}{held}; {time.perf_counter() - t0:.1f} s")
    del params, p_cpu
    torch.cuda.empty_cache()
    return worst


def train_recipe(torch, arch, cfg, seq):
    """The --full recipe's step on the card, the one ``train(smoke=False)``
    runs (``train.trainer_step``: mesh-less on the world of one, the state
    donated), on TRAIN_BATCH rows of ``seq`` tokens built as the trainer
    builds them (``train.train_batch``), a
    warm-up step and LM_TIMED_STEPS timed, the step's FLOPs counted by
    ``torch.utils.flop_counter``; every loss finite (else the step and the first
    leaf that is not are named), every leaf's first moment non-zero (its
    gradient reached it) and every leaf changed that bf16 can move at these
    learning rates.  The batches are built before the first step, so the
    walls hold the steps alone.  Returns the step's numbers."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import tree as T
    from repro_torch.data.synthetic import token_batches
    from repro_torch.launch import train as train_mod
    from repro_torch.models.api import Model
    from repro_torch.optim import adamw_init
    from repro_torch.optim.schedule import warmup_cosine

    t0 = time.perf_counter()
    model = Model(cfg)
    step = train_mod.trainer_step(model, seq, TRAIN_BATCH, device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               dtype=torch.bfloat16, device="cuda")
    keys = [k for k, _ in T.leaves_with_paths(params)]
    init = [p.to("cpu", copy=True) for p in T.leaves(params)]
    opt = adamw_init(params)
    data = token_batches(0, TRAIN_BATCH, seq, cfg.vocab_size)
    t_init = time.perf_counter() - t0
    batches = [train_mod.train_batch(cfg, torch.from_numpy(next(data)).to("cuda"), i, seq,
                                     "cuda") for i in range(LM_TIMED_STEPS + 1)]
    # FLOPs: the counter's python dispatch slows a step of the ssm and hybrid
    # stacks' chunk loops ~5x (zamba2 at S 1024: 51 s against 11 on NVIDIA
    # H100 80GB HBM3, 700.00 W), so there it counts one forward of the loss,
    # and the step runs it, its recompute and a backward of twice its products
    forward_only = cfg.family in ("ssm", "hybrid")
    if forward_only:
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            model.loss(params, batches[0], remat=True, ce_chunk=512)
        flops = 4 * fc.get_total_flops()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    for i, batch in enumerate(batches):
        counted = i == 0 and not forward_only
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with FlopCounterMode(display=False) if counted else contextlib.nullcontext() as fc:
            params, opt, metrics = step(params, opt, batch)
            loss = float(metrics["loss"])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        if counted:
            flops = fc.get_total_flops()
        losses.append(loss)
        if not math.isfinite(loss):
            bad = next((k for k, p in zip(keys, T.leaves(params))
                        if not bool(torch.isfinite(p).all())), None)
            require(False, f"phase 21 {arch}: step {i} loss {loss}; first non-finite leaf {bad}")
    peak = torch.cuda.max_memory_allocated()
    positions = (seq if cfg.frontend == "vision" else seq - 1) * TRAIN_BATCH
    lr_sum = sum(float(warmup_cosine(i, peak_lr=3e-4, warmup=200, total=10000))
                 for i in range(LM_TIMED_STEPS + 1))
    frozen, unmoved, silent = [], [], []
    for k, p, p0, m in zip(keys, T.leaves(params), init, T.leaves(opt.mu)):
        if not p.numel():                  # an empty stack (a segment of no units)
            continue
        if not bool((p != p0.to(p.device)).any()):
            # half the bf16 spacing at each element (0 where the value is 0)
            x = p0.float().abs()
            half_ulp = torch.where(x > 0, torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 9),
                                   0.0)
            (frozen if bool((half_ulp > TRAIN_MOVE_BOUND * lr_sum).all())
             else unmoved).append(k)
        if not bool((m != 0).any()):
            silent.append(k)
    require(not unmoved, f"phase 21 {arch}: leaves left unchanged that bf16 could move: "
            f"{unmoved}")
    require(not silent, f"phase 21 {arch}: leaves no gradient reached: {silent}")
    wall = statistics.median(walls[1:])
    log(f"phase 21 {arch} ({cfg.num_layers} layers) --full recipe, bf16 params, f32 "
        f"moments, B{TRAIN_BATCH} seq {seq} ({positions} positions): losses "
        f"{[round(v, 4) for v in losses]}; median step wall {wall * 1e3:.1f} ms of "
        f"{[round(w * 1e3, 1) for w in walls[1:]]} (warm-up "
        f"{'' if forward_only else 'under the FLOP counter '}{walls[0] * 1e3:.1f} ms), "
        f"{positions / wall:.0f} tokens/s, peak memory {peak / 1e9:.2f} GB, FLOPs a step "
        f"{flops:.4g} (torch.utils.flop_counter{', 4x a forward' if forward_only else ''}) = "
        f"{flops / wall / 1e12:.1f} TFLOP/s; leaves bf16 cannot move at lr sum "
        f"{lr_sum:.3g} (unchanged, as expected): {frozen}; {time.perf_counter() - t0:.1f} s "
        f"in all (init {t_init:.1f} s)")
    del params, opt, step, init
    torch.cuda.empty_cache()
    return {"wall_s": wall, "tokens_per_s": positions / wall, "peak_gb": peak / 1e9,
            "tflops": flops / wall / 1e12, "seq": seq, "layers": cfg.num_layers}


def train_phase(torch):
    """Phase 21: each family's f32 holds, its card-against-CPU hold where
    TRAIN_CPU_LAYERS names it, then its --full recipe's steps; no kernel is
    launched.  Returns the recipe's numbers by family."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = {}
    for arch in TRAIN_FAMILIES:
        t0 = time.perf_counter()
        layers = TRAIN_LAYERS.get(arch, {})
        train_holds(torch, arch, cut_config(arch, layers.get("f32")), TRAIN_HOLDS[arch])
        if arch in TRAIN_CPU_LAYERS:
            train_vs_cpu(torch, arch, cut_config(arch, TRAIN_CPU_LAYERS[arch]))
        out[arch] = train_recipe(torch, arch, cut_config(arch, layers.get("bf16")),
                                 TRAIN_SEQ[arch])
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase 21 {arch}: {time.perf_counter() - t0:.1f} s")
    launched = {k: n for k, n in launch_counts().items() if n}
    require(not launched, f"phase 21: training launched kernels {launched}")
    return out


# ---------------------------------------------------------------- phase 22
# The port's five example scripts (examples/torch_*.py, the reference's
# examples/*.py statement for statement) as a user runs them on the card:
# each a subprocess at its defaults, and the two LM scripts again in process
# with the wrappers' launch counts read around them.
EXAMPLES = ROOT / "examples"
EXAMPLE_RUNS = (("torch_quickstart", ()), ("torch_serve_dynamic_bandwidth", ()),
                ("torch_llm_early_exit_serving", ()),
                ("torch_llm_early_exit_serving", ("--dynamic",)),
                ("torch_serve_fleet", ()), ("torch_train_branchy_alexnet", ()))
# the runs in process, and the kernels each one's main path launches
EXAMPLE_WRAPPED = (("torch_llm_early_exit_serving", ()), ("torch_serve_fleet", ()))
EXAMPLE_KERNELS = {"torch_llm_early_exit_serving": ATTN_PATH,
                   "torch_serve_fleet": ("flash_attention", "decode_attention")}


def example_module(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_lines(name, args, text):
    """Require the lines ``name`` promises in its output ``text``."""
    import re
    what = f"phase 22: {name} {' '.join(args)}".rstrip()
    lines = text.splitlines()
    if name == "torch_quickstart":
        plans = [ln for ln in lines if re.match(r"\s+\d+ kbps: exit=\d", ln)]
        require(len(plans) == 5 and any(ln.startswith("co-inference: exit=") for ln in lines),
                f"{what}: plans {plans}")
        return f"{len(plans)} plans"
    if name == "torch_serve_dynamic_bandwidth":
        slo = [ln for ln in lines if re.match(r"SLO attainment: \d+/120 ", ln)]
        require(len(slo) == 1 and "configuration map: 428 bandwidth states" in lines,
                f"{what}: {lines[-3:]}")
        return slo[0]
    if name == "torch_llm_early_exit_serving":
        summary = [ln for ln in lines if ln.startswith("serving summary: {'requests': 12,")]
        head = [re.search(r"conf=([\d.]+) entropy=([\d.]+) \(vs vocab max ([\d.]+)\)", ln)
                for ln in lines if ln.startswith("fused exit-head on last prefill token:")]
        require(len(summary) == 1 and len(head) == 1 and head[0],
                f"{what}: {lines[-4:]}")
        conf, ent, cap = (float(v) for v in head[0].groups())
        require(0 < conf <= 1 and ent <= cap, f"{what}: conf {conf}, entropy {ent} of {cap}")
        return f"conf {conf}, entropy {ent} <= {cap}"
    if name == "torch_serve_fleet":
        rows = [ln for ln in lines
                if re.match(r"\s*\d+\s+\S+\s+\d+\s+-?\d+\s+\d+\s+[\d.]+\s+(True|False)\s*\[", ln)]
        require(any(ln.startswith("fleet: 8 devices x 2 edges") for ln in lines)
                and any(ln.startswith("SLO attainment:") for ln in lines) and len(rows) == 10,
                f"{what}: {len(rows)} token rows")
        return f"{len(rows)} token rows"
    losses = [float(m.group(1)) for m in
              (re.match(r"step +\d+ +joint loss ([\d.]+)", ln) for ln in lines) if m]
    acc = [float(m.group(1)) for m in
           (re.match(r"  exit \d: ([\d.]+) ", ln) for ln in lines) if m]
    require(len(losses) == 6 and losses[-1] < losses[0] and len(acc) == 5
            and all(0 <= a <= 1 for a in acc), f"{what}: losses {losses}, accuracy {acc}")
    return f"joint loss {losses}, accuracy {acc}"


def examples_phase(torch):
    """Phase 22: every example script exits 0 on the card with its lines;
    the LM scripts' wrapped runs launch each kernel of their path.
    Returns the wrapped runs' launches."""
    import io
    import os
    import shutil

    from repro_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    out = ROOT / "build" / "phase22"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    shutil.rmtree(example_module("torch_train_branchy_alexnet").DEFAULT_CKPT_DIR,
                  ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = []
    try:
        for i, (name, args) in enumerate(EXAMPLE_RUNS):
            log_f = open(out / f"{i}.log", "w")
            procs.append((name, args, log_f, subprocess.Popen(
                [sys.executable, str(EXAMPLES / f"{name}.py"), *args], stdout=log_f,
                stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))))
        launches = {}
        for name, args in EXAMPLE_WRAPPED:
            mod = example_module(name)
            torch.cuda.synchronize()
            reset_launch_counts()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                res = mod.main(list(args))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            counts = launch_counts()
            for k in EXAMPLE_KERNELS[name]:
                require(counts[k] > 0, f"phase 22: {name} launched no {k}")
            if "exit_head" in res:
                eh = res["exit_head"]
                require(0 < eh["conf"] <= 1 and eh["entropy"] <= res["log_vocab"],
                        f"phase 22: {name} exit head {eh}")
            log(f"phase 22: {name} in process: launches {counts}; wall {wall:.2f} s; "
                f"summary {res['summary']}")
            for k, n in counts.items():
                launches[k] = launches.get(k, 0) + n
        for i, (name, args, log_f, p) in enumerate(procs):
            rc = p.wait(timeout=600)
            log_f.close()
            text = (out / f"{i}.log").read_text()
            require(rc == 0, f"phase 22: {name} {' '.join(args)} exited {rc}: {text[-2000:]}")
            log(f"phase 22: {name} {' '.join(args)} exit 0 at {time.perf_counter() - t0:.1f} s "
                f"into the phase: {example_lines(name, args, text)}")
    finally:
        for *_, log_f, p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log_f.close()
    shutil.rmtree(out, ignore_errors=True)
    shutil.rmtree(example_module("torch_train_branchy_alexnet").DEFAULT_CKPT_DIR,
                  ignore_errors=True)
    log(f"phase 22: took {time.perf_counter() - t0:.1f} s; launches of the wrapped runs "
        f"{launches}")
    return launches


# ---------------------------------------------------------------- phase 23
# the shared pad prefix: a batch of unequal prompts, the longest unpadded and
# the shortest padded most
PAD_PREFIX_LENGTHS = (1000, 700, 333, 64)


def pad_prefix_inputs(torch, cfg, dev):
    """The batch of PAD_PREFIX_LENGTHS as ``ServingEngine`` left-pads it (token
    0), on the card, and its requests."""
    from repro_torch.serving import Request
    reqs = make_requests(Request, cfg.vocab_size,
                         [(n, SHORT_SLO) for n in PAD_PREFIX_LENGTHS])
    S = max(PAD_PREFIX_LENGTHS)
    toks = np.zeros((len(reqs), S), np.int32)
    for i, r in enumerate(reqs):
        toks[i, S - len(r.prompt):] = r.prompt
    return torch.from_numpy(toks).to(dev), reqs


def pad_prefix_prefills(torch, model, params, toks, dtype):
    """(h, cache) of the padded prefill and of the shared-prefix prefill."""
    dev = toks.device
    out = []
    for kw in ({}, {"lengths": list(PAD_PREFIX_LENGTHS)}):
        cache = model.init_cache(toks.shape[0], toks.shape[1] + NEW_TOKENS + 1, dtype=dtype,
                                 device=dev)
        out.append(model.prefill(params, toks, cache, **kw))
    return out


def cache_err(torch, a, b, S):
    """max |a - b| over every row's cache positions [0, S) in every segment."""
    return max((x[:, :, :S].float() - y[:, :, :S].float()).abs().max().item()
               for sa, sb in zip(a, b) for x, y in zip(sa.values(), sb.values()))


def pad_prefix_serve(torch, model, params, reqs, dtype, shared, held=None):
    """``ServingEngine.serve`` of ``reqs`` as one batch; ``shared`` False
    refuses the shared pad prefix on the model instance.  Returns (the picks
    by row: the prefill's, then each decode step's; flash launches; the
    engine's counters; the top-2 logit margins of the picks by row)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.obs import spans
    from repro_torch.serving import ServingEngine
    graph, planner, link = serving_setup(model.cfg)
    engine = ServingEngine(model, params, graph, planner, link, batch_size=BATCH,
                           dtype=dtype)
    picks, margins = [], []
    inner = engine.stepper.next_token

    def next_token(p, h):
        top2 = model.logits(p, h)[:, -1].float().topk(2, dim=-1).values
        margins.append((top2[:, 0] - top2[:, 1]).tolist())
        tok = inner(p, h)
        picks.append(tok[:, 0].tolist())
        return tok

    engine.stepper.next_token = next_token
    if not shared:
        model.shares_pad_prefix = lambda *a, **k: False
    spans.reset()
    reset_launch_counts()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), \
                (held if held is not None else contextlib.nullcontext()):
            stats = engine.serve(reqs)
    finally:
        if not shared:
            del model.shares_pad_prefix
    flash = launch_counts()["flash_attention"]
    counts = {k: spans.REGISTRY.counter(k).value for k in
              ("engine.pad_prefix.batches", "engine.pad_prefix.positions",
               "engine.pad_prefix.positions_skipped")}
    spans.reset()
    require(all(stats.tokens[r.rid] == [p[i] for p in picks[1:]] for i, r in enumerate(reqs)),
            "phase 23: the served tokens are not the exit head's picks")
    return [list(x) for x in zip(*picks)], flash, counts, [list(x) for x in zip(*margins)]


def held_flash(torch, worst):
    """Context: every flash launch held against its plain version on its
    inputs in float32 (``attn_share``); ``worst["flash"]`` gathers (launches,
    the largest share of the allowed error, the largest error)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    flash = fa_ops.flash_attention

    def held(q, k, v, *, causal=True):
        o = flash(q, k, v, causal=causal)
        plain = fa_ref.attention(q.transpose(1, 2).float(), k.transpose(1, 2).float(),
                                 v.transpose(1, 2).float(), causal=causal).transpose(1, 2)
        e, share = attn_share(o, plain, q.dtype)
        n, s, m = worst.get("flash", (0, 0.0, 0.0))
        worst["flash"] = (n + 1, max(s, share), max(m, e))
        return o
    return patched(fa_ops, "flash_attention", held)


def pad_prefix_phase(torch, dev="cuda"):
    """Phase 23 (module doc).  ``dev`` "cpu" rehearses it (no launches)."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config(LLAMA)
    model = Model(cfg)
    B, S, n_layers = len(PAD_PREFIX_LENGTHS), max(PAD_PREFIX_LENGTHS), cfg.num_layers
    toks, reqs = pad_prefix_inputs(torch, cfg, dev)
    t0 = time.perf_counter()
    # float32, TF32 off: end to end within the two-path tolerances
    gen = torch.Generator(device=dev).manual_seed(0)
    params32 = model.init_params(gen, dtype=torch.float32, device=dev)
    (h_pad, c_pad), (h_sh, c_sh) = pad_prefix_prefills(torch, model, params32, toks,
                                                       torch.float32)
    eh, ec = (h_sh - h_pad).abs().max().item(), cache_err(torch, c_sh, c_pad, S)
    log(f"phase 23 {LLAMA} f32 lengths {PAD_PREFIX_LENGTHS}: shared pad prefix against "
        f"padded prefill, last hidden max_abs_err {eh:.3g}, cache [0, {S}) max_abs_err "
        f"{ec:.3g} (tol {HIDDEN_TOL})")
    require(eh <= HIDDEN_TOL and ec <= HIDDEN_TOL,
            f"phase 23: the shared pad prefix's prefill differs from the padded one by "
            f"{eh} (hidden), {ec} (cache)")
    t_pad, _, _, m_pad = pad_prefix_serve(torch, model, params32, reqs, torch.float32, False)
    t_sh, _, counts, _ = pad_prefix_serve(torch, model, params32, reqs, torch.float32, True)
    # each row's first pick that differs, with the padded path's margin there
    flips = {}
    for row, (a, b) in enumerate(zip(t_sh, t_pad)):
        k = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if k is not None:
            flips[row] = (k, m_pad[row][k])
    log(f"phase 23 {LLAMA} f32 serve: first flip by row (pick, padded top-2 margin) "
        f"{flips}; counters {counts}")
    require(all(m < MARGIN_TOL for _, m in flips.values()),
            "phase 23: a token differs where the padded path's margin is above tolerance")
    h32 = h_pad.float()
    del params32, c_pad, c_sh, h_pad, h_sh
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    # bfloat16: each launch on its inputs, and no further from float32 than
    # twice the padded path
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               dtype=torch.bfloat16, device=dev)
    (h_pad, c_pad), (h_sh, c_sh) = pad_prefix_prefills(torch, model, params, toks,
                                                       torch.bfloat16)
    e_pad = (h_pad.float() - h32).abs().max().item()
    e_sh = (h_sh.float() - h32).abs().max().item()
    log(f"phase 23 {LLAMA} bf16: last hidden max_abs_err against the f32 padded prefill: "
        f"padded {e_pad:.3g}, shared pad prefix {e_sh:.3g}; shared against padded "
        f"{(h_sh.float() - h_pad.float()).abs().max().item():.3g}, cache [0, {S}) "
        f"{cache_err(torch, c_sh, c_pad, S):.3g}")
    require(e_sh <= 2 * e_pad, f"phase 23: the bf16 shared pad prefix is {e_sh} from the "
            f"f32 prefill, the padded bf16 prefill {e_pad}")
    del c_pad, c_sh
    worst = {}
    t_pad, f_pad, _, _ = pad_prefix_serve(torch, model, params, reqs, torch.bfloat16, False)
    t_sh, f_sh, counts, _ = pad_prefix_serve(torch, model, params, reqs, torch.bfloat16,
                                             True, held_flash(torch, worst))
    n_flash, share, err = worst.get("flash", (0, 0.0, 0.0))
    diff = sum(x != y for a, b in zip(t_sh, t_pad) for x, y in zip(a, b))
    n_picks = sum(len(a) for a in t_sh)
    log(f"phase 23 {LLAMA} bf16 serve: flash launches shared {f_sh}, padded {f_pad} "
        f"({n_layers} layers, B {B}); {n_flash} flash launches held, worst err/allowed "
        f"{share:.3g}, max_abs_err {err:.3g}; "
        f"{diff} of {n_picks} picks differ from the padded path's; counters "
        f"{counts}; {time.perf_counter() - t0:.1f} s")
    require(dev != "cuda" or (f_pad == n_layers and f_sh == (B + 1) * n_layers),
            f"phase 23: {f_sh} flash launches on the shared path, {f_pad} padded; "
            f"want {(B + 1) * n_layers} and {n_layers}")
    require(n_flash == (B + 1) * n_layers and share <= 1.0,
            f"phase 23: a shared-path flash launch disagrees with its plain version: "
            f"{share} of the allowed error")
    P = S - min(PAD_PREFIX_LENGTHS)
    require(counts == {"engine.pad_prefix.batches": 1, "engine.pad_prefix.positions": P,
                       "engine.pad_prefix.positions_skipped":
                           B * S - P - sum(PAD_PREFIX_LENGTHS)},
            f"phase 23: the engine counted {counts}")
    del params
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return {"flash_attention": f_sh + f_pad}


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
    t_start = time.perf_counter()
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
    at_sim = smoke_kernel_cases(torch, timer)
    del timer
    torch.cuda.empty_cache()
    at_families = family_kernel_times(torch)
    at_configs = config_kernel_times(torch)

    # -- 4-9 the main paths, each with its kernel path against its plain path
    launches, at_arena, served = {}, {}, {}
    for arch in (LLAMA, RWKV, ZAMBA):
        params, counts = serve_main_path(torch, arch)
        served[arch] = counts
        kernel_vs_plain(torch, params, arch)
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        del params
        torch.cuda.empty_cache()

    # -- 10-11 the fleet with real decode through the arena, at full width;
    #    the profiles of an arena call last, after every timed run
    for arch in (LLAMA, ZAMBA):
        for name, t in arena_kernel_times(torch, arch).items():
            at_arena.setdefault(name, {})[arch] = t
        for name, n in fleet_phase(torch, arch).items():
            launches[name] = launches.get(name, 0) + n

    # -- 12-13 the Edgent path on BranchyAlexNet and its calibration; their
    #    layer times are host walls, so they run before any profiler session.
    #    The host time of one small launch is logged before and after them:
    #    their CPU-side holds must not leave the host slower for the walls
    #    of phase 11's profile that follow
    timer = Timer(torch)
    probe = torch.zeros(1, device="cuda")
    launch_us = timer.host_us(lambda: probe.add_(1.0))
    t_edgent = time.perf_counter()
    graph, static_plans = edgent_phase(torch)
    t_calib = time.perf_counter()
    lm_counts = calib_phase(torch, graph, static_plans)
    for name, n in lm_counts.items():
        launches[name] = launches.get(name, 0) + n
    log(f"chip_smoke: phase 12 took {t_calib - t_edgent:.1f} s, phase 13 "
        f"{time.perf_counter() - t_calib:.1f} s; host time of one launch "
        f"{launch_us:.2f} us before them, {timer.host_us(lambda: probe.add_(1.0)):.2f} us after")
    del timer, probe
    torch.cuda.empty_cache()

    # -- 14-15 training on the card, its walls too before any profiler
    #    session; the host time of one small launch is logged before and
    #    after them, as around phases 12-13
    timer = Timer(torch)
    probe = torch.zeros(1, device="cuda")
    launch_us = timer.host_us(lambda: probe.add_(1.0))
    t14 = time.perf_counter()
    branchy_train_phase(torch)
    t15 = time.perf_counter()
    lm_walls = lm_train_phase(torch)
    t_end = time.perf_counter()
    log(f"chip_smoke: host time of one launch {launch_us:.2f} us before phases 14-15, "
        f"{timer.host_us(lambda: probe.add_(1.0)):.2f} us after")
    del timer, probe
    torch.cuda.empty_cache()

    # -- 16 the remaining families at full width, their walls too before any
    #    profiler session
    torch.cuda.reset_peak_memory_stats()
    t16 = time.perf_counter()
    by_family = family_phase(torch)
    log(f"chip_smoke: phase 16 took {time.perf_counter() - t16:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches by model {by_family}")
    for name, per_model in by_family.items():
        launches[name] = launches.get(name, 0) + sum(per_model.values())
        for label, t in at_families.get(name, {}).items():
            t["launches"] = per_model.get(label.split()[0], 0)

    # -- 17 the simulator on the card: real decode at the smoke size (hd 16),
    #    a spawn-pool sweep, the command line with the observers, a sharded
    #    run; before any profiler session
    sim_launches, by_arch = sim_phase(torch)
    for counts in (sim_launches, *by_arch.values()):
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
    for name, rows in at_sim.items():
        for label, t in rows.items():
            # the smoke stacks' attention, every shape of a stack together:
            # llama3.2-1b's G 2 (phase 13's measure_lm, phase 17's
            # real-decode runs and its sweep cells), zamba2-2.7b's G 1 (its
            # sweep cells); no served path runs hd 32, nor the exit head at
            # D 64 (the fleet takes the model-dtype argmax)
            t["launches"] = (lm_counts[name] + sim_launches[name] + by_arch[LLAMA][name]
                             if label.startswith("hd16 G2") else
                             by_arch[ZAMBA][name] if label.startswith("hd16 G1") else 0)

    # -- 18-19 every other served config: granite-3-2b, granite-3-8b and
    #    starcoder2-15b served at full width, maverick at 2 layers, then
    #    scout, llava's text backbone and starcoder2-15b through the fleet;
    #    before any profiler session
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t18 = time.perf_counter()
    by_config = dense_phase(torch)
    for name, per_config in by_config.items():
        launches[name] = launches.get(name, 0) + sum(per_config.values())
    t19 = time.perf_counter()
    for arch in (SCOUT, LLAVA, STARCODER):
        if arch == STARCODER:
            for name, t in arena_kernel_times(torch, arch).items():
                at_arena.setdefault(name, {})[arch] = t
        for name, n in fleet_phase(torch, arch).items():
            launches[name] = launches.get(name, 0) + n
            by_config.setdefault(name, {}).setdefault(arch, 0)
            by_config[name][arch] += n
    log(f"chip_smoke: phase 18 took {t19 - t18:.1f} s, phase 19 "
        f"{time.perf_counter() - t19:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches by config {by_config}")
    for name, per_config in by_config.items():
        for label, t in at_configs.get(name, {}).items():
            t["launches"] = per_config.get(label.split()[0], 0)

    # -- 20 the substrate: sharded steps on make_host_mesh() over the card,
    #    the dry run and its roofline; before any profiler session
    gc.collect()
    torch.cuda.empty_cache()
    t20 = time.perf_counter()
    for name, n in substrate_phase(torch).items():
        launches[name] = launches.get(name, 0) + n
    log(f"chip_smoke: phase 20 took {time.perf_counter() - t20:.1f} s")

    # -- 21 every family trained on the card; 22 the port's example scripts;
    #    before any profiler session
    gc.collect()
    torch.cuda.empty_cache()
    t21 = time.perf_counter()
    trained = train_phase(torch)
    t22 = time.perf_counter()
    for name, n in examples_phase(torch).items():
        launches[name] = launches.get(name, 0) + n
    log(f"chip_smoke: phase 21 took {t22 - t21:.1f} s, phase 22 "
        f"{time.perf_counter() - t22:.1f} s; the --full recipe's steps by family "
        f"{json.dumps(trained)}")

    # -- 23 the shared pad prefix; its engine counters take a profiler session
    t23 = time.perf_counter()
    for name, n in pad_prefix_phase(torch).items():
        launches[name] = launches.get(name, 0) + n
    log(f"chip_smoke: phase 23 took {time.perf_counter() - t23:.1f} s")

    arena_profile(torch, (LLAMA, ZAMBA))
    t_prof = time.perf_counter()
    lm_train_profile(torch, lm_walls)
    log(f"chip_smoke: phase 14 took {t15 - t14:.1f} s, phase 15 {t_end - t15:.1f} s "
        f"and its profile {time.perf_counter() - t_prof:.1f} s")
    log(f"launches over the served paths: {launches}")
    exit_tickets_zero(torch)
    record["exit_confidence"]["at_shapes"][ZAMBA]["launches"] = \
        served[ZAMBA]["exit_confidence"]

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
                        "shape": t["shape"], "dtype": t["dtype"],
                        **({"at_arena": at_arena[name]} if name in at_arena else {}),
                        **({"at_shapes": t["at_shapes"]} if "at_shapes" in t else {}),
                        **({"at_families": at_families[name]} if at_families.get(name)
                           else {}),
                        **({"at_configs": at_configs[name]} if at_configs.get(name)
                           else {}),
                        **({"at_sim": at_sim[name]} if at_sim.get(name) else {})})
    log(f"chip_smoke: phases 1-23 took {time.perf_counter() - t_start:.1f} s")
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
