"""Time the real layers and kernels: the measurement stage of the
calibration loop.

Two targets, one artifact:

* :func:`measure_lm` — the smoke-scale LM stack a
  :class:`~repro_torch.sim.spec.PlannerSpec` describes: per-exit decode
  steps through the *same* callables the fleet's real-decode paths run
  (``CoInferenceStepper.decode_fn`` / ``decode_fn_batched`` /
  ``decode_fn_arena``), swept over batch sizes and prompt lengths, plus
  prefill and exit-head samples.
* :func:`measure_alexnet` — the paper's branchy-AlexNet prototype at
  Table-I layer granularity (``core.profiler.profile_all_branches``).

Every sample is warmup + median-of-k of the host wall
(``time.perf_counter``) around a call that ends in a device sync, recorded
as a :class:`~repro_torch.calib.table.TimingSample` in a
:class:`~repro_torch.calib.table.CalibrationTable`; ``meta["platform"]``
names the device the tensors were on.  Both run on the card unless the
caller asks for the CPU.  Measurements are host wall clock — the one
intentionally non-deterministic corner of the repo; everything downstream
(fit, validate) is deterministic in the table.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.calib.table import CalibrationTable, TimingSample
from repro_torch.core.profiler import _sync
from repro_torch.device import resolve

__all__ = ["measure_alexnet", "measure_lm"]


def _median_time(fn, *args, reps: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        _sync(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _platform_meta(dev: torch.device) -> dict:
    meta = {"platform": dev.type}
    if dev.type == "cuda":
        meta["device_name"] = torch.cuda.get_device_name(dev)
    return meta


@torch.no_grad()
def measure_lm(spec=None, *, arch: Optional[str] = None,
               batches: Sequence[int] = (1, 2, 4),
               seqs: Sequence[int] = (8,), reps: int = 5,
               warmup: int = 2,
               decode_path: str = "batched",
               device="cuda") -> CalibrationTable:
    """Measure the LM decode/prefill/head kernels of ``spec`` (a
    ``PlannerSpec``; ``arch=`` shorthand builds one) on ``device``.

    Decode samples run through the fleet's own decode callables — the
    serial per-exit variant at B=1 and, above that, the path
    ``decode_path`` selects: ``"batched"`` (``decode_fn_batched`` over
    caches concatenated on the batch axis) or ``"arena"`` (the
    slot-resident masked ``decode_fn_arena`` calls, with rows admitted to a
    ``DecodeArena`` sized to the batch) — so the table prices exactly what
    a ``real_decode=True`` scenario with the matching ``EngineSpec`` knob
    executes.  One table measures one path (``meta["decode_path"]``): the
    fitter treats every decode sample as the same regression family.  The
    position axis rides on ``seqs``: each prompt length measures decode at
    a different KV offset."""
    from repro_torch.serving.arena import DecodeArena, tree_map
    from repro_torch.serving.engine import CoInferenceStepper
    from repro_torch.sim.build import build_stack
    from repro_torch.sim.spec import PlannerSpec

    if decode_path not in ("batched", "arena"):
        raise ValueError(f"unknown decode_path {decode_path!r}: expected "
                         "'batched' or 'arena'")
    dev = resolve(device)
    if spec is None:
        spec = PlannerSpec() if arch is None else PlannerSpec(arch=arch)
    sc = build_stack(spec, with_model=True, device=dev)
    model, params, graph = sc.model, sc.params, sc.graph
    stepper = CoInferenceStepper(model, graph, sc.planner)
    rng = np.random.default_rng(0)
    vocab = sc.cfg.vocab_size
    samples = []

    def tokens(b: int, s: int):
        return torch.from_numpy(
            rng.integers(0, vocab, (b, s)).astype(np.int32)).to(dev)

    def prefill_rows(batch: int, seq: int):
        """``batch`` independent B=1 (cache, token) rows after a real
        prefill of ``seq`` random tokens — the fleet's request state."""
        rows = []
        for _ in range(batch):
            cache = model.init_cache(1, seq + 4, dtype=torch.float32,
                                     device=dev)
            h, cache = model.prefill(params, tokens(1, seq), cache)
            logits = model.logits(params, h)
            tok = torch.argmax(logits[:, -1, :], -1).to(torch.int32)[:, None]
            rows.append((cache, tok))
        return rows

    for seq in seqs:
        # ---- prefill: one [B, S] forward per (batch, seq)
        for b in batches:
            toks = tokens(b, seq)
            cache = model.init_cache(b, seq + 4, dtype=torch.float32,
                                     device=dev)
            t = _median_time(model.prefill, params, toks, cache,
                             reps=reps, warmup=warmup)
            samples.append(TimingSample(
                phase="prefill", latency_s=t, batch=b, seq=seq, reps=reps))
        # ---- decode: per exit x batch, at KV position `seq`
        for e in stepper.exit_points:
            for b in batches:
                rows = prefill_rows(b, seq)
                if b == 1:
                    fn = stepper.decode_fn(e)
                    cache, tok = rows[0]
                    t = _median_time(fn, params, cache, tok, seq,
                                     reps=reps, warmup=warmup)
                elif decode_path == "arena":
                    # the slot-resident path: rows admitted once, then the
                    # masked full-arena call is the steady-state per-token
                    # cost; timing threads the returned cache forward, as
                    # the fleet does
                    arena = DecodeArena(model, slots=b, length=seq + 4,
                                        dtype=torch.float32, device=dev)
                    for i, (cache, _tok) in enumerate(rows):
                        arena.admit(i, cache)
                    fn = stepper.decode_fn_arena(e, arena)
                    tok_a = torch.zeros((arena.slots, 1), dtype=torch.int32,
                                        device=dev)
                    tok_a[:b] = torch.cat([r[1] for r in rows])
                    pos_a = torch.zeros((arena.slots,), dtype=torch.long,
                                        device=dev)
                    pos_a[:b] = seq
                    mask_a = torch.arange(arena.slots, device=dev) < b

                    def run_once():
                        h, arena.cache = fn(params, arena.cache, tok_a,
                                            pos_a, mask_a)
                        return h
                    t = _median_time(run_once, reps=reps, warmup=warmup)
                else:
                    fn = stepper.decode_fn_batched(e, b)
                    cb = tree_map(lambda *xs: torch.cat(xs, dim=1),
                                  *[r[0] for r in rows])
                    tb = torch.cat([r[1] for r in rows])
                    pos = torch.full((b,), seq, dtype=torch.long, device=dev)
                    t = _median_time(fn, params, cb, tb, pos,
                                     reps=reps, warmup=warmup)
                samples.append(TimingSample(
                    phase="decode", latency_s=t, exit_point=e, batch=b,
                    seq=seq, reps=reps))
    # ---- exit head: the logits projection every exit pays once per token
    d = sc.cfg.d_model
    for b in batches:
        h = torch.zeros((b, 1, d), dtype=torch.float32, device=dev)
        t = _median_time(model.logits, params, h, reps=reps, warmup=warmup)
        samples.append(TimingSample(
            phase="head", kind="fc", latency_s=t, batch=b, seq=1, reps=reps,
            features={"in_size": float(b * d * 2),
                      "out_size": float(b * vocab * 2)}))
    return CalibrationTable(
        arch=spec.arch, source="measure_lm", samples=samples,
        meta={"reps": reps, "warmup": warmup, "batches": list(batches),
              "seqs": list(seqs), "decode_path": decode_path,
              **_platform_meta(dev),
              "num_exits": stepper.n_graph,
              "edge_step_s": spec.edge_step_s,
              "device_step_s": spec.device_step_s})


def measure_alexnet(*, reps: int = 3, smoke: bool = True,
                    device="cuda") -> CalibrationTable:
    """Measure the branchy-AlexNet prototype layer by layer on ``device`` —
    the paper's own granularity (Table I kinds, one sample per unique layer
    across all five branches), with parameters from seed 0 of a
    ``torch.Generator`` on the device.  ``smoke`` is accepted for CLI
    symmetry; the config is already CIFAR-10 scale."""
    from repro_torch.configs import get_alexnet_config
    from repro_torch.core.graph import alexnet_graph
    from repro_torch.core.profiler import profile_all_branches
    from repro_torch.models.alexnet import BranchyAlexNet

    dev = resolve(device)
    cfg = get_alexnet_config()
    net = BranchyAlexNet(cfg)
    params = net.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    graph = alexnet_graph(net)
    x = torch.zeros((1, cfg.image_size, cfg.image_size, cfg.channels),
                    dtype=torch.float32, device=dev)
    profiles = profile_all_branches(graph, params, x, repeats=reps)
    samples = [TimingSample(phase="layer", kind=p.kind,
                            features=dict(p.features), latency_s=p.latency_s,
                            reps=reps)
               for p in profiles]
    return CalibrationTable(
        arch=cfg.name, source="measure_alexnet", samples=samples,
        meta={"reps": reps, "smoke": bool(smoke), **_platform_meta(dev),
              "num_exits": net.num_exits})
