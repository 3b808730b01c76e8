"""Batched-request serving engine with Edgent planning.

Pipeline per batch: admit (SLO scheduler) -> prefill -> decode loop.  Before
every decode step the engine consults the planner with the *current*
bandwidth (static Algorithm 1 or dynamic Algorithm 3), obtaining the
(exit point, partition) plan; the decode step executes the right-sized model
(``exit_point`` static argument -> the compiled variant that stops at that
segment), virtual time is billed per tier + link, and deadline demotion
rescues batches that fall behind.

The plan -> decode -> demote step lives in :class:`CoInferenceStepper`, a
reusable unit meant to be shared with the fleet simulator (ported with the
fleet slice): it owns the per-exit decode callables and a plan cache keyed on quantized
bandwidth state, so many devices that observe the same bandwidth state reuse
one Algorithm-1 search result.

Token values come from real model execution — through the port's kernels
on the card (prefill flash attention, decode attention and the fused exit
head that picks each token), through their plain versions on the CPU;
timing comes from the latency models — deterministic and host-independent.

This slice ports the serial decode path.  The batched (``vmap``-group) and
slot-resident arena decode methods of the reference arrive with the arena
slice (``ROADMAP.md``); until then :meth:`CoInferenceStepper.cache_stats`
reports their blocks at zero so the schema is the reference's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.graph import InferenceGraph
from repro_torch.core.partitioner import (CoInferencePlan, branch_latency,
                                    branch_preds, multi_branch_latency,
                                    proportional_cuts)
from repro_torch.core.planner import EdgentPlanner
from repro_torch.kernels.exit_head import ops as eh_ops
from repro_torch.kernels.exit_head import ref as eh_ref
from repro_torch.models.api import Model
from repro_torch.serving.scheduler import SLOScheduler, pick_exit
from repro_torch.serving.tiers import Link


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int
    slo_s: float
    arrival_s: float = 0.0

    @property
    def deadline_s(self) -> float:
        return self.arrival_s + self.slo_s


@dataclass
class ServeStats:
    latencies: List[float] = field(default_factory=list)
    met_slo: List[bool] = field(default_factory=list)
    exits: List[int] = field(default_factory=list)
    partitions: List[int] = field(default_factory=list)
    throughputs: List[float] = field(default_factory=list)
    queue_delays: List[float] = field(default_factory=list)
    tokens: Dict[int, List[int]] = field(default_factory=dict)

    def summary(self) -> Dict[str, float]:
        return {
            "requests": len(self.latencies),
            "p50_latency_s": float(np.percentile(self.latencies, 50)) if self.latencies else 0.0,
            "p99_latency_s": float(np.percentile(self.latencies, 99)) if self.latencies else 0.0,
            "slo_attainment": float(np.mean(self.met_slo)) if self.met_slo else 0.0,
            "mean_exit": float(np.mean(self.exits)) if self.exits else 0.0,
            "mean_throughput_tps": float(np.mean(self.throughputs)) if self.throughputs else 0.0,
            "mean_queue_delay_s": float(np.mean(self.queue_delays)) if self.queue_delays else 0.0,
        }


_QBW_MEMO: Dict[float, float] = {}


def quantize_bw(bw_bps: float, sig_figs: int = 3) -> float:
    """Round a bandwidth observation to ``sig_figs`` significant figures —
    the plan-cache key: devices in the same (quantized) bandwidth state share
    one Algorithm-1/2 search result.  Memoized at the default precision (a
    pure function; trace bandwidths recur constantly on the fleet hot path,
    where the floor/log10 pair is measurable)."""
    if sig_figs == 3:
        hit = _QBW_MEMO.get(bw_bps)
        if hit is not None:
            return hit
    if bw_bps <= 0.0:
        q = 0.0
    else:
        mag = 10.0 ** (math.floor(math.log10(bw_bps)) - sig_figs + 1)
        q = round(bw_bps / mag) * mag
    if sig_figs == 3 and len(_QBW_MEMO) < (1 << 20):
        _QBW_MEMO[bw_bps] = q
    return q


class CoInferenceStepper:
    """Reusable plan -> decode -> demote unit.

    Shared by :class:`ServingEngine` (one device-edge pair) and, once the
    fleet slice lands, the fleet engine (many pairs): holds the per-exit
    decode callables and a plan cache shared across callers.
    ``model`` may be ``None`` for timing-only simulation (no real decode).
    """

    #: the reference's bound on batched-decode variants, reported by
    #: cache_stats; the batched variants arrive with the arena slice
    JIT_CACHE_MAX = 32

    def __init__(self, model: Optional[Model], graph: InferenceGraph,
                 planner: EdgentPlanner, *, dynamic: bool = False,
                 plan_cache: Optional[Dict[tuple, CoInferencePlan]] = None,
                 impl: str = "kernel"):
        self.model, self.graph, self.planner = model, graph, planner
        self.dynamic = dynamic
        # "kernel": prefill/decode attention and the exit head run the port's
        # kernels (their plain versions for CPU tensors); "dense": the
        # reference's dense attention and the plain exit head
        self.impl = impl
        # key: (quantized bw, edge-speed tuple[, quantized device slowdown,
        #       backbone bw])
        self.plan_cache: Dict[tuple, CoInferencePlan] = \
            plan_cache if plan_cache is not None else {}
        self._step_cache: Dict[tuple, List[float]] = {}
        # (partition, qbw, edge_load) -> per-exit accumulator snapshots
        # taken after the edge-side terms of per_exit_times' fold; misses
        # on the continuous device_load axis replay only the device suffix
        # (see per_exit_times_cached)
        self._prefix_cache: Dict[tuple, tuple] = {}
        # (exit, assignment, backbone bw) -> precomputed hop/span timeline;
        # lives on the stepper so every engine sharing it (the whole fleet)
        # shares one memo
        self.hop_cache: Dict[tuple, object] = {}
        # cumulative hit/miss counters per cache (plain ints — the lookups
        # sit under every fleet round).  hop_* is maintained by the fleet
        # engine, whose cache this is.
        self.plan_hits = self.plan_misses = 0
        self.step_hits = self.step_misses = 0
        self.hop_hits = self.hop_misses = 0
        # per-model-exit decode callables.  PyTorch runs eagerly, so there
        # is nothing to compile; the memo (and the "jit" block of
        # cache_stats, kept for the reference's schema) counts variants.
        self._decode_fns: Dict[Optional[int], object] = {}
        self.jit_hits = self.jit_misses = 0
        self.n_graph = graph.num_exits
        self.n_model = model.num_segments if model is not None else graph.num_exits
        self.exit_points = list(range(1, self.n_graph + 1))

    # ------------------------------------------------------------ planning
    def plan(self, bw_bps: float) -> CoInferencePlan:
        """Online tuning at the current bandwidth.  Static plans are cached
        by (quantized bandwidth, edge-speed tuple) — the single-pair path
        uses the empty speed tuple; the dynamic optimizer is stateful (BOCD)
        so it is always consulted directly."""
        if self.dynamic:
            return self.planner.plan(bw_bps, dynamic=True)
        key = (quantize_bw(bw_bps), ())
        plan = self.plan_cache.get(key)
        if plan is None:
            self.plan_misses += 1
            plan = self.plan_cache[key] = self.planner.plan(bw_bps)
        else:
            self.plan_hits += 1
        return plan

    def plan_multi(self, bw_bps: float, edge_speeds: tuple, *,
                   device_load: float = 1.0,
                   edge_bw_bps: Optional[float] = None) -> CoInferencePlan:
        """Joint (exit, k-cut partition) plan for one ordered candidate edge
        set, cached on (quantized bandwidth, edge-speed tuple, quantized
        device slowdown): every device in the same bandwidth state asking
        about the same hardware reuses one search (the key the fleet's
        ``JointPlanner`` fans out over)."""
        assert not self.dynamic, "joint planning is static-environment only"
        key = (quantize_bw(bw_bps), tuple(edge_speeds),
               round(device_load, 3), edge_bw_bps)
        plan = self.plan_cache.get(key)
        if plan is None:
            self.plan_misses += 1
            plan = self.plan_cache[key] = self.planner.plan_multi(
                bw_bps, edge_speeds, device_load=device_load,
                edge_bw_bps=edge_bw_bps)
        else:
            self.plan_hits += 1
        return plan

    # ------------------------------------------------------------ timing
    def step_time(self, exit_point: int, partition: int, bw_bps: float, *,
                  edge_load: float = 1.0, device_load: float = 1.0,
                  include_input: bool = True) -> float:
        """Virtual per-token latency of (exit, partition) at bandwidth bw.

        ``include_input=False`` drops the input-uplink term (paid once at
        prefill, not per decode token) — the fleet engine bills it that way
        so queueing delay stays honest."""
        t = branch_latency(self.graph, exit_point, partition,
                           self.planner.f_edge, self.planner.f_device,
                           bw_bps, edge_load=edge_load,
                           device_load=device_load)
        if not include_input and partition > 0:
            t -= self.graph.input_bytes / bw_bps
        return t

    def _branch_preds(self):
        """Memoized :func:`~repro_torch.core.partitioner.branch_preds` for this
        stepper's (graph, models) triple — bit-exact input to the inlined
        latency accumulations below (see branch_preds for the contract)."""
        f_edge, f_device = self.planner.f_edge, self.planner.f_device
        key = (id(f_edge), id(f_device))
        if getattr(self, "_pred_key", None) != key:
            self._pred_key = key
            self._preds = branch_preds(self.graph, f_edge, f_device)
        return self._preds

    def per_exit_times(self, partition: int, bw_bps: float, *,
                       edge_load: float = 1.0, device_load: float = 1.0,
                       include_input: bool = True) -> List[float]:
        # inlined branch_latency over memoized per-layer predictions: the
        # identical float terms in the identical order as step_time(), minus
        # the per-call predictor dispatch (this sits under every fleet
        # round's cache miss)
        pe_all, pd_all = self._branch_preds()
        graph, p = self.graph, partition
        out = []
        for e in self.exit_points:
            pe, pd = pe_all[e - 1], pd_all[e - 1]
            t = 0.0
            if p > 0:
                t += graph.input_bytes / bw_bps
                t += graph.cut_bytes(e, p) / bw_bps
            for j in range(len(pe)):
                if j < p:
                    t += pe[j] * edge_load
                else:
                    t += pd[j] * device_load
            if not include_input and p > 0:
                t -= graph.input_bytes / bw_bps
            out.append(t)
        return out

    def input_time(self, partition: int, bw_bps: float) -> float:
        """One-shot input uplink cost (zero for device-only plans)."""
        return self.graph.input_bytes / bw_bps if partition > 0 else 0.0

    def _edge_prefix(self, partition: int, qbw: float,
                     edge_load: float) -> tuple:
        """Per-exit accumulator snapshots after the edge-side terms of
        :meth:`per_exit_times`' fold (io + cut + edge layers, in that
        order), plus the input-uplink term.  The snapshot is independent of
        ``device_load`` — the one continuous cache axis — so a fresh
        device_load only replays the short device suffix instead of the
        whole fold.  Replaying the suffix onto the snapshot reproduces the
        full fold bit-identically (same terms, same order)."""
        key = (partition, qbw, edge_load)
        hit = self._prefix_cache.get(key)
        if hit is None:
            pe_all, _ = self._branch_preds()
            graph, p = self.graph, partition
            inp = graph.input_bytes / qbw if p > 0 else 0.0
            base = []
            for e in self.exit_points:
                pe = pe_all[e - 1]
                t = 0.0
                if p > 0:
                    t += graph.input_bytes / qbw
                    t += graph.cut_bytes(e, p) / qbw
                for j in range(min(p, len(pe))):
                    t += pe[j] * edge_load
                base.append(t)
            hit = self._prefix_cache[key] = (base, inp)
        return hit

    def per_exit_times_cached(self, partition: int, bw_bps: float, *,
                              edge_load: float = 1.0,
                              device_load: float = 1.0,
                              include_input: bool = True) -> List[float]:
        """Memoized :meth:`per_exit_times` at quantized bandwidth — the fleet
        hot path: all inputs are piecewise-constant (traces change on a 1 s
        grid, loads are fixed per node), so devices in the same bandwidth
        state share one evaluation.  Misses rebuild from the
        :meth:`_edge_prefix` snapshot (device-suffix replay only) —
        bit-identical to the full :meth:`per_exit_times` fold."""
        qbw = quantize_bw(bw_bps)
        key = (partition, qbw, edge_load, device_load, include_input)
        hit = self._step_cache.get(key)
        if hit is None:
            self.step_misses += 1
            base, inp = self._edge_prefix(partition, qbw, edge_load)
            _, pd_all = self._branch_preds()
            p = partition
            out = []
            for i, e in enumerate(self.exit_points):
                pd = pd_all[e - 1]
                t = base[i]
                for j in range(p, len(pd)):
                    t += pd[j] * device_load
                if not include_input and p > 0:
                    t -= inp
                out.append(t)
            hit = self._step_cache[key] = out
        else:
            self.step_hits += 1
        return hit

    def per_exit_times_coop_cached(self, partition: int, edge_speeds: tuple,
                                   bw_bps: float, *,
                                   device_load: float = 1.0,
                                   edge_bw_bps: Optional[float] = None,
                                   include_input: bool = True) -> List[float]:
        """Per-exit step times for a multi-edge span plan (k-cut chain across
        ``edge_speeds`` with backbone hops).  With a single edge in the set
        this *is* :meth:`per_exit_times_cached` at that edge's speed — the
        k=1 reduction the oracle test pins — so the fleet engine can use one
        call site for both shapes."""
        speeds = tuple(edge_speeds)
        if len(speeds) <= 1:
            return self.per_exit_times_cached(
                partition, bw_bps, edge_load=speeds[0] if speeds else 1.0,
                device_load=device_load, include_input=include_input)
        qbw = quantize_bw(bw_bps)
        key = (partition, speeds, qbw, device_load, edge_bw_bps,
               include_input)
        hit = self._step_cache.get(key)
        if hit is not None:
            self.step_hits += 1
            return hit
        self.step_misses += 1
        out = []
        for e in self.exit_points:
            p_e = min(partition, len(self.graph.branches[e - 1]))
            cuts, kept = proportional_cuts(p_e, speeds)
            loads = [speeds[i] for i in kept]
            t = multi_branch_latency(self.graph, e, cuts, loads,
                                     self.planner.f_edge,
                                     self.planner.f_device, qbw,
                                     device_load=device_load,
                                     edge_bw_bps=edge_bw_bps,
                                     preds=self._branch_preds())
            if not include_input and p_e > 0:
                t -= self.graph.input_bytes / qbw
            out.append(t)
        self._step_cache[key] = out
        return out

    def choose_exit(self, remaining_s: float, per_exit: List[float],
                    tokens_left: int, preferred: int) -> int:
        """Deadline demotion (``pick_exit``) against the remaining budget."""
        return pick_exit(remaining_s, per_exit, tokens_left, preferred)

    def cache_stats(self) -> Dict[str, Dict]:
        """Hit/miss/size per memo (plan search, per-exit step times, coop
        hop schedules) — cumulative over the stepper's lifetime, which is
        fleet-wide and cross-run for a shared stepper.  Same schema as the
        reference's ``CoInferenceStepper.cache_stats``."""
        def block(hits: int, misses: int, entries: int) -> Dict:
            total = hits + misses
            return {"hits": hits, "misses": misses, "entries": entries,
                    "hit_rate": round(hits / total, 6) if total else None}
        return {
            "plan": block(self.plan_hits, self.plan_misses,
                          len(self.plan_cache)),
            "step": block(self.step_hits, self.step_misses,
                          len(self._step_cache)),
            "hop": block(self.hop_hits, self.hop_misses,
                         len(self.hop_cache)),
            # decode variants, per model exit; the batched and arena
            # families (and the counters of the "decode" and "arena"
            # blocks) arrive with the arena slice and read zero until then
            "jit": dict(block(self.jit_hits, self.jit_misses,
                              len(self._decode_fns)),
                        max_entries=self.JIT_CACHE_MAX,
                        variants={"serial": len(self._decode_fns),
                                  "batched": 0, "arena": 0}),
            "decode": {"batched_calls": 0, "batched_tokens": 0,
                       "serial_tokens": 0, "padded_rows": 0,
                       "batched_max": 0},
            "arena": {"calls": 0, "tokens": 0, "masked_rows": 0,
                      "admits": 0, "evicts": 0, "grows": 0,
                      "occupancy": None, "variants": 0},
        }

    # ------------------------------------------------------------ decode path
    def to_model_exit(self, graph_exit: int) -> int:
        # the planner's graph may describe the FULL-size architecture while
        # the executing model is the reduced config: map exit points
        # proportionally (graph exit i -> model segment)
        return max(1, round(graph_exit * self.n_model / self.n_graph))

    def prefill_fn(self):
        """The prefill callable ``(params, tokens, cache) -> (h, cache)``."""
        assert self.model is not None, "timing-only stepper has no prefill"
        return partial(self.model.prefill, impl=self.impl)

    def decode_fn(self, graph_exit: Optional[int]):
        """The decode callable ``(params, cache, tokens, pos) -> (h, cache)``
        right-sized to ``graph_exit``'s model exit."""
        assert self.model is not None, "timing-only stepper has no decode path"
        mexit = None if graph_exit is None else self.to_model_exit(graph_exit)
        if mexit not in self._decode_fns:
            self.jit_misses += 1
            ep = None if mexit is None or mexit >= self.n_model else mexit - 1
            self._decode_fns[mexit] = (
                lambda p, c, t, pos: self.model.decode_step(
                    p, c, t, pos, exit_point=ep, impl=self.impl)[:2])
        else:
            self.jit_hits += 1
        return self._decode_fns[mexit]

    def next_token(self, params, h):
        """Greedy token of normed hidden ``h`` [B, 1, D] as [B, 1] int32:
        the fused exit-head kernel for ``impl="kernel"`` (its plain version
        on the CPU), the plain head for ``impl="dense"``.  Both take the
        first index among equal maxima over the padded vocab, as the
        reference's argmax over the logits."""
        head = (eh_ops.exit_confidence if self.impl == "kernel"
                else eh_ref.exit_confidence)
        return head(h, params["embed"])["token"][:, -1:]


class ServingEngine:
    """Edgent-planned batched serving on one device-edge pair.

    ``params`` live on the device the engine serves on (the CUDA card, or
    the CPU for the plain versions); caches and tokens are made there.
    ``impl`` is handed to the stepper (see :class:`CoInferenceStepper`).
    After each batch, ``last_hidden`` holds its final decode step's normed
    hidden state [B, 1, D]."""

    def __init__(self, model: Model, params, graph: InferenceGraph,
                 planner: EdgentPlanner, link: Link, *, batch_size: int = 4,
                 max_seq: int = 128, dtype=torch.float32,
                 dynamic: bool = False, demote_on_deadline: bool = True,
                 impl: str = "kernel"):
        self.model, self.params, self.graph = model, params, graph
        self.planner, self.link = planner, link
        self.batch_size, self.max_seq = batch_size, max_seq
        self.dtype = dtype
        self.device = params["embed"].device
        self.dynamic = dynamic
        self.demote = demote_on_deadline
        self.sched = SLOScheduler(batch_size)
        self.stepper = CoInferenceStepper(model, graph, planner,
                                          dynamic=dynamic, impl=impl)
        self.last_hidden: Optional[torch.Tensor] = None

    # ------------------------------------------------------------ serve
    def serve(self, requests: List[Request]) -> ServeStats:
        stats = ServeStats()
        for r in requests:
            self.sched.submit(r.rid, r.deadline_s, r.arrival_s)
        reqs = {r.rid: r for r in requests}
        now = 0.0
        while len(self.sched):
            batch_ids = self.sched.next_batch(now)
            if not batch_ids:           # idle until the next arrival
                now = self.sched.earliest_arrival()
                continue
            batch = [reqs[i] for i in batch_ids]
            now = self._serve_batch(batch, stats, now)
        return stats

    def _serve_batch(self, batch: List[Request], stats: ServeStats,
                     start_s: float = 0.0) -> float:
        B = len(batch)
        prompt_len = max(len(r.prompt) for r in batch)
        toks = np.zeros((B, prompt_len), np.int32)
        for i, r in enumerate(batch):
            toks[i, -len(r.prompt):] = r.prompt            # left-pad
        max_new = max(r.max_new_tokens for r in batch)
        cache = self.model.init_cache(B, prompt_len + max_new + 1,
                                      dtype=self.dtype, device=self.device)
        # ---- plan at batch start
        bw = self.link.current()
        plan = self.stepper.plan(bw)
        clock = start_s
        # prefill (virtual time: prefill ~ prompt_len * step cost; value: real)
        h, cache = self.stepper.prefill_fn()(
            self.params, torch.from_numpy(toks).to(self.device), cache)
        clock += self.stepper.step_time(plan.exit_point, plan.partition, bw) * \
            max(1, prompt_len // 8)
        next_tok = self.stepper.next_token(self.params, h)
        out_tokens = [[] for _ in range(B)]
        # each request's own deadline includes the time it already spent
        # queued: the batch budget is the earliest deadline in absolute time
        budget = min(r.deadline_s for r in batch)
        exit_point = plan.exit_point
        for step in range(max_new):
            bw = self.link.current()
            if self.demote:
                per_exit = self.stepper.per_exit_times(plan.partition, bw)
                exit_point = self.stepper.choose_exit(
                    budget - clock, per_exit, max_new - step, plan.exit_point)
            t_step = self.stepper.step_time(exit_point, plan.partition, bw)
            fn = self.stepper.decode_fn(exit_point)
            h, cache = fn(self.params, cache, next_tok, prompt_len + step)
            next_tok = self.stepper.next_token(self.params, h)
            host_tok = next_tok[:, 0].tolist()
            for i in range(B):
                if step < batch[i].max_new_tokens:
                    out_tokens[i].append(host_tok[i])
            clock += t_step
            self.link.advance()
        self.last_hidden = h
        for i, r in enumerate(batch):
            stats.latencies.append(max(0.0, clock - r.arrival_s))
            stats.met_slo.append(clock <= r.deadline_s)
            stats.exits.append(exit_point)
            stats.partitions.append(plan.partition)
            stats.throughputs.append(max_new / max(clock - start_s, 1e-9))
            stats.queue_delays.append(max(0.0, start_s - r.arrival_s))
            stats.tokens[r.rid] = out_tokens[i]
        return clock
