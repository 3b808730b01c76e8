"""Batched-request serving engine with Edgent planning.

Pipeline per batch: admit (SLO scheduler) -> prefill -> decode loop.  Before
every decode step the engine consults the planner with the *current*
bandwidth (static Algorithm 1 or dynamic Algorithm 3), obtaining the
(exit point, partition) plan; the decode step executes the right-sized model
(``exit_point`` static argument -> the compiled variant that stops at that
segment), virtual time is billed per tier + link, and deadline demotion
rescues batches that fall behind.

The plan -> decode -> demote step lives in :class:`CoInferenceStepper`, a
reusable unit shared with the fleet simulator (``repro_torch.fleet.engine``):
it owns the per-exit decode callables and a plan cache keyed on quantized
bandwidth state, so many devices that observe the same bandwidth state reuse
one Algorithm-1 search result.

Token values come from real model execution — through the port's kernels
on the card (prefill flash attention, decode attention and the fused exit
head that picks each token), through their plain versions on the CPU;
timing comes from the latency models — deterministic and host-independent.

The stepper decodes three ways, as the reference's: serial (one request a
call), batched (co-located requests with congruent caches concatenated
along the batch axis, :meth:`CoInferenceStepper.decode_step_batch`) and
through a slot-resident :class:`~repro_torch.serving.arena.DecodeArena`
(:meth:`CoInferenceStepper.decode_step_arena`).  The reference's ``vmap``
rows are the batch axis of one eager call here; its jit caches become
memos of decode callables, which :meth:`CoInferenceStepper.cache_stats`
counts in the reference's schema.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard

from repro_torch.core.graph import InferenceGraph
from repro_torch.core.partitioner import (CoInferencePlan, branch_latency,
                                    branch_preds, multi_branch_latency,
                                    proportional_cuts)
from repro_torch.core.planner import EdgentPlanner
from repro_torch.kernels.exit_head import ops as eh_ops
from repro_torch.kernels.exit_head import ref as eh_ref
from repro_torch.models.api import Model
from repro_torch.obs import spans
from repro_torch.serving.arena import cache_sig, pow2, tree_map
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



def _shard_wrap(step, bucket: int):
    """The batched decode ``step`` split over a 1-D mesh of the world (the
    reference's ``shard_map`` of its vmapped step): every rank holds the
    whole parameters and batch, runs its own contiguous ``bucket / world``
    rows, and the rows are gathered back along the batch axis (dim 0 of
    the hidden state, dim 1 of every cache leaf).  On a world of one, or a
    bucket the world does not divide, this is ``step`` itself: the plain
    batched variant runs, bit for bit."""
    if not dist.is_initialized() or dist.get_world_size() <= 1 \
            or bucket % dist.get_world_size():
        return step
    world, rank = dist.get_world_size(), dist.get_rank()
    meshes = {}

    def gather(x, dim, mesh):
        return DTensor.from_local(x.contiguous(), mesh, [Shard(dim)],
                                  run_check=False).full_tensor()

    def sharded(params, cache, tokens, pos):
        dev = tokens.device.type
        if dev not in meshes:
            meshes[dev] = init_device_mesh(dev, (world,), mesh_dim_names=("b",))
        mesh, n = meshes[dev], tokens.shape[0] // world
        rows = slice(rank * n, (rank + 1) * n)
        h, c = step(params, tree_map(lambda x: x[:, rows].clone(), cache),
                    tokens[rows], pos[rows])
        return gather(h, 0, mesh), tree_map(lambda x: gather(x, 1, mesh), c)

    return sharded

class CoInferenceStepper:
    """Reusable plan -> decode -> demote unit.

    Shared by :class:`ServingEngine` (one device-edge pair) and
    ``repro_torch.fleet.engine.FleetEngine`` (many pairs): holds the
    per-exit decode callables and a plan cache shared across callers.
    ``model`` may be ``None`` for timing-only simulation (no real decode).
    """

    #: the reference's bound on compiled batched-decode variants, reported
    #: by cache_stats for its schema; eager PyTorch compiles nothing, so
    #: the port's memos need no bound
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
        # is nothing to compile; the memos (and the "jit" block of
        # cache_stats, kept for the reference's schema) count variants:
        # serial per model exit; batched per (model exit, batch bucket,
        # sharded); arena per (model exit,
        # arena signature), at most one per model exit while the arena
        # keeps its geometry.
        self._decode_fns: Dict[Optional[int], object] = {}
        self._decode_vfns: Dict[tuple, object] = {}
        self._decode_afns: Dict[tuple, object] = {}
        self.jit_hits = self.jit_misses = 0
        # decode-path execution counters, as the reference's
        self.batched_calls = 0        # batched group calls issued
        self.batched_tokens = 0       # tokens produced through batched groups
        self.serial_tokens = 0        # tokens produced one request at a time
        self.padded_rows = 0          # bucket padding rows computed+discarded
        self.batched_max = 0          # largest single batched group seen
        # arena-path execution counters: admit/evict/grow are the only
        # per-request writes, masked_rows counts inactive-slot rows
        # computed and discarded per call
        self.arena_calls = 0          # masked full-arena calls issued
        self.arena_tokens = 0         # tokens produced through arena calls
        self.arena_masked_rows = 0    # inactive rows computed+discarded
        self.arena_admits = 0         # slot copies (request enters arena)
        self.arena_evicts = 0         # slot frees (complete or extracted)
        self.arena_grows = 0          # slot-doubling / length re-bucketing
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
            # decode variants: serial per-exit + batched (exit, bucket)
            # entries + masked arena (exit, sig) entries, with the
            # per-family split under "variants"
            "jit": dict(block(self.jit_hits, self.jit_misses,
                              len(self._decode_fns) + len(self._decode_vfns)
                              + len(self._decode_afns)),
                        max_entries=self.JIT_CACHE_MAX,
                        variants={"serial": len(self._decode_fns),
                                  "batched": len(self._decode_vfns),
                                  "arena": len(self._decode_afns)}),
            # execution counters, not a hit/miss cache: how decode tokens
            # actually ran
            "decode": {"batched_calls": self.batched_calls,
                       "batched_tokens": self.batched_tokens,
                       "serial_tokens": self.serial_tokens,
                       "padded_rows": self.padded_rows,
                       "batched_max": self.batched_max},
            # arena execution counters; occupancy = active rows / rows
            # computed
            "arena": {"calls": self.arena_calls,
                      "tokens": self.arena_tokens,
                      "masked_rows": self.arena_masked_rows,
                      "admits": self.arena_admits,
                      "evicts": self.arena_evicts,
                      "grows": self.arena_grows,
                      "occupancy": round(
                          self.arena_tokens
                          / (self.arena_tokens + self.arena_masked_rows), 4)
                      if self.arena_tokens + self.arena_masked_rows else None,
                      "variants": len(self._decode_afns)},
        }

    # ------------------------------------------------------------ decode path
    def to_model_exit(self, graph_exit: int) -> int:
        # the planner's graph may describe the FULL-size architecture while
        # the executing model is the reduced config: map exit points
        # proportionally (graph exit i -> model segment)
        return max(1, round(graph_exit * self.n_model / self.n_graph))

    def prefill_fn(self):
        """The prefill callable ``(params, tokens, cache, *, lengths=None)
        -> (h, cache)`` (``lengths``: see :meth:`Model.prefill`)."""
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

    # --------------------------------------------------------- batched decode
    @staticmethod
    def batch_bucket(n: int) -> int:
        """Batch widths come in power-of-two buckets: a group of ``n``
        co-located requests pads up to the bucket, so a continuous batch
        whose width wobbles round to round reuses one variant per bucket
        instead of one per width."""
        return pow2(n)

    def decode_fn_batched(self, graph_exit: Optional[int], batch: int, *,
                          sharded: bool = False):
        """The batched decode callable ``(params, cache, tokens, pos) ->
        (h, cache)`` for ``graph_exit`` at ``batch`` co-located requests,
        over caches concatenated along the batch axis with one position per
        row; memoized per ``(model exit, batch bucket, sharded)``.
        ``sharded`` splits the batch over a 1-D mesh of the world
        (:func:`_shard_wrap`)."""
        assert self.model is not None, "timing-only stepper has no decode path"
        mexit = None if graph_exit is None else self.to_model_exit(graph_exit)
        bucket = self.batch_bucket(batch)
        key = (mexit, bucket, bool(sharded))
        fn = self._decode_vfns.get(key)
        if fn is None:
            self.jit_misses += 1
            ep = None if mexit is None or mexit >= self.n_model else mexit - 1
            fn = (lambda p, c, t, pos: self.model.decode_step(
                p, c, t, pos, exit_point=ep, impl=self.impl)[:2])
            if sharded:
                fn = _shard_wrap(fn, bucket)
            self._decode_vfns[key] = fn
        else:
            self.jit_hits += 1
        return fn

    @staticmethod
    def _cache_sig(cache) -> tuple:
        """Hashable shape/dtype signature of one request's decode cache.
        Batched groups concatenate caches leaf by leaf, so only requests
        whose caches are congruent (same tenant geometry: prompt + budget
        sizing) may share a call."""
        return cache_sig(cache)

    def decode_step_batch(self, params, items: Sequence[tuple], *,
                          sharded: bool = False) -> List[Tuple[object, object]]:
        """One decode step for many co-located requests in as few calls as
        the cache geometry allows.

        ``items`` rows are ``(graph_exit, cache, next_tok, pos)`` with B=1
        caches (``pos`` a python int).  Rows are grouped by (exit, cache
        signature); each group is concatenated along the batch axis, padded
        up to its power-of-two bucket with copies of row 0 (``torch.cat``
        copies, so a padding row shares no storage with row 0 and its
        in-place cache writes touch nothing a request holds; the discard is
        counted in ``padded_rows``), and run through
        :meth:`decode_fn_batched`.  Returns ``(hidden, new_cache)`` per
        item, in item order; each new cache is a copy of its row that owns
        its storage, so a later serial call that writes it in place touches
        no other request.  A single-row group runs the serial variant."""
        out: List[Optional[Tuple[object, object]]] = [None] * len(items)
        groups: "OrderedDict[tuple, List[int]]" = OrderedDict()
        for i, (gexit, cache, _tok, _pos) in enumerate(items):
            groups.setdefault((gexit, self._cache_sig(cache)), []).append(i)
        for (gexit, _sig), idxs in groups.items():
            n = len(idxs)
            if n == 1:
                i = idxs[0]
                _, cache, tok, pos = items[i]
                out[i] = self.decode_fn(gexit)(params, cache, tok, pos)
                self.serial_tokens += 1
                continue
            bucket = self.batch_bucket(n)
            rows = [items[i] for i in idxs]
            rows += [rows[0]] * (bucket - n)              # pad: replicate
            cb = tree_map(lambda *xs: torch.cat(xs, dim=1), *[r[1] for r in rows])
            tb = torch.cat([r[2] for r in rows], dim=0)
            pb = torch.tensor([r[3] for r in rows], dtype=torch.long,
                              device=tb.device)
            fn = self.decode_fn_batched(gexit, n, sharded=sharded)
            hb, cob = fn(params, cb, tb, pb)
            for j, i in enumerate(idxs):
                out[i] = (hb[j:j + 1],
                          tree_map(lambda x, j=j: x[:, j:j + 1].clone(), cob))
            self.batched_calls += 1
            self.batched_tokens += n
            self.padded_rows += bucket - n
            if n > self.batched_max:
                self.batched_max = n
        return out

    # ---------------------------------------------------------- arena decode
    def decode_fn_arena(self, graph_exit: Optional[int], arena):
        """The masked full-arena decode callable ``(params, cache, tokens,
        pos, mask) -> (h, cache)`` for ``graph_exit`` over ``arena``'s
        geometry: one batched ``decode_step`` over all ``slots`` rows whose
        ``mask`` selects the rows that commit their cache writes (the
        others keep their state bit for bit).  Keyed ``(model exit, arena
        signature)``, so while the arena keeps its geometry there is one
        variant per model exit whatever the prompt-length and batch-width
        mix."""
        assert self.model is not None, "timing-only stepper has no decode path"
        mexit = None if graph_exit is None else self.to_model_exit(graph_exit)
        key = (mexit, arena.sig())
        fn = self._decode_afns.get(key)
        if fn is not None:
            self.jit_hits += 1
            return fn
        self.jit_misses += 1
        ep = None if mexit is None or mexit >= self.n_model else mexit - 1
        fn = (lambda p, c, t, pos, mask: self.model.decode_step(
            p, c, t, pos, exit_point=ep, impl=self.impl, mask=mask)[:2])
        self._decode_afns[key] = fn
        return fn

    def decode_step_arena(self, params, arena, items: Sequence[tuple]
                          ) -> List[tuple]:
        """One decode step for every active slot of ``arena`` in at most
        one call per model exit.

        ``items`` rows are ``(graph_exit, slot, next_tok, pos)``: no
        caches, the state is already resident.  Rows sharing a model exit
        decode in one masked full-arena call; rows outside the mask run
        with token 0 at position 0 and keep their state, so several exit
        groups may sweep the same arena in turn.  Returns one ``(rows,
        hidden)`` pair per exit group, ``hidden`` being the full ``[slots,
        1, D]`` batch: callers index it by slot, or feed it whole to one
        batched logits/argmax epilogue per group."""
        slots, dev = arena.slots, arena.device
        groups: "OrderedDict[Optional[int], List[tuple]]" = OrderedDict()
        for gexit, slot, tok, pos in items:
            mexit = None if gexit is None else self.to_model_exit(gexit)
            groups.setdefault(mexit, []).append((gexit, slot, tok, pos))
        out: List[tuple] = []
        for rows in groups.values():
            pos_a = np.zeros((slots,), np.int64)
            mask_a = np.zeros((slots,), bool)
            for _, slot, _, pos in rows:
                pos_a[slot] = pos
                mask_a[slot] = True
            idx = torch.tensor([r[1] for r in rows], dtype=torch.long, device=dev)
            tok_a = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
            tok_a.index_copy_(0, idx, torch.cat(
                [r[2].reshape(1, 1) for r in rows]).to(device=dev, dtype=torch.int32))
            fn = self.decode_fn_arena(rows[0][0], arena)
            h_all, arena.cache = fn(params, arena.cache, tok_a,
                                    torch.from_numpy(pos_a).to(dev),
                                    torch.from_numpy(mask_a).to(dev))
            out.append((rows, h_all))
            self.arena_calls += 1
            self.arena_tokens += len(rows)
            self.arena_masked_rows += slots - len(rows)
        return out

    def next_token(self, params, h):
        """Greedy token of normed hidden ``h`` [B, 1, D] as [B, 1] int32:
        the fused exit-head kernel for ``impl="kernel"`` (its plain version
        on the CPU), the plain head for ``impl="dense"``.  Both take the
        first index among equal maxima over the padded vocab, as the
        reference's argmax over the logits."""
        head = (eh_ops.exit_confidence if self.impl == "kernel"
                else eh_ref.exit_confidence)
        with spans.span("kernel.exit_head") if spans.on() else spans.OFF:
            out = head(h, params["embed"])
        return out["token"][:, -1:]


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
        self._t_serve: Optional[int] = None

    # ------------------------------------------------------------ serve
    def serve(self, requests: List[Request]) -> ServeStats:
        stats = ServeStats()
        # the host clock at entry, read only while recording: each request's
        # first-token time counts from here
        self._t_serve = spans.clock() if spans.on() else None
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
        lens = [len(r.prompt) for r in batch] if spans.on() else None
        # the padding: the requests' prompt positions, and the B x S of the
        # left-padded batch the prefill is handed
        with spans.span("engine.batch", {"B": len(lens), "S": max(lens), "prompt": sum(lens)},
                        {"engine.prompt_positions": sum(lens),
                         "engine.positions_computed": len(lens) * max(lens)}) \
                if lens else spans.OFF:
            return self._run_batch(batch, stats, start_s)

    def _run_batch(self, batch: List[Request], stats: ServeStats,
                   start_s: float) -> float:
        B = len(batch)
        lens = [len(r.prompt) for r in batch]
        prompt_len = max(lens)
        max_new = max(r.max_new_tokens for r in batch)
        counts: Dict[str, int] = {}             # added when engine.setup closes
        with spans.span("engine.setup", counts=counts) if spans.on() else spans.OFF:
            toks = np.zeros((B, prompt_len), np.int32)
            for i, r in enumerate(batch):
                toks[i, -len(r.prompt):] = r.prompt            # left-pad
            cache = self.model.init_cache(B, prompt_len + max_new + 1,
                                          dtype=self.dtype, device=self.device)
            toks = torch.from_numpy(toks).to(self.device)
            # rows of unequal prompts: their pad prefix is prefilled once
            shared = min(lens) < prompt_len and \
                self.model.shares_pad_prefix(self.params, cache)
            if shared:
                pad = prompt_len - min(lens)
                counts.update({"engine.pad_prefix.batches": 1,
                               "engine.pad_prefix.positions": pad,
                               "engine.pad_prefix.positions_skipped":
                                   B * prompt_len - pad - sum(lens)})
        # ---- plan at batch start
        with spans.span("engine.plan") if spans.on() else spans.OFF:
            bw = self.link.current()
            plan = self.stepper.plan(bw)
        clock = start_s
        # prefill (virtual time: prefill ~ prompt_len * step cost; value: real)
        h, cache = self.stepper.prefill_fn()(self.params, toks, cache,
                                             **({"lengths": lens} if shared else {}))
        clock += self.stepper.step_time(plan.exit_point, plan.partition, bw) * \
            max(1, prompt_len // 8)
        next_tok = self.stepper.next_token(self.params, h)
        out_tokens = [[] for _ in range(B)]
        # each request's own deadline includes the time it already spent
        # queued: the batch budget is the earliest deadline in absolute time
        budget = min(r.deadline_s for r in batch)
        exit_point = plan.exit_point
        for step in range(max_new):
            with spans.span("engine.plan") if spans.on() else spans.OFF:
                bw = self.link.current()
                if self.demote:
                    per_exit = self.stepper.per_exit_times(plan.partition, bw)
                    exit_point = self.stepper.choose_exit(
                        budget - clock, per_exit, max_new - step, plan.exit_point)
                t_step = self.stepper.step_time(exit_point, plan.partition, bw)
            fn = self.stepper.decode_fn(exit_point)
            h, cache = fn(self.params, cache, next_tok, prompt_len + step)
            next_tok = self.stepper.next_token(self.params, h)
            with spans.span("engine.token_read") if spans.on() else spans.OFF as sp:
                host_tok = next_tok[:, 0].tolist()
            if step == 0 and sp is not None and self._t_serve is not None:
                # this read holds every request's first generated token
                t = (sp.t1 - self._t_serve) * 1e-9
                for r in batch:
                    if r.max_new_tokens:
                        spans.REGISTRY.histogram("engine.first_token_s").observe(t)
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
