"""Slot-resident decode arena: persistent batched decode state for one edge
(the counterpart of ``src/repro/serving/arena.py``).

A request's B=1 cache is scattered into a free row of a preallocated
batch-``slots`` model cache, padded along the sequence axis to a shared
arena length, **once** at admission (``admit``); it stays resident across
rounds and is gathered back out only when it leaves (``extract``, for
handover shipping).  Per-round traffic is just the small (tokens,
positions, active-mask) tensors, and the call shape never changes, so
there is at most one decode variant per model exit
(``CoInferenceStepper.decode_fn_arena``).

Every cache leaf of the port has its batch on axis 1 (``[n_units, B,
...]``), so the reference's ``vmap``-stacked ``[slots, ...]`` rows are
that batch axis here: the arena *is* a model cache of batch ``slots``, and
an arena call is one batched ``decode_step``.

What holds the arena to the serial path:

* the decode attention masks positions beyond a row's write head
  (``lengths`` of the decode kernel, the ``-1e30`` bias of the dense
  path), so the zero padding between a request's true cache length and
  the arena length adds exactly +0.0;
* rows outside an arena call's mask run with token 0 at position 0, and
  the masked commit (``decode_step(mask=)``) leaves their state bit for bit
  as it was, so several exit groups may sweep one arena in turn.

The reference's arena call equals its serial path bit for bit.  Torch
does not promise that across batch widths (a GEMM may reduce in another
order at M = 8 than at M = 1, and the decode kernel splits its keys by the
cache length), so the port holds arena tokens equal to serial tokens where
the top-2 margin allows it, and hidden states allclose
(``tests/test_torch_arena.py``).  Bitwise: rows outside a call's mask, and
``extract`` after ``admit``.
"""
from __future__ import annotations

import heapq
from typing import Dict, List

import torch

from repro_torch.device import resolve
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import tree_map

__all__ = ["DecodeArena", "cache_sig", "pow2", "tree_leaves", "tree_map"]


def pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1)."""
    b = 1
    while b < n:
        b <<= 1
    return b


def cache_sig(cache) -> tuple:
    """Hashable shape/dtype signature of a cache tree's leaves."""
    return tuple((tuple(leaf.shape), str(leaf.dtype))
                 for leaf in tree_leaves(cache))


class DecodeArena:
    """Persistent batch-``slots`` decode state for one edge's batch.

    ``slots`` and ``length`` are sized up front (edge capacity, workload
    max cache length) so steady-state geometry, and with it the set of
    decode variants, is fixed; both still grow on demand (slots double,
    length re-buckets) when a workload outruns its hints.  ``bucket``
    selects the length policy: ``"pow2"`` rounds the arena length up to a
    power of two, ``"exact"`` keeps it as given.  The cache lives on
    ``device``.
    """

    def __init__(self, model, *, slots: int, length: int, dtype,
                 bucket: str = "pow2", stepper=None, device="cuda"):
        if bucket not in ("pow2", "exact"):
            raise ValueError(f"unknown arena bucket policy {bucket!r}: "
                             "expected 'pow2' or 'exact'")
        self.model = model
        self.dtype = dtype
        self.bucket = bucket
        self.stepper = stepper
        self.device = resolve(device)
        self.slots = pow2(max(1, slots))
        self.length = self._bucket_len(max(1, length))
        # per-leaf sequence axis, found by comparing cache shapes at two
        # lengths on the meta device (-1 = a length-independent leaf); the
        # axes form a tree congruent with the cache
        s1 = model.init_cache(1, 17, dtype=dtype, device="meta")
        s2 = model.init_cache(1, 19, dtype=dtype, device="meta")

        def seq_axis(a, b):
            diff = [i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                    if x != y]
            if len(diff) > 1:
                raise ValueError(
                    f"cache leaf varies on {len(diff)} axes with max_seq "
                    f"({tuple(a.shape)} vs {tuple(b.shape)}); arena needs "
                    "exactly one sequence axis per leaf")
            return diff[0] if diff else -1
        self._seq_ax = tree_map(seq_axis, s1, s2)
        self.cache = self._alloc(self.slots, self.length)
        self._free: List[int] = list(range(self.slots))
        heapq.heapify(self._free)
        self._slot_of: Dict[object, int] = {}
        self._true_len: Dict[object, int] = {}

    # ------------------------------------------------------------ geometry
    def _bucket_len(self, n: int) -> int:
        return pow2(n) if self.bucket == "pow2" else n

    def _alloc(self, slots: int, length: int):
        return self.model.init_cache(slots, length, dtype=self.dtype,
                                     device=self.device)

    def sig(self) -> tuple:
        """Hashable shape/dtype signature of the arena leaves: the key of
        the arena decode variant (one per (exit, sig))."""
        return cache_sig(self.cache)

    @property
    def active(self) -> int:
        return len(self._slot_of)

    def has(self, rid) -> bool:
        return rid in self._slot_of

    def slot(self, rid) -> int:
        return self._slot_of[rid]

    def true_len(self, rid) -> int:
        """The resident request's own cache length (its serial-path
        ``max_seq``); ``extract`` slices the arena row back to it."""
        return self._true_len[rid]

    def _count(self, name: str, n: int = 1) -> None:
        if self.stepper is not None:
            setattr(self.stepper, name, getattr(self.stepper, name) + n)

    def _grow_slots(self) -> None:
        new_slots = self.slots * 2
        self.cache = tree_map(
            lambda leaf: torch.cat(
                [leaf, leaf.new_zeros(leaf.shape[:1] + (new_slots - self.slots,)
                                      + leaf.shape[2:])], dim=1),
            self.cache)
        for s in range(self.slots, new_slots):
            heapq.heappush(self._free, s)
        self.slots = new_slots
        self._count("arena_grows")

    def _grow_length(self, need: int) -> None:
        new_len = self._bucket_len(need)

        def grow(leaf, ax):
            if ax < 0:
                return leaf
            pad = list(leaf.shape)
            pad[ax] = new_len - leaf.shape[ax]
            return torch.cat([leaf, leaf.new_zeros(pad)], dim=ax)
        self.cache = tree_map(grow, self.cache, self._seq_ax)
        self.length = new_len
        self._count("arena_grows")

    # ------------------------------------------------------------ residency
    def admit(self, rid, cache) -> int:
        """Copy one request's B=1 cache into a free slot row (its tail along
        the sequence axis zeroed: inert under the decode attention mask)
        and return the slot.  The copy is the only per-request write into
        the arena until the request leaves."""
        assert rid not in self._slot_of, f"rid {rid!r} already resident"
        lens = [leaf.shape[ax] for leaf, ax in zip(
            tree_leaves(cache), tree_leaves(self._seq_ax)) if ax >= 0]
        true_len = max(lens) if lens else self.length
        if true_len > self.length:
            self._grow_length(true_len)
        if not self._free:
            self._grow_slots()
        slot = heapq.heappop(self._free)

        def put(arena_leaf, row, ax):
            dst = arena_leaf[:, slot:slot + 1]
            if ax >= 0 and row.shape[ax] < self.length:
                dst.narrow(ax, row.shape[ax], self.length - row.shape[ax]).zero_()
                dst = dst.narrow(ax, 0, row.shape[ax])
            dst.copy_(row)
        tree_map(put, self.cache, cache, self._seq_ax)
        self._slot_of[rid] = slot
        self._true_len[rid] = true_len
        self._count("arena_admits")
        return slot

    def evict(self, rid) -> None:
        """Free the slot (bookkeeping only: stale rows are masked out of
        every later call and overwritten on re-admission)."""
        slot = self._slot_of.pop(rid)
        del self._true_len[rid]
        heapq.heappush(self._free, slot)
        self._count("arena_evicts")

    def extract(self, rid):
        """Copy the resident row back out as a standalone B=1 cache that
        owns its storage, sliced to the request's own length (bitwise what
        was admitted, when no decode ran in between), and evict.  The
        handover path ships this snapshot to the destination edge, whose
        arena re-admits it."""
        slot = self._slot_of[rid]
        true_len = self._true_len[rid]

        def cut(leaf, ax):
            row = leaf[:, slot:slot + 1]
            if ax >= 0 and row.shape[ax] > true_len:
                row = row.narrow(ax, 0, true_len)
            return row.clone()
        out = tree_map(cut, self.cache, self._seq_ax)
        self.evict(rid)
        return out
