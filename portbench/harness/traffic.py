"""One general generator of closed-loop batch traffic from a mix's parameters.

A mix file (``traffic/<name>.json``) gives the batch size, the distributions of
prompt lengths and of new tokens, the tenants with their shares and SLOs, and the
size of the request pool.  The pool's sizes are fixed by the file alone: prompt
lengths and new-token counts are the distributions' quantiles at evenly spaced
probabilities, dealt into batches by the file's ``pool_seed``.  A run's ``--seed``
orders the pool's blocks (below) in every cycle through the pool, all but the
last, which ends every cycle, and the rows inside each batch, and draws every
prompt's ids and the bandwidth trace.  So every seed serves the same set of sizes
in another order, and a window that ends inside the first cycle's last block
holds the same work whatever the seed.

Batches are ordered in blocks: each block holds one batch from each cost stratum
(padded positions, ``strata`` of them), the costliest first, dealt so that blocks
cost alike, and the tenants in their shares.  Any run of whole blocks is a fair
sample of the pool, and a window that ends inside a block leaves out its cheapest
strata.  The pool's costliest batch is dealt to its first block, never the last, so
every window that serves most of a cycle serves it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Iterator, List

import numpy as np


@dataclass(frozen=True)
class Row:
    prompt_len: int
    new_tokens: int


@dataclass(frozen=True)
class PoolBatch:
    index: int
    rows: tuple          # of Row
    tenant: str
    slo_s: float

    @property
    def padded_len(self) -> int:
        return max(r.prompt_len for r in self.rows)

    @property
    def padded_positions(self) -> int:
        return len(self.rows) * self.padded_len


@dataclass
class Request:
    """A request as the harness makes it; ``serve.to_program`` hands it over."""
    rid: int
    prompt: np.ndarray   # [S] int32
    max_new_tokens: int
    slo_s: float
    tenant: str


@dataclass
class Batch:
    pool_index: int
    tenant: str
    requests: List[Request]

    @property
    def padded_len(self) -> int:
        return max(len(r.prompt) for r in self.requests)

    @property
    def steps(self) -> int:
        """Decode steps the engine runs for this batch: its largest budget."""
        return max(r.max_new_tokens for r in self.requests)


def _quantiles(dist: dict, n: int) -> List[int]:
    """``n`` values of ``dist`` at probabilities (i + 0.5) / n, as integers."""
    ps = [(i + 0.5) / n for i in range(n)]
    kind = dist["dist"]
    if kind == "lognormal":
        z = NormalDist()
        vals = [dist["median"] * math.exp(dist["sigma"] * z.inv_cdf(p)) for p in ps]
        return [int(round(min(max(v, dist["min"]), dist["max"]))) for v in vals]
    if kind == "uniform_int":
        lo, hi = dist["min"], dist["max"]
        return [lo + min(int(p * (hi - lo + 1)), hi - lo) for p in ps]
    raise ValueError(f"unknown distribution {kind!r}")


def pool(mix: dict) -> List[PoolBatch]:
    """The mix's pool of batches, in block order (see the module docstring)."""
    b, nb, strata = mix["batch"], mix["pool_batches"], mix["strata"]
    if nb % strata:
        raise ValueError("pool_batches must be a multiple of strata")
    n = b * nb
    rng = np.random.default_rng(mix["pool_seed"])
    lens = np.array(_quantiles(mix["prompt_len"], n))[rng.permutation(n)]
    news = np.array(_quantiles(mix["new_tokens"], n))[rng.permutation(n)]
    rows = [tuple(Row(int(lens[i]), int(news[i])) for i in range(k * b, (k + 1) * b))
            for k in range(nb)]
    cost = [len(r) * max(x.prompt_len for x in r) for r in rows]
    order = sorted(range(nb), key=lambda k: (cost[k], k))
    per = nb // strata
    # stratum s holds the s-th band of batches by cost; from the costliest band
    # down, each band's costliest batch goes to the block that costs least so far
    members = [[0] * strata for _ in range(per)]
    total = [0] * per
    for s in reversed(range(strata)):
        band = sorted(order[s * per:(s + 1) * per], key=lambda k: (-cost[k], k))
        for k, j in zip(band, sorted(range(per), key=lambda j: (total[j], j))):
            members[j][s] = k
            total[j] += cost[k]
    tenants = [t for t in mix["tenants"] for _ in range(round(t["share"] * strata))]
    if len(tenants) != strata:
        raise ValueError("tenant shares must divide a block of `strata` batches")
    out = []
    for j in range(per):
        for s in reversed(range(strata)):
            t = tenants[(s + j) % strata]
            out.append(PoolBatch(len(out), rows[members[j][s]], t["name"], float(t["slo_s"])))
    return out


def blocks(mix: dict, batches: List[PoolBatch]) -> List[List[PoolBatch]]:
    s = mix["strata"]
    return [batches[i:i + s] for i in range(0, len(batches), s)]


class Stream:
    """The batches a run serves, from ``seed``: cycles through the pool, each cycle
    in a fresh order of blocks; every request gets fresh prompt ids.  ``warmup()`` makes the warm-up batches (from their own
    stream of the same seed), ``next()`` the window's."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.vocab = mix, vocab
        self.batches = pool(mix)
        self.rng = np.random.default_rng([seed, 1])
        self.warm_rng = np.random.default_rng([seed, 2])
        self.rid = 0
        self._it = self._cycle()

    def _make(self, pb: PoolBatch, rng) -> Batch:
        rows = [pb.rows[i] for i in rng.permutation(len(pb.rows))]
        reqs = []
        for r in rows:
            ids = rng.integers(0, self.vocab, r.prompt_len, dtype=np.int64).astype(np.int32)
            reqs.append(Request(self.rid, ids, r.new_tokens, pb.slo_s, pb.tenant))
            self.rid += 1
        return Batch(pb.index, pb.tenant, reqs)

    def _cycle(self) -> Iterator[Batch]:
        bl = blocks(self.mix, self.batches)
        while True:
            for j in [*self.rng.permutation(len(bl) - 1), len(bl) - 1]:
                for pb in bl[j]:
                    yield self._make(pb, self.rng)

    def next(self) -> Batch:
        return next(self._it)

    def warmup(self) -> List[Batch]:
        """The pool's costliest batch under the first tenant (the window's largest
        shapes and memory), then its cheapest under each other tenant (the exit
        depths the other SLOs give)."""
        by_cost = sorted(self.batches, key=lambda b: (b.padded_positions, b.index))
        out = []
        for i, t in enumerate(self.mix["tenants"]):
            pick = by_cost[-1] if i == 0 else by_cost[0]
            pb = PoolBatch(pick.index, pick.rows, t["name"], float(t["slo_s"]))
            out.append(self._make(pb, self.warm_rng))
        return out


def dcn_trace(seed: int, length: int, base_gbps: float = 400.0,
              congested_gbps: float = 40.0) -> np.ndarray:
    """Inter-pod datacenter bandwidth with congestion episodes, bytes/s: the
    arithmetic of the program's ``dcn_trace``, copied so that the benchmark makes
    this input itself and hands the same trace to the program and the reference."""
    rng = np.random.default_rng(seed)
    out = np.full(length, base_gbps)
    t = 0
    while t < length:
        t += int(rng.integers(40, 120))
        dur = int(rng.integers(10, 60))
        out[t: t + dur] = congested_gbps * rng.uniform(0.5, 2.0)
        t += dur
    noise = rng.normal(1.0, 0.05, length)
    return np.clip(out * noise, 1.0, None) * 1e9 / 8


def bandwidth(mix: dict, seed: int) -> np.ndarray:
    bw = mix["bandwidth"]
    if bw["trace"] != "dcn":
        raise ValueError(f"unknown bandwidth trace {bw['trace']!r}")
    return dcn_trace(seed, bw["length"])
