"""Parameter sweeps over declarative scenarios (the counterpart of
``src/repro/sim/sweep.py``).

The ROADMAP's sweep runner: a *sweep* is a base :class:`ScenarioSpec` plus a
set of dotted-path axes, expanded into cells (grid = cartesian product,
random = independent draws), executed in parallel across worker processes,
and written as one JSONL file of ``{"spec": ..., "metrics": ...}`` rows —
replacing the hand-rolled per-benchmark loops ``benchmarks/fleet_scale.py``
used to carry.

    from repro_torch.sim.sweep import grid_cells, run_sweep
    cells = grid_cells(get_scenario("smoke-lm"),
                       {"topology.num_devices": [100, 200, 400],
                        "router.name": ["jsq", "bandwidth-aware"]})
    rows = run_sweep(cells, out_path="sweep.jsonl", processes=4)

Every cell is an independent, fully-specified spec, so results are
reproducible row by row (``python -m repro_torch.sim --spec`` on the embedded
spec re-runs any cell) and cell order never affects metrics.  From the
shell:

    python -m repro_torch.sim.sweep --scenario smoke-lm \\
        --grid topology.num_devices=[100,200] --grid router.name='["jsq"]' \\
        --out sweep.jsonl --processes 2

A real-decode cell runs its model on ``device`` (the card unless the caller
asks for the CPU: ``device="cpu"``, ``--device cpu``).  The device travels
with each cell to the spawn workers, each of which opens its own context on
the one card; the kernels are built in the parent before the pool starts,
so a worker only loads the library.  A failing cell fails the sweep.
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.device import resolve
from repro_torch.sim.registry import get_scenario
from repro_torch.sim.spec import ScenarioSpec, apply_overrides

__all__ = ["grid_cells", "pareto_frontier", "random_cells", "run_cell",
           "run_sweep", "main"]


def grid_cells(base: ScenarioSpec,
               axes: Dict[str, Sequence]) -> List[ScenarioSpec]:
    """Cartesian product of dotted-path axes over ``base`` — one fresh spec
    per combination, in row-major order of the axes dict (later axes vary
    fastest).  Axis paths take anything ``apply_overrides`` accepts,
    including ``seed``."""
    names = list(axes)
    cells = []
    for combo in itertools.product(*(axes[n] for n in names)):
        cells.append(apply_overrides(base, dict(zip(names, combo))))
    return cells


def random_cells(base: ScenarioSpec, axes: Dict[str, Sequence], n: int, *,
                 seed: int = 0) -> List[ScenarioSpec]:
    """``n`` independent draws: each cell picks one value per axis uniformly
    (deterministic in ``seed``) — random search over the same axis space a
    grid would enumerate."""
    rng = np.random.default_rng(seed)
    names = list(axes)
    cells = []
    for _ in range(n):
        combo = {name: axes[name][int(rng.integers(len(axes[name])))]
                 for name in names}
        cells.append(apply_overrides(base, combo))
    return cells


def run_cell(spec: ScenarioSpec, *, device="cuda") -> Dict:
    """Execute one cell; the JSONL row dict (``wall_s`` and ``events`` are
    measurement metadata — ``metrics`` is a pure function of ``spec``).
    ``engine.trace`` / ``engine.timeline`` are ordinary spec paths, so a
    sweep axis (or ``--set``) can attach the ``repro.obs`` observers to any
    cell without changing its metrics.  Module-level so worker processes
    can unpickle it."""
    import time

    from repro_torch.sim.build import Simulation
    t0 = time.perf_counter()
    if spec.topology.shards > 1:
        # sharded cell: tiles run sequentially inside this worker (the
        # sweep already owns the process-level parallelism)
        from repro_torch.sim.shard import run_sharded_info
        metrics, info = run_sharded_info(spec)
        return {"spec": spec.to_dict(), "metrics": metrics.summary(),
                "events": {"processed": info["events_processed"],
                           "by_kind": info["event_counts"]},
                "wall_s": round(time.perf_counter() - t0, 3)}
    sim = Simulation(spec, device=device)
    metrics = sim.run().summary()
    engine = sim.scenario.engine
    row = {"spec": spec.to_dict(), "metrics": metrics,
           "events": {"processed": engine.events_processed,
                      "by_kind": dict(sorted(engine.event_counts.items()))},
           "wall_s": round(time.perf_counter() - t0, 3)}
    if spec.engine.real_decode:
        # decode-efficiency columns (docs/performance.md): deterministic
        # token/call counters from the stepper, so parallel and inline
        # sweeps still produce identical rows (only wall_s is stripped by
        # the equivalence pin in tests/test_sweep.py)
        st = engine.stepper.cache_stats()
        dec, ar, jit = st["decode"], st["arena"], st["jit"]
        waste_den = dec["batched_tokens"] + dec["padded_rows"]
        row["decode"] = {
            "batched_calls": dec["batched_calls"],
            "batched_max": dec["batched_max"],
            "padded_rows": dec["padded_rows"],
            "pad_waste": round(dec["padded_rows"] / waste_den, 4)
            if waste_den else 0.0,
            "serial_tokens": dec["serial_tokens"],
            "jit_hit_rate": jit["hit_rate"],
            "jit_variants": jit["variants"],
            "arena_calls": ar["calls"],
            "arena_tokens": ar["tokens"],
            "arena_occupancy": ar["occupancy"],
        }
    return row


def _run_cell_json(payload: str) -> Dict:
    spec_json, device = json.loads(payload)
    return run_cell(ScenarioSpec.from_json(spec_json), device=device)


def run_sweep(cells: Iterable[ScenarioSpec], *,
              out_path: Optional[str] = None,
              processes: Optional[int] = None,
              progress: bool = False, device="cuda") -> List[Dict]:
    """Run every cell and return its rows in cell order (the order is
    presentation only — each cell is deterministic in its own spec).

    ``processes`` > 1 fans cells out over a multiprocessing pool (specs
    travel as JSON, so workers rebuild them with the same strict
    validation, and each worker opens its own context on ``device``);
    ``None`` or 1 runs inline.  ``out_path`` additionally streams rows to a
    JSONL file as they arrive."""
    cells = list(cells)
    rows: List[Optional[Dict]] = [None] * len(cells)
    out = open(out_path, "w") if out_path else None

    def emit(i: int, row: Dict):
        rows[i] = row
        if out is not None:
            out.write(json.dumps(row, sort_keys=True, default=float) + "\n")
            out.flush()
        if progress:
            print(f"[{sum(r is not None for r in rows)}/{len(cells)}] "
                  f"{cells[i].name}: slo="
                  f"{row['metrics'].get('slo_attainment', 0.0):.4f}",
                  file=sys.stderr)

    try:
        if processes is not None and processes > 1 and len(cells) > 1:
            import multiprocessing as mp
            if any(c.engine.real_decode for c in cells) and \
                    resolve(device).type == "cuda":
                # one build for every worker: each only loads the library
                from repro_torch.kernels import build
                build.build()
            # no fork: a forked child cannot use the parent's CUDA context
            ctx = mp.get_context("spawn")
            with ctx.Pool(processes) as pool:
                payload = [json.dumps([c.to_json(), str(device)])
                           for c in cells]
                for i, row in enumerate(pool.imap(_run_cell_json, payload)):
                    emit(i, row)
        else:
            for i, cell in enumerate(cells):
                emit(i, run_cell(cell, device=device))
    finally:
        if out is not None:
            out.close()
    return rows  # type: ignore[return-value]


def pareto_frontier(rows: Sequence[Dict], *, x: str = "cost_usd",
                    y: str = "slo_attainment") -> List[Dict]:
    """Non-dominated sweep rows on (minimize ``metrics[x]``, maximize
    ``metrics[y]``), sorted by ``x`` ascending — the cost-vs-SLO frontier of
    an elastic sweep (docs/elastic.md).  A row survives iff no other row is
    at least as good on both axes and strictly better on one; rows missing
    either metric (e.g. cells run without elasticity, so no ``cost_usd``)
    are excluded.  Exact ties on both axes all survive, so the result is
    deterministic in the row set, not the row order."""
    pts = [r for r in rows
           if r is not None and r["metrics"].get(x) is not None
           and r["metrics"].get(y) is not None]
    front = []
    for r in pts:
        rx, ry = r["metrics"][x], r["metrics"][y]
        dominated = any(
            (o["metrics"][x] <= rx and o["metrics"][y] >= ry)
            and (o["metrics"][x] < rx or o["metrics"][y] > ry)
            for o in pts)
        if not dominated:
            front.append(r)
    return sorted(front, key=lambda r: (r["metrics"][x], -r["metrics"][y]))


def _parse_axis(pair: str) -> tuple:
    if "=" not in pair:
        raise ValueError(f"--grid expects PATH=JSON_LIST, got {pair!r}")
    path, _, raw = pair.partition("=")
    try:
        values = json.loads(raw)
    except json.JSONDecodeError as e:
        raise ValueError(
            f"--grid {path}: value must be a JSON list, got {raw!r}") from e
    if not isinstance(values, list) or not values:
        raise ValueError(f"--grid {path}: need a non-empty JSON list")
    return path, values


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sim.sweep",
        description="Grid/random sweeps over declarative fleet scenarios.")
    ap.add_argument("--scenario", metavar="NAME",
                    help="registered base scenario (see repro_torch.sim --list)")
    ap.add_argument("--spec", metavar="FILE",
                    help="base ScenarioSpec JSON file")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="fixed override applied to the base spec first")
    ap.add_argument("--grid", dest="grid", action="append", default=[],
                    metavar="PATH=JSON_LIST",
                    help="sweep axis, e.g. topology.num_devices=[100,400]")
    ap.add_argument("--random", type=int, default=0, metavar="N",
                    help="draw N random cells from the axes instead of the "
                         "full grid")
    ap.add_argument("--sweep-seed", type=int, default=0,
                    help="rng seed for --random cell draws")
    ap.add_argument("--out", metavar="FILE", required=True,
                    help="JSONL output path ({spec, metrics} per row)")
    ap.add_argument("--processes", type=int, default=1,
                    help="worker processes across cells (1 = inline)")
    ap.add_argument("--device", default="cuda",
                    help="device of the real-decode cells' models (default "
                         "cuda, the card; cpu runs the plain versions)")
    ap.add_argument("--frontier", metavar="FILE",
                    help="additionally write the cost-vs-SLO Pareto "
                         "frontier (non-dominated rows on cost_usd vs "
                         "slo_attainment) as JSONL")
    args = ap.parse_args(argv)

    if (args.scenario is None) == (args.spec is None):
        raise ValueError("pass exactly one of --scenario NAME or --spec FILE")
    if args.spec is not None:
        with open(args.spec) as f:
            base = ScenarioSpec.from_json(f.read())
    else:
        base = get_scenario(args.scenario)
    if args.overrides:
        from repro_torch.sim.cli import _parse_overrides
        base = apply_overrides(base, _parse_overrides(args.overrides))
    axes = dict(_parse_axis(p) for p in args.grid)
    if not axes:
        raise ValueError("pass at least one --grid PATH=JSON_LIST axis")
    cells = random_cells(base, axes, args.random, seed=args.sweep_seed) \
        if args.random else grid_cells(base, axes)
    rows = run_sweep(cells, out_path=args.out, processes=args.processes,
                     progress=True, device=args.device)
    print(f"{len(rows)} cells -> {args.out}")
    if args.frontier:
        front = pareto_frontier(rows)
        with open(args.frontier, "w") as f:
            for row in front:
                f.write(json.dumps(row, sort_keys=True, default=float)
                        + "\n")
        for row in front:
            m = row["metrics"]
            print(f"  frontier: cost_usd={m['cost_usd']:.4f} "
                  f"slo={m['slo_attainment']:.4f} "
                  f"reject_rate={m.get('reject_rate', 0.0):.4f}")
        print(f"{len(front)} non-dominated cells -> {args.frontier}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
