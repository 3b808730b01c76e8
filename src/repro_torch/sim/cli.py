"""``python -m repro_torch.sim`` — run declarative scenarios from the shell
(the counterpart of ``python -m repro.sim``).

    python -m repro_torch.sim --list
    python -m repro_torch.sim --scenario smoke-lm
    python -m repro_torch.sim --scenario smoke-mobility --json
    python -m repro_torch.sim --scenario smoke-lm --set router.name=joint \\
                        --set topology.num_devices=100
    python -m repro_torch.sim --spec my_scenario.json --json
    python -m repro_torch.sim --scenario smoke-mobility --trace trace.json

``--set key=value`` takes dotted spec paths (values parsed as JSON, falling
back to bare strings), so a sweep is a shell loop over spec edits — no
bespoke argparse per experiment.  ``--json`` emits ``{scenario, spec,
metrics, events}`` on stdout for CI artifacts and downstream tooling; the
default output is a human-readable metrics listing.  ``--trace`` /
``--timeline`` attach the ``repro_torch.obs`` observers and write their artifacts
after the run (summaries are bit-identical either way —
docs/observability.md).  ``--device`` (default ``cuda``, the card) is where
a real-decode spec runs its model; ``--device cpu`` runs the kernels' plain
versions on the CPU.

    python -m repro_torch.sim --scenario smoke-lm \\
        --set engine.real_decode=true --device cpu --json
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

from repro_torch.sim.build import Simulation
from repro_torch.sim.registry import get_scenario, list_scenarios
from repro_torch.sim.spec import ScenarioSpec, apply_overrides

__all__ = ["main"]


def _parse_overrides(pairs: List[str]) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(f"--set expects key=value, got {pair!r}")
        key, _, raw = pair.partition("=")
        try:
            out[key] = json.loads(raw)
        except json.JSONDecodeError:
            out[key] = raw              # bare string (e.g. router names)
    return out


def _resolve_spec(args) -> ScenarioSpec:
    if (args.scenario is None) == (args.spec is None):
        raise ValueError("pass exactly one of --scenario NAME or "
                         "--spec FILE (--list shows the registry)")
    if args.spec is not None:
        with open(args.spec) as f:
            return ScenarioSpec.from_json(f.read())
    return get_scenario(args.scenario)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sim",
        description="Run a declarative fleet scenario (docs/api.md).",
        epilog="For grid/random sweeps over scenarios (parallel cells, "
               "JSONL output) use `python -m repro_torch.sim.sweep`.")
    ap.add_argument("--scenario", metavar="NAME",
                    help="registered scenario name (see --list)")
    ap.add_argument("--spec", metavar="FILE",
                    help="path to a ScenarioSpec JSON file")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="dotted spec override, e.g. topology.num_devices=100"
                         " (repeatable)")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    ap.add_argument("--json", action="store_true",
                    help="emit {scenario, spec, metrics, events} as JSON")
    ap.add_argument("--trace", metavar="FILE",
                    help="write a Chrome/Perfetto trace-event JSON of the "
                         "run (view: ui.perfetto.dev, or `python -m "
                         "repro_torch.obs report FILE`)")
    ap.add_argument("--timeline", metavar="FILE",
                    help="write the per-edge gauge timeline as JSONL "
                         "(render: `python -m repro_torch.obs report FILE`)")
    ap.add_argument("--device", default="cuda",
                    help="device of a real-decode spec's model (default "
                         "cuda, the card; cpu runs the plain versions)")
    args = ap.parse_args(argv)

    if args.list:
        for spec in list_scenarios():
            print(f"{spec.name:>16}  {spec.description}")
        return 0

    spec = _resolve_spec(args)
    overrides = _parse_overrides(args.overrides)
    if args.trace:
        overrides["engine.trace"] = args.trace
    if args.timeline:
        overrides["engine.timeline"] = args.timeline
    if overrides:
        spec = apply_overrides(spec, overrides)

    # events_processed lives OUTSIDE summary(): observers add "obs" events,
    # so it may differ observers-on vs off while summaries stay identical
    if spec.topology.shards > 1:
        # sharded geography: tiles run and merge (no single live engine);
        # the merged info dict carries the fleet-wide event counts
        from repro_torch.sim.shard import run_sharded_info
        m, info = run_sharded_info(spec)
        metrics = m.summary()
        events = {"processed": info["events_processed"],
                  "by_kind": info["event_counts"]}
    else:
        sim = Simulation(spec, device=args.device)
        metrics = sim.run().summary()
        engine = sim.scenario.engine
        events = {"processed": engine.events_processed,
                  "by_kind": dict(sorted(engine.event_counts.items()))}
    if args.json:
        print(json.dumps({"scenario": spec.name, "spec": spec.to_dict(),
                          "metrics": metrics, "events": events},
                         indent=2, default=float))
        return 0
    topo = spec.topology
    print(f"scenario {spec.name!r}: {topo.num_devices} devices x "
          f"{topo.num_edges} edges ({topo.kind}), router={spec.router.name}, "
          f"seed={spec.seed}")
    for key, value in metrics.items():
        print(f"  {key:>20}: {value}")
    kinds = ", ".join(f"{k}={v}" for k, v in sorted(events["by_kind"].items()))
    print(f"  {'events':>20}: {events['processed']} ({kinds})")
    if args.trace:
        print(f"  {'trace':>20}: {args.trace}")
    if args.timeline:
        print(f"  {'timeline':>20}: {args.timeline}")
    return 0
