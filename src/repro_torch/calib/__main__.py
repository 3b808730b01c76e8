"""CLI for the calibration loop: ``python -m repro_torch.calib <cmd>``.

    # measure: time real layers and kernels into a CalibrationTable JSON
    # (on the card; --device cpu runs the plain versions on the CPU)
    python -m repro_torch.calib measure --smoke --out table.json        # alexnet
    python -m repro_torch.calib measure --arch llama3.2-1b --device cpu --out table.json
    python -m repro_torch.calib measure --scenario smoke-lm --device cpu --out table.json

    # fit: per-layer-type regressions from a table
    python -m repro_torch.calib fit --table table.json --out fitted.json

    # validate: analytic vs calibrated error report for a scenario
    python -m repro_torch.calib validate --scenario smoke-lm --out report.json
"""
from __future__ import annotations

import argparse
import json
import sys


def _ints(s: str):
    return tuple(int(x) for x in s.split(",") if x)


def _cmd_measure(args) -> int:
    from repro_torch.calib.measure import measure_alexnet, measure_lm
    if args.smoke:
        table = measure_alexnet(reps=args.reps, device=args.device)
    else:
        spec = None
        if args.scenario:
            from repro_torch.sim import get_scenario
            spec = get_scenario(args.scenario).planner
        table = measure_lm(spec, arch=args.arch, batches=_ints(args.batches),
                           seqs=_ints(args.seqs), reps=args.reps,
                           decode_path=args.decode_path, device=args.device)
    if args.out:
        table.save(args.out)
        print(f"wrote {len(table.samples)} samples for {table.arch} "
              f"-> {args.out}")
    else:
        print(table.to_json())
    return 0


def _cmd_fit(args) -> int:
    from repro_torch.calib.fit import fit_table
    from repro_torch.calib.table import CalibrationTable
    table = CalibrationTable.load(args.table)
    fitted = fit_table(table)
    if args.out:
        fitted.save(args.out)
        print(f"fitted {sorted(fitted.theta)} from {len(table.samples)} "
              f"samples -> {args.out}")
    for kind in sorted(fitted.theta):
        print(f"  {kind:8s} r2={fitted.r2.get(kind, float('nan')):.4f} "
              f"theta={[round(t, 9) for t in fitted.theta[kind]]}")
    if not args.out:
        print(fitted.to_json())
    return 0


def _cmd_validate(args) -> int:
    from repro_torch.calib.table import CalibrationTable
    from repro_torch.calib.validate import validate_scenario
    table = CalibrationTable.load(args.table) if args.table else None
    report = validate_scenario(
        args.scenario, table=table, bw_points=args.bw_points,
        run_summaries=not args.no_summaries, reps=args.reps,
        device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
    pd = report["plan_divergence"]
    print(f"scenario={report['scenario']} arch={report['arch']} "
          f"scale={report['scale']:.3e}")
    print(f"per-exit   bias={report['bias_s']:+.3e}s "
          f"mape={100 * report['mape']:.2f}%")
    print(f"per-layer  bias={report['per_layer_bias_s']:+.3e}s "
          f"mape={100 * report['per_layer_mape']:.2f}%")
    print(f"plan divergence: {pd['diverged']}/{pd['points']} "
          f"({100 * pd['rate']:.1f}%) over the bandwidth grid")
    if report["summaries"] is not None:
        print("model-only summaries identical:",
              report["summaries"]["identical"])
    if args.out:
        print(f"report -> {args.out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.calib",
        description="measure -> fit -> validate latency-model calibration "
                    "(docs/calibration.md)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("measure", help="time real kernels into a table")
    m.add_argument("--smoke", action="store_true",
                   help="branchy-alexnet per-layer profile (tiny, CI leg)")
    m.add_argument("--arch", default=None,
                   help="smoke LM arch (default: the PlannerSpec default)")
    m.add_argument("--scenario", default=None,
                   help="take the PlannerSpec from this registered scenario")
    m.add_argument("--batches", default="1,2,4",
                   help="comma-separated batch sizes (LM decode sweep)")
    m.add_argument("--seqs", default="8",
                   help="comma-separated prompt lengths (LM sweep)")
    m.add_argument("--reps", type=int, default=5, help="median-of-k repeats")
    m.add_argument("--decode-path", default="batched",
                   choices=("batched", "arena"), dest="decode_path",
                   help="which B>1 decode path the LM samples time: the "
                        "batched groups or the slot-resident "
                        "arena calls (docs/performance.md)")
    m.add_argument("--device", default="cuda",
                   help="device to measure on (default cuda; cpu runs the "
                        "kernels' plain versions)")
    m.add_argument("--out", default=None, help="table JSON path")
    m.set_defaults(fn=_cmd_measure)

    f = sub.add_parser("fit", help="fit per-layer-type regressions")
    f.add_argument("--table", required=True, help="measured table JSON")
    f.add_argument("--out", default=None, help="fitted-model JSON path")
    f.set_defaults(fn=_cmd_fit)

    v = sub.add_parser("validate",
                       help="analytic-vs-calibrated report for a scenario")
    v.add_argument("--scenario", default="smoke-lm",
                   help="registered scenario name (default smoke-lm)")
    v.add_argument("--table", default=None,
                   help="measured table JSON (default: measure in place)")
    v.add_argument("--bw-points", type=int, default=25,
                   help="bandwidth grid size for plan divergence")
    v.add_argument("--reps", type=int, default=3,
                   help="median-of-k repeats for in-place measurement")
    v.add_argument("--device", default="cuda",
                   help="device of the in-place measurement (default cuda)")
    v.add_argument("--no-summaries", action="store_true",
                   help="skip the two model-only fleet runs")
    v.add_argument("--out", default=None, help="report JSON path")
    v.set_defaults(fn=_cmd_validate)

    args = ap.parse_args(argv)
    if args.cmd == "measure" and args.arch and args.scenario:
        ap.error("--arch and --scenario are mutually exclusive")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
