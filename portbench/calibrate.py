#!/usr/bin/env python3
"""Readings that a cell's limits are set from, on the card, in one process.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <n> ... [--control-seeds <n> ...]

For each seed it runs the cell as ``run.py`` does, with a window of ``--seconds``
(long enough to serve the whole pool once), and prints the compared numbers the
program gives.  For each control seed it also runs the control on the same sampled
rows: the reference in float8 e4m3 matmuls put in the program's place, read as the
widest gap, in the float32 reference's logits, of the tokens it puts first.  The
last line is one JSON object: every reading, ``lower`` (the largest program gap)
and ``upper`` (the smallest control gap).  The benchmark's own runs do not run
this.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench.harness import cellrun, check, spec
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, ROOT)
    readings = []
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        keep = {}
        t = time.monotonic()
        out, _ = cellrun.run(cell, seed, args.seconds, False, t, keep=keep)
        r = {"seed": seed, **{k: v["value"] for k, v in out["checks"].items()},
             "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
        if seed in args.control_seeds:
            r["control_gap"] = check.control_gap(cell.config, keep["params"], keep["jobs"],
                                                 keep["ref"])
        r["seconds"] = time.monotonic() - t
        readings.append(r)
        print(json.dumps(r), flush=True)
        del keep, out
        gc.collect()
        torch.cuda.empty_cache()
    prog = [r["logit_gap"] for r in readings if r["seed"] in args.seeds]
    ctrl = [r["control_gap"] for r in readings if "control_gap" in r]
    print(json.dumps({"workload": cell.name, "readings": readings,
                      "lower": max(prog) if prog else None,
                      "upper": min(ctrl) if ctrl else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
