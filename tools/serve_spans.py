#!/usr/bin/env python3
"""Where a benchmark cell's device idle time goes, by the program's own ranges.

    python3 tools/serve_spans.py --workload <cell> --seed <n> --seconds <s> [--out FILE]

Runs one traced run of a cell of the port's benchmark (``portbench``), as
``portbench/run.py --trace 1`` does, and keeps the profiler's events.  Each
idle gap of the device inside the window is put down to what the host was
doing at its middle: first by the innermost of the benchmark's own ``pb:``
ranges (the labels of the result line's ``idle_gaps``), then, within each of
those, by the innermost range of either kind.  There the program's
``edgent:`` ranges (``repro_torch.obs.spans``) tell apart the engine's parts,
the model step outside its segments, each segment by its index (a segment
boundary is one of Edgent's exits), the program's kernel call sites, and the
benchmark's wrappers inside them.

Prints the result line, then one JSON object: the split (seconds, under
``idle_s``), the program's registry (host times and counts of every span,
the decode steps' layers, the requests' first-token times), and the number
of device events that carry a program range's name (there should be none).
``--out FILE`` also writes the object to FILE.  Needs a CUDA card.

The events come from the harness's own reduction (``trace.reduce``, which
this tool wraps for the one run, and which must be called once), and the
ranges are put down to gaps with the harness's ``trace.innermost``; only
the sweep that finds the gaps is the tool's.  Once the harness attributes
idle gaps by the ``edgent:`` ranges itself, this tool has no further use.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PB, EDGENT = "pb:", "edgent:"


def label(name: str, index: int, parent: str) -> str:
    """A range's label: the program's by its name (a segment by its index and
    the step around it), the benchmark's by its kind."""
    if name.startswith(EDGENT):
        what = name[len(EDGENT):]
        if what == "model.segment":
            return f"{parent} segment {index}"
        return what
    return "benchmark " + name[len(PB):].split(":")[0]


def ranges_of(events):
    """Host ranges of both kinds in time order, each with its label: (start,
    end, label)."""
    rs = sorted((s, e, n) for n, dev, s, e in events
                if not dev and (n.startswith(PB) or n.startswith(EDGENT)))
    out, stack, count = [], [], defaultdict(int)
    for s, e, n in rs:
        while stack and stack[-1][1] < s:
            stack.pop()
        step = next((x for x in reversed(stack)
                     if x[2] in (EDGENT + "model.prefill", EDGENT + "model.decode_step")), None)
        parent = step[2][len(EDGENT + "model."):] if step else "?"
        idx = 0
        if n == EDGENT + "model.segment" and step is not None:
            idx = count[step[:2]]
            count[step[:2]] += 1
        stack.append((s, e, n))
        out.append((s, e, label(n, idx, parent)))
    return out


def split(events, window: str):
    from portbench.harness import trace
    w0, w1 = next((s, e) for n, dev, s, e in events if n == window and not dev)
    # the device's idle gaps in the window, as the harness's reduction finds them
    gaps, end = [], w0
    for s, e in sorted((s, e) for n, dev, s, e in events if dev and e > w0 and s < w1
                       and not n.startswith((PB, EDGENT)) and trace.MARKER not in n):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    gaps += [(end, w1)] if w1 > end else []
    mids = [(a + b) // 2 for a, b in gaps]
    rs = ranges_of(events)
    by_prog = trace.innermost(rs, mids)
    bench = [r for r in rs if r[2].startswith("benchmark ")]
    by_bench = trace.innermost(bench, mids)
    table = defaultdict(lambda: defaultdict(float))
    for (a, b), pb, prog in zip(gaps, by_bench, by_prog):
        table[pb or "harness"][prog or "harness"] += (b - a) / 1e9
    return {k: dict(sorted(v.items(), key=lambda x: -x[1]))
            for k, v in sorted(table.items(), key=lambda x: -sum(x[1].values()))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench.harness import cellrun, spec, trace

    kept = {}
    reduce = trace.reduce

    def keep(prof, data, window):
        kept["events"], kept["window"] = trace._events(prof), window
        reduce(prof, data, window)

    trace.reduce = keep
    cell = spec.load_cell(args.workload, ROOT)
    out, _ = cellrun.run(cell, args.seed, args.seconds, True, T_START)
    print(json.dumps(out), flush=True)
    if "events" not in kept:
        raise SystemExit("the traced run did not reduce its trace through trace.reduce: "
                         "no events to split")
    from repro_torch.obs import spans
    reg = spans.REGISTRY.snapshot()
    events = kept["events"]
    res = {"device": torch.cuda.get_device_name(),
           "idle_s": split(events, kept["window"]),
           "program_ranges_on_device": sum(1 for n, dev, _, _ in events
                                           if dev and n.startswith(EDGENT)),
           "registry": reg}
    print(json.dumps(res), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
