#!/usr/bin/env python3
"""Where a served model's decode step spends its time, on one CUDA card.

    python3 tools/serve_profile.py [ARCH ...] [--steps N] [--out FILE]

For each architecture (default: zamba2-2.7b) it builds the full-size model
in bfloat16 with random weights from ``torch.Generator`` seed 0, prefills a
batch of 4 twelve-token prompts through the port's kernels, and then runs
full-depth decode steps as ``ServingEngine`` does (decode, exit-head token,
a host read of the tokens).  It reports:

* ``wall_ms``: the host-clock time of one step, CUDA-synchronised (median
  of ``--steps`` steps, no profiler attached);
* ``host``: the host time a step spends inside the model's blocks, its
  attention and FFN, and each of the port's kernel wrappers, inclusive,
  with calls a step and microseconds a call (the same steps);
* ``device_ms``: the device time of one step's kernels, from
  ``torch.profiler`` over ``--steps`` more steps, and ``idle_share``, one
  minus its ratio to ``wall_ms``;
* ``kernels``: device kernels a step; ``host_ops``: the operators a step
  calls from Python; the operators with the most host time
  (``top_host_ops``, profiled) and the kernels with the most device time
  (``top_device_kernels``), per step.

A summary goes to standard output, then the whole result as one JSON line,
which ``--out FILE`` also writes to FILE.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BATCH, PROMPT = 4, 12


class HostClock:
    """Host time inside named functions of the model, inclusive, on the
    host's clock: each is wrapped where the model looks it up (its
    module's attribute) and unwrapped on exit."""

    def __init__(self, targets):
        self.targets, self.ms, self.calls, self._saved = targets, {}, {}, {}

    def __enter__(self):
        for label, (module, name) in self.targets.items():
            inner = self._saved[label] = getattr(module, name)
            self.ms[label], self.calls[label] = 0.0, 0

            def timed(*a, _inner=inner, _label=label, **k):
                t0 = time.perf_counter()
                try:
                    return _inner(*a, **k)
                finally:
                    self.ms[_label] += (time.perf_counter() - t0) * 1e3
                    self.calls[_label] += 1
            setattr(module, name, timed)
        return self

    def __exit__(self, *exc):
        for label, (module, name) in self.targets.items():
            setattr(module, name, self._saved[label])


def profile_arch(arch: str, steps: int) -> dict:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels.exit_head import ops as eh_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssm_scan import ops as ss_ops
    from repro_torch.models import Model
    from repro_torch.models import layers, mamba2, rwkv6

    cfg = get_config(arch)
    model = Model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init_params(gen, dtype=torch.bfloat16, device="cuda")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (BATCH, PROMPT))
    n_steps = 2 + 2 * steps
    cache = model.init_cache(BATCH, PROMPT + n_steps + 1, dtype=torch.bfloat16,
                             device="cuda")
    h, cache = model.prefill(params, torch.from_numpy(prompt.astype(np.int32)).cuda(), cache)
    state = {"cache": cache, "pos": PROMPT,
             "tok": eh_ops.exit_confidence(h, params["embed"])["token"][:, -1:]}

    def step():
        h, state["cache"] = model.decode_step(params, state["cache"], state["tok"],
                                              state["pos"])[:2]
        state["tok"] = eh_ops.exit_confidence(h, params["embed"])["token"][:, -1:]
        state["tok"][:, 0].tolist()              # the engine's host read of the tokens
        state["pos"] += 1

    for _ in range(2):                           # warm-up
        step()
    torch.cuda.synchronize()
    # the blocks and the kernel wrappers, timed on the host (inclusive: a
    # block's time holds its wrapper's)
    targets = {"mamba2 block": (mamba2, "block"), "rwkv6 block": (rwkv6, "block"),
               "attention": (layers, "attention"), "ffn": (layers, "ffn"),
               "wrapper flash_attention": (fa_ops, "flash_attention"),
               "wrapper decode_attention": (fa_ops, "decode_attention"),
               "wrapper ssm_scan": (ss_ops, "ssm_scan"),
               "wrapper exit_confidence": (eh_ops, "exit_confidence")}
    walls = []
    with HostClock(targets) as clock:
        for _ in range(steps):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    host = {label: {"ms_per_step": clock.ms[label] / steps,
                    "calls_per_step": clock.calls[label] / steps,
                    "us_per_call": clock.ms[label] * 1e3 / clock.calls[label]}
            for label in targets if clock.calls[label]}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # device kernels only: CPU operators carry their kernels' time as well
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation and e.self_device_time_total > 0]
    aten = [e for e in events if e.device_type == DeviceType.CPU
            and e.key.startswith("aten::")]
    # the operators the model's Python calls: aten events not inside another
    top_level = [e for e in prof.events() if e.name.startswith("aten::")
                 and (e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top_host = sorted(aten, key=lambda e: -e.self_cpu_time_total)[:12]
    top_dev = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {
        "arch": arch, "batch": BATCH, "prompt": PROMPT, "steps": steps,
        "wall_ms": wall, "wall_ms_all": walls, "device_ms": device_ms,
        "idle_share": 1.0 - device_ms / wall,
        "kernels": sum(e.count for e in kernels) / steps,
        "host_ops": len(top_level) / steps,
        "host": host,
        "top_host_ops": [(e.key, e.self_cpu_time_total / 1e3 / steps, e.count / steps)
                         for e in top_host],
        "top_device_kernels": [(e.key[:80], e.self_device_time_total / 1e3 / steps,
                                e.count / steps) for e in top_dev],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="*", default=["zamba2-2.7b"])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    build.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    results = {"card": card, "torch": torch.__version__, "models": []}
    for arch in args.archs:
        r = profile_arch(arch, args.steps)
        results["models"].append(r)
        print(f"{arch}: step {r['wall_ms']:.2f} ms wall, {r['device_ms']:.3f} ms of "
              f"kernels on the device (idle share {r['idle_share']:.3f}), {r['kernels']:.0f} "
              f"kernels and {r['host_ops']:.0f} operators called from Python a step",
              flush=True)
        print(f"  host time by function (inclusive): {r['host']}")
        print(f"  top host ops (name, ms a step, calls a step): {r['top_host_ops']}")
        print(f"  top device kernels (name, ms a step, calls a step): {r['top_device_kernels']}")
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps(results))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
