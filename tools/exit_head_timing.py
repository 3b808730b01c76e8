#!/usr/bin/env python3
"""Time the port's exit-head kernel of one or more checkouts, on one CUDA
card, with ``chip_smoke.py``'s ``Timer``.

    python3 tools/exit_head_timing.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository and runs in a process of its
own, in the order given (parent, change, change, parent compares two trees
in one call).  In bf16 at the served shapes, rows x D x V (llama3.2-1b 4 x
2048 x 128256, llava-next-mistral-7b 2 x 4096 x 32000, llama4-scout 4 x
5120 x 202112, zamba2-2.7b 4 x 2560 x 32000), and over rows 1-65 at
llama3.2-1b's D and V, it prints the kernel's time queued behind the
timer's spin (``ms``), its time without the spin (``ms_unspun``) and the
wrapper's host time per call (``host_us``); at the served shapes also the
kernel's time when the L2 flush before each run reads the 256 MB buffer
instead of writing it (``ms_read_flush``: no dirty lines for the kernel to
write back), the library composite's time (``library_ms``,
``chip_smoke.exit_head_composite``) and the bound (``bound_ms``,
``chip_smoke.bound``).  One JSON line a root.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parents[1]
SHAPES = {"llama3.2-1b": (4, 2048, 128256), "llava-next-mistral-7b": (2, 4096, 32000),
          "llama4-scout-17b-a16e": (4, 5120, 202112), "zamba2-2.7b": (4, 2560, 32000)}
ROWS = (1, 2, 4, 7, 8, 16, 17, 64, 65)


def ms_read_flush(timer, fn) -> float:
    """``Timer.ms`` with the flush reading its buffer, not writing it."""
    buf = timer.flush
    timer.flush = SimpleNamespace(zero_=buf.sum)
    try:
        return timer.ms(fn)
    finally:
        timer.flush = buf


def time_root(root: Path) -> dict:
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(root / "src"))
    import torch

    import repro_torch.config as C
    from chip_smoke import Timer, bound, exit_head_composite
    from repro_torch.kernels import build
    from repro_torch.kernels.exit_head import ops as eh_ops

    build.library()
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(20)

    def randn(*shape, scale=1.0):
        x = torch.randn(shape, generator=gen, device="cuda") * scale
        return x.to(torch.bfloat16)

    def case(rows, D, V, served):
        h, emb = randn(1, rows, D), randn(V, D, scale=D ** -0.5)

        def f():
            return eh_ops.exit_confidence(h, emb)

        t = timer.kernel(f)
        if served:
            t["ms_read_flush"] = ms_read_flush(timer, f)
            t["library_ms"] = timer.ms(lambda: exit_head_composite(h.reshape(rows, D), emb))
            t["bound_ms"], t["bound_by"] = bound(2 * (rows * D + V * D) + 12 * rows,
                                                 2 * rows * V * D, torch.bfloat16, C)
        return t

    out = {"root": str(root), "flush_ms": timer.ms(timer.flush.zero_)}
    for name, (rows, D, V) in SHAPES.items():
        out[name] = case(rows, D, V, True)
    _, D, V = SHAPES["llama3.2-1b"]
    for rows in ROWS:
        out[f"rows {rows}"] = case(rows, D, V, False)
    return out


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available() or not argv:
        print("usage: exit_head_timing.py ROOT [ROOT ...], on a CUDA card", file=sys.stderr)
        return 2
    if len(argv) > 1:                       # one process a root: each imports its own package
        return max(subprocess.run([sys.executable, __file__, a]).returncode for a in argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(json.dumps(time_root(Path(argv[0]).resolve())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
