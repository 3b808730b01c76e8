#!/usr/bin/env python3
"""Time the port's SSM scan kernel of one or more checkouts, on one CUDA card,
with ``chip_smoke.py``'s ``Timer``.

    python3 tools/scan_timing.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository and runs in a process of its
own, in the order given (parent, change, change, parent compares two trees
in one call).  At rwkv6-3b's shapes in bf16 (B4 H40 64 x 64: the prefill at
S 1000 and S 12, decode at S 1, from a non-zero state) and zamba2-2.7b's
Mamba-2 shapes (B4 S1000 H80, B and C broadcast over heads, the decay over
channels, as ``mamba2.block`` passes them) it prints the kernel's time
queued behind the timer's spin (``ms``), its time without the spin
(``ms_unspun``) and the wrapper's host time per call (``host_us``), and the
device time of the timer's L2 flush (``flush_ms``).
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
B, H, HM, D = 4, 40, 80, 64


def time_root(root: Path) -> dict:
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(root / "src"))
    import torch

    from chip_smoke import Timer
    from repro_torch.kernels import build
    from repro_torch.kernels.ssm_scan import ops as ss_ops

    build.library()
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(99)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        x = torch.randn(shape, generator=gen, device="cuda") * scale
        return x.to(dtype)

    def decay(*shape):
        return -torch.exp(randn(*shape, scale=0.5))

    bf = torch.bfloat16
    out = {"root": str(root), "flush_ms": timer.ms(timer.flush.zero_)}
    for S in (1000, 12, 1):
        args = (randn(B, S, H, D, dtype=bf), randn(B, S, H, D, dtype=bf),
                randn(B, S, H, D, dtype=bf), decay(B, S, H, D),
                randn(B, H, D, D, scale=0.1), randn(H, D, scale=0.1))
        out[f"rwkv S{S}"] = timer.kernel(lambda: ss_ops.ssm_scan(*args))
    S = 1000
    cc, bc = randn(B, S, D, dtype=bf), randn(B, S, D, dtype=bf)
    args = (cc[:, :, None].expand(B, S, HM, D), bc[:, :, None].expand(B, S, HM, D),
            randn(B, S, HM, D, dtype=bf), decay(B, S, HM)[..., None].expand(B, S, HM, D),
            randn(B, HM, D, D, scale=0.1))
    out["mamba2 S1000"] = timer.kernel(lambda: ss_ops.ssm_scan(*args))
    return out


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available() or not argv:
        print("usage: scan_timing.py ROOT [ROOT ...], on a CUDA card", file=sys.stderr)
        return 2
    if len(argv) > 1:                       # one process a root: each imports its own package
        return max(subprocess.run([sys.executable, __file__, a]).returncode for a in argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(json.dumps(time_root(Path(argv[0]).resolve())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
