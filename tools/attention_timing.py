#!/usr/bin/env python3
"""Time the port's two attention kernels of one or more checkouts, on one
CUDA card, with ``chip_smoke.py``'s ``Timer``.

    python3 tools/attention_timing.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository and runs in a process of its
own, in the order given (parent, change, change, parent compares two trees
in one call).  For bf16 flash prefill at B4 S1000 and S12 and bf16 decode
attention at B4 T1017 length 1016 and T29 length 28, at llama3.2-1b's heads
(H32/8, hd 64), at hd 128 (H32/8) and at zamba2-2.7b's (H32/32, hd 80),
each head dim where the checkout's wrapper takes it, it prints
the kernel's time queued behind the timer's spin (``ms``), its time without
the spin (``ms_unspun``) and the wrapper's host time per call
(``host_us``), beside one SDPA call's time on the same inputs, and the
device time of the timer's L2 flush (``flush_ms``): without the spin, a
host slower than the flush to issue a launch has its excess timed.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def time_root(root: Path) -> dict:
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(root / "src"))
    import torch
    import torch.nn.functional as F

    from chip_smoke import Timer
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops

    build.library()
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(99)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    out = {"root": str(root), "flush_ms": timer.ms(timer.flush.zero_)}
    for hd, H, KV in ((64, 32, 8), (128, 32, 8), (80, 32, 32)):
        if hd not in fa_ops.HEAD_DIMS:
            continue
        for S in (1000, 12):
            q, k, v = randn(4, S, H, hd), randn(4, S, KV, hd), randn(4, S, KV, hd)
            qc, kc, vc = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            out[f"flash S{S} hd{hd}"] = dict(
                **timer.kernel(lambda: fa_ops.flash_attention(q, k, v)),
                sdpa_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                    qc, kc, vc, is_causal=True, enable_gqa=True)))
        for T in (1017, 29):
            ck, cv = randn(2, 4, T, KV, hd), randn(2, 4, T, KV, hd)
            q = randn(4, 1, H, hd)
            lengths = torch.full((4,), T - 1, dtype=torch.int32, device="cuda")
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, ck[1], cv[1]))
            mask = (torch.arange(T, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
            out[f"decode T{T} hd{hd}"] = dict(
                **timer.kernel(lambda: fa_ops.decode_attention(q, ck[1], cv[1], lengths)),
                sdpa_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)))
    return out


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available() or not argv:
        print("usage: attention_timing.py ROOT [ROOT ...], on a CUDA card", file=sys.stderr)
        return 2
    if len(argv) > 1:                       # one process a root: each imports its own package
        return max(subprocess.run([sys.executable, __file__, a]).returncode for a in argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(json.dumps(time_root(Path(argv[0]).resolve())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
