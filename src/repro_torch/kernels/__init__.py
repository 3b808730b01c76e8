"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each package holds ``ref.py`` (the plain PyTorch version, the counterpart of
the reference's ``ref.py``) and ``ops.py`` (the wrapper: the plain version
for a CPU tensor, the CUDA kernel from ``csrc/`` for a CUDA tensor, and a
plain-integer launch count).  :func:`launch_counts` and
:func:`reset_launch_counts` read and clear every wrapper's count.
"""
from __future__ import annotations

from typing import Dict


def _counters():
    from repro_torch.kernels.exit_head import ops as eh_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    return (fa_ops.LAUNCHES, eh_ops.LAUNCHES)


def launch_counts() -> Dict[str, int]:
    out: Dict[str, int] = {}
    for c in _counters():
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _counters():
        for k in c:
            c[k] = 0
