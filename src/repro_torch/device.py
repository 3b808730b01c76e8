"""Device selection for the port's entry points.

Entry points default to ``"cuda"`` and raise when no GPU is present: the
port never moves to the CPU on its own.  Callers that mean the CPU (the
tests) ask for it.
"""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA GPU is available "
                           "(pass device='cpu' to run the plain versions)")
    return dev
