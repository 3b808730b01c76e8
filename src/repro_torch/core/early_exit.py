"""Early-exit (right-sizing) policies.

The paper's knob is *plan-selected*: the runtime optimizer fixes the exit
point per bandwidth state.  Two beyond-paper policies are provided for the
LM serving engine:

* entropy/confidence exit — per-token exit when the exit head is confident
  (uses the fused exit-head kernel, ``kernels/csrc/exit_head.cu``, at scale);
* deadline demotion — straggler mitigation: when a microbatch is behind its
  deadline, demote it to an earlier exit (the paper's accuracy-latency
  tradeoff used as a rescue).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class StaticExitPolicy:
    """Paper semantics: exit point fixed by the plan (1-based)."""
    exit_point: int

    def select(self, confidences=None, **_) -> int:
        return self.exit_point


@dataclass
class ConfidenceExitPolicy:
    """Exit at the first head whose max-softmax-prob exceeds ``threshold``
    (BranchyNet's inference rule), else run to the end."""
    threshold: float = 0.9
    num_exits: int = 5

    def select(self, confidences, **_) -> int:
        for i, c in enumerate(confidences):
            if float(np.mean(c)) >= self.threshold:
                return i + 1
        return self.num_exits


@dataclass
class DeadlineDemotionPolicy:
    """Straggler mitigation: given remaining budget and per-exit predicted
    latency, pick the deepest exit that still meets the deadline."""
    exit_latencies_s: list            # predicted latency per exit point
    floor_exit: int = 1

    def select(self, remaining_s: float, **_) -> int:
        best = self.floor_exit
        for i, t in enumerate(self.exit_latencies_s, start=1):
            if t <= remaining_s:
                best = i
        return best
