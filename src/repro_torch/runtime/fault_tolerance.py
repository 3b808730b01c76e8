"""Fault tolerance: checkpoint/restart orchestration + failure simulation.

At 1000+ node scale the relevant contract is: (a) any step may die; (b) the
job resumes from the last durable checkpoint with identical results; (c) the
blast radius of a slow/flaky worker is bounded (straggler mitigation).  This
module provides the host-side pieces; sharded-state save/restore lives in
``repro_torch.checkpointing``; the straggler knob is Edgent's own early-exit
demotion (core/early_exit.py).

A copy of ``src/repro/runtime/fault_tolerance.py`` but for one repair: a
cold restart (a failure before any checkpoint) starts again from the
initial state, where the reference keeps the state of the failed run and
only resets the step.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from repro_torch.checkpointing import CheckpointManager


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Deterministic failure schedule for tests: fail at given steps."""
    fail_at: tuple = ()
    fired: set = field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


@dataclass
class ResilientLoop:
    """Run a step function with checkpoint/restart.

    ``state`` is any pytree (params, opt state, data cursor).  On failure the
    loop restores the latest checkpoint and replays — the cluster-scale
    restart path, exercised in-process.
    """
    ckpt: CheckpointManager
    save_every: int = 50
    max_restarts: int = 10

    def run(self, state: Any, step_fn: Callable[[Any, int], Any],
            num_steps: int, start_step: int = 0,
            injector: Optional[FailureInjector] = None,
            on_restart: Optional[Callable[[int], None]] = None):
        restarts = 0
        step = start_step
        initial = state
        # resume if a checkpoint exists
        latest = self.ckpt.latest_step()
        if latest is not None and latest > step:
            state, step = self.ckpt.restore(state)
        while step < num_steps:
            try:
                if injector is not None:
                    injector.maybe_fail(step)
                state = step_fn(state, step)
                step += 1
                if step % self.save_every == 0 or step == num_steps:
                    self.ckpt.save(step, state)
            except SimulatedFailure:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                latest = self.ckpt.latest_step()
                if latest is None:
                    state, step = initial, start_step   # cold restart
                else:
                    state, step = self.ckpt.restore(state)
                if on_restart:
                    on_restart(step)
        self.ckpt.wait()
        return state, {"restarts": restarts, "final_step": step}


@dataclass
class Heartbeat:
    """Book-keeping for worker liveness (control-plane simulation)."""
    timeout_s: float = 10.0
    last: dict = field(default_factory=dict)

    def beat(self, worker: str, t: Optional[float] = None):
        self.last[worker] = t if t is not None else time.monotonic()

    def dead(self, now: Optional[float] = None):
        now = now if now is not None else time.monotonic()
        return [w for w, t in self.last.items() if now - t > self.timeout_s]
