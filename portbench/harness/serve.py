"""The system under test, built the way ``repro_torch.launch.serve`` builds it.

``ServingEngine`` of the full configuration, its ``EdgentPlanner`` on roofline
tiers for the edge and the device, a ``Link`` over the benchmark's bandwidth
trace, static planning, deadline demotion, the port's kernels (``impl="kernel"``).
:class:`CallLog` wraps the engine's public calls to keep what the check needs:
the prompts each prefill received, the exit each decode step ran, the tokens the
exit head picked; it keeps references and reads nothing back inside the window.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from portbench.harness import traffic, weights

#: sizes the configuration file states, as the port's ``ModelConfig`` names them
SIZES = ("family", "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
         "d_ff", "vocab_size", "num_exits", "norm_eps")
HYBRID_SIZES = ("ssm_state", "hybrid_attn_period")
#: settings the configuration file gives the port's model, whatever its own say
SETTINGS = ("rope_theta",)


def port_config(cfg: dict, smoke: bool = False):
    """The port's ``ModelConfig`` of ``cfg["arch"]`` with the file's ``SETTINGS``;
    the full one must state the sizes of the configuration file (``smoke``: the
    port's CPU-sized variant)."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config
    pc = get_smoke_config(cfg["arch"]) if smoke else get_config(cfg["arch"])
    pc = dataclasses.replace(pc, **{k: cfg[k] for k in SETTINGS})
    if not smoke:
        keys = SIZES + (HYBRID_SIZES if cfg["family"] == "hybrid" else ())
        got = {k: getattr(pc, k) if k != "head_dim" else pc.hd for k in keys}
        want = {k: cfg[k] for k in keys}
        if got != want:
            raise SystemExit(f"the port's {cfg['arch']} is not the configuration file's: "
                             f"{ {k: (got[k], want[k]) for k in keys if got[k] != want[k]} }")
    return pc


def smoke_sizes(cfg: dict) -> dict:
    """The sizes of the port's CPU-sized variant of ``cfg["arch"]`` (tests only)."""
    from repro_torch.configs import get_smoke_config
    pc = get_smoke_config(cfg["arch"])
    keys = SIZES + (HYBRID_SIZES if cfg["family"] == "hybrid" else ())
    return {k: pc.hd if k == "head_dim" else getattr(pc, k) for k in keys}


@dataclass
class Engine:
    engine: object
    model: object
    params: dict
    trace: np.ndarray


def build(cfg: dict, mix: dict, seed: int, device, dtype, smoke: bool = False,
          timings: Optional[dict] = None) -> Engine:
    from repro_torch.core import EdgentPlanner, lm_graph
    from repro_torch.core.latency_model import RooflineLatencyModel
    from repro_torch.models import Model
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.tiers import Link

    t0 = time.monotonic()
    pcfg = port_config(cfg, smoke)
    model = Model(pcfg)
    params = weights.make(model.abstract_params(dtype), seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    if timings is not None:
        timings["weights_s"] = time.monotonic() - t0
    dep = cfg["deployment"]
    graph = lm_graph(pcfg, batch=mix["batch"], seq=1)
    planner = EdgentPlanner(graph, latency_req_s=mix["planner_slo_s"]).with_models(
        RooflineLatencyModel(chips=dep["edge_chips"], efficiency=dep["efficiency"]),
        RooflineLatencyModel(chips=dep["device_chips"], efficiency=dep["efficiency"]))
    trace = traffic.bandwidth(mix, seed)
    link = Link(trace_bps=trace)
    eng = ServingEngine(model, params, graph, planner, link, batch_size=mix["batch"],
                        dtype=dtype, dynamic=False, demote_on_deadline=True, impl="kernel")
    return Engine(eng, model, params, trace)


def to_program(batch: traffic.Batch):
    from repro_torch.serving import Request
    return [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                    slo_s=r.slo_s) for r in batch.requests]


@dataclass
class Call:
    """One ``serve()`` call: its batch, host times and what the program did."""
    batch: traffic.Batch
    link_idx: int
    t0: float = 0.0
    t1: float = 0.0
    prompts: list = field(default_factory=list)     # tensors the prefill received
    exits: list = field(default_factory=list)       # exit_point a decode step received
    picks: list = field(default_factory=list)       # [B, 1] tensors next_token returned
    served: dict = field(default_factory=dict)

    @property
    def wall_s(self) -> float:
        return self.t1 - self.t0


class CallLog:
    """Wraps ``model.prefill``, ``model.decode_step`` and the stepper's
    ``next_token`` (instance attributes, which the engine looks up at each call)."""

    def __init__(self, eng: Engine):
        self.eng = eng
        self.calls: List[Call] = []
        self.current: Optional[Call] = None
        self.steps = 0                                   # decode steps so far
        model, stepper = eng.model, eng.engine.stepper
        prefill, decode, pick = model.prefill, model.decode_step, stepper.next_token

        def rec_prefill(params, tokens, cache, **kw):
            self.current.prompts.append(tokens)
            return prefill(params, tokens, cache, **kw)

        def rec_decode(params, cache, tokens, pos, *, exit_point=None, **kw):
            self.current.exits.append(exit_point)
            return decode(params, cache, tokens, pos, exit_point=exit_point, **kw)

        def rec_pick(params, h):
            tok = pick(params, h)
            self.current.picks.append(tok)
            return tok

        model.prefill, model.decode_step, stepper.next_token = rec_prefill, rec_decode, rec_pick

    def serve(self, batch: traffic.Batch) -> Call:
        call = self.current = Call(batch, self.steps)
        reqs = to_program(batch)
        call.t0 = time.monotonic()
        stats = self.eng.engine.serve(reqs)
        call.t1 = time.monotonic()
        call.served = stats.tokens
        self.steps += batch.steps
        self.current = None
        return call


def served_batch(call: Call, n_seg: int):
    """The check's view of a call, on the host."""
    from portbench.harness.check import Served
    rows = np.concatenate([p.cpu().numpy() for p in call.prompts], axis=0) \
        if call.prompts else np.zeros((0, 0), np.int32)
    picks = np.stack([p[:, 0].cpu().numpy() for p in call.picks]) if call.picks \
        else np.zeros((0, len(call.batch.requests)), np.int64)
    exits = [n_seg if e is None else e + 1 for e in call.exits]
    return Served(call.batch.requests, call.link_idx, rows, exits, picks, call.served)
