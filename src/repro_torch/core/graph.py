"""Inference graph abstraction — what the Edgent planner operates on.

A model is presented to the planner as a set of *branches* (one per exit
point, paper Fig. 4): branch ``i`` is an ordered list of :class:`GraphLayer`,
each carrying its Table-I regression features, its output size in bytes, and
an executable closure.  Both the branchy AlexNet (layer granularity) and the
LM architectures (transformer-segment granularity) lower to this form, which
is exactly the structure Algorithm 1 searches over.

A layer's ``run`` closure is a plain torch callable ``(params, x) -> x``
that computes on the device of its input tensor.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


@dataclass
class GraphLayer:
    name: str
    kind: str                      # Table-I type, or "block" for LM segments
    features: Dict[str, float]    # regression features
    out_bytes: int                 # activation size shipped if we cut *after* this layer
    flops: float = 0.0             # analytic FLOPs (roofline latency model)
    bytes_moved: float = 0.0       # analytic HBM traffic
    run: Optional[Callable] = None  # (params, x) -> x
    state_bytes: int = 0           # recurrent state that must ship with a cut here


@dataclass
class InferenceGraph:
    """All branches of a multi-exit model."""
    name: str
    branches: List[List[GraphLayer]]     # index i -> exit point i+1 (paper: 1-based)
    accuracy: List[float]                # measured accuracy per exit point
    input_bytes: int                     # the `Input` term of Algorithm 1
    result_bytes: int = 64               # final result return size

    @property
    def num_exits(self) -> int:
        return len(self.branches)

    def cut_bytes(self, exit_idx: int, p: int) -> int:
        """Bytes shipped when the first ``p`` layers of branch ``exit_idx``
        (1-based) run on the edge: the activation after layer p plus any
        recurrent state (DESIGN.md §4, rwkv/zamba)."""
        branch = self.branches[exit_idx - 1]
        if p <= 0:
            return 0
        if p >= len(branch):
            return self.result_bytes
        lay = branch[p - 1]
        return lay.out_bytes + lay.state_bytes


def alexnet_graph(net, accuracy: Optional[Sequence[float]] = None,
                  batch: int = 1, dtype_bytes: int = 4) -> InferenceGraph:
    """Lower a BranchyAlexNet to an InferenceGraph."""
    from repro_torch.models.alexnet import layer_features

    branches = []
    for i in range(1, net.num_exits + 1):
        layers = []
        shapes = net.branch_shapes(i)
        for spec, (in_shape, out_shape) in zip(net.branch_layers(i), shapes):
            layers.append(GraphLayer(
                name=spec.name,
                kind=spec.kind,
                features=layer_features(spec, in_shape),
                out_bytes=int(np.prod(out_shape)) * batch * dtype_bytes,
                run=(lambda spec: lambda params, x: _apply(net, spec, params, x))(spec),
            ))
        branches.append(layers)
    img = net.cfg.image_size
    acc = list(accuracy) if accuracy is not None else [0.5 + 0.08 * i for i in range(net.num_exits)]
    return InferenceGraph(
        name=net.cfg.name,
        branches=branches,
        accuracy=acc,
        input_bytes=img * img * net.cfg.channels * batch * dtype_bytes,
        result_bytes=net.cfg.num_classes * batch * dtype_bytes,
    )


def _apply(net, spec, params, x):
    from repro_torch.models.alexnet import apply_layer
    return apply_layer(spec, params.get(spec.name, {}), x)


def lm_graph(cfg, accuracy: Optional[Sequence[float]] = None,
             batch: int = 1, seq: int = 1, dtype_bytes: int = 2) -> InferenceGraph:
    """Lower an LM ModelConfig to an InferenceGraph at *segment* granularity
    (a cut between segments == a pipeline cut across the pod boundary).

    Exit point i (1-based) = run segments [0, i]; branch i's layer list is
    those segments.  Used by the datacenter-scale planner; per-layer FLOPs /
    bytes are analytic (roofline latency model feeds on them).
    """
    from repro_torch.models.api import Model

    model = Model(cfg)
    segs = model.segment_lengths()
    d = cfg.d_model
    act_bytes = batch * seq * d * dtype_bytes

    def seg_layer(si: int, n_units: int) -> GraphLayer:
        flops = _segment_flops(cfg, n_units, batch, seq)
        # the recurrent state that ships with a cut after this segment
        state = 0
        if cfg.family == "ssm":
            state = n_units * batch * cfg.num_heads * cfg.hd * cfg.hd * 4
        elif cfg.family == "hybrid":
            from repro_torch.models import mamba2 as M2
            state = n_units * batch * M2.n_heads(cfg) * cfg.ssm_state * M2.DH * 4
        return GraphLayer(
            name=f"seg{si}", kind="block",
            features={"in_size": float(act_bytes), "flops": flops},
            out_bytes=act_bytes, flops=flops,
            bytes_moved=_segment_param_bytes(cfg, n_units, dtype_bytes),
            state_bytes=state,
        )

    layers = [seg_layer(si, n) for si, n in enumerate(segs)]
    # exit head cost appended per branch
    branches = []
    for i in range(1, len(segs) + 1):
        b = list(layers[:i])
        head_flops = 2.0 * batch * seq * d * cfg.vocab_size
        b.append(GraphLayer(name=f"exit{i}", kind="fc",
                            features={"in_size": float(act_bytes),
                                      "out_size": float(batch * seq * cfg.vocab_size * dtype_bytes)},
                            out_bytes=batch * seq * 8,  # sampled token + conf
                            flops=head_flops,
                            bytes_moved=cfg.vocab_size * d * dtype_bytes))
        branches.append(b)
    acc = list(accuracy) if accuracy is not None else \
        [0.55 + 0.35 * (i + 1) / len(segs) for i in range(len(segs))]
    return InferenceGraph(
        name=cfg.name, branches=branches, accuracy=acc,
        input_bytes=batch * seq * 4, result_bytes=batch * 8,
    )


def _segment_flops(cfg, n_units, batch, seq) -> float:
    """6*params_active per token forward? No — forward-only: 2*params_active
    per token, plus attention O(S^2)."""
    # active params per unit
    attn = cfg._attn_params()
    if cfg.family == "ssm":
        per_unit = cfg._rwkv_layer_params()
    elif cfg.family == "hybrid":
        per_unit = cfg._mamba2_layer_params()
    elif cfg.num_experts and cfg.moe_period == 2:
        per_unit = 2 * attn + cfg._dense_ffn_params() + cfg.experts_per_tok * 3 * cfg.d_model * cfg.d_ff
    elif cfg.num_experts:
        per_unit = attn + cfg.experts_per_tok * 3 * cfg.d_model * cfg.d_ff
    else:
        per_unit = attn + cfg._dense_ffn_params()
    flops = 2.0 * per_unit * batch * seq * n_units
    if cfg.family not in ("ssm",):
        # causal attention score+value FLOPs
        flops += n_units * 2.0 * 2.0 * batch * seq * seq / 2 * cfg.num_heads * cfg.hd
    return flops


def _segment_param_bytes(cfg, n_units, dtype_bytes) -> float:
    if cfg.family == "ssm":
        per = cfg._rwkv_layer_params()
    elif cfg.family == "hybrid":
        per = cfg._mamba2_layer_params()
    elif cfg.num_experts:
        per = cfg._attn_params() + cfg._moe_ffn_params() / max(1, cfg.moe_period)
    else:
        per = cfg._attn_params() + cfg._dense_ffn_params()
    return float(per * n_units * dtype_bytes)
