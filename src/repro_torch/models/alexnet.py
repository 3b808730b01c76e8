"""Branchy AlexNet — the paper's prototype (Fig. 4), CIFAR-10 scale, PyTorch
(the counterpart of ``src/repro/models/alexnet.py``).

The model is expressed as an explicit *layer graph*: a main branch of 22
layers plus four side branches, so that branch ``i`` (exit point ``i``) has
N_i layers = 12, 16, 19, 20, 22 — matching Sec. V-A.  Layer kinds are exactly
the paper's Table-I types (conv / relu / lrn / pooling / dropout / fc), and
every layer exposes the Table-I regression features plus its output size —
the inputs of the Edgent partitioner.

Layout.  Activations are NHWC at every layer boundary, as in the reference,
so a graph layer's ``run(params, x)`` takes and returns what the
reference's does and a cut tensor has the reference's bytes.  Inside a
conv or pool layer the NHWC tensor is viewed as NCHW with channels-last
strides (a permute, no copy), which cuDNN and oneDNN run natively; conv
weights are OIHW, stored channels-last to match, so no layer converts a
layout per call.  fc weights are ``[in, out]`` and read the flattened input
in (H, W, C) order, as the reference's reshape of an NHWC tensor does.

Padding is TensorFlow's ``"SAME"``, as ``jax.lax`` pads: ``ceil(n / s)``
outputs, the total padding split with the extra row after.  The stride-1
convolutions with odd filters pad ``f // 2`` on both sides; the 3x3
stride-2 max-pool on even sizes pads 0 before and 1 after, with ``-inf``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve


@dataclass(frozen=True)
class BranchyAlexNetConfig:
    name: str = "branchy-alexnet"
    num_classes: int = 10
    image_size: int = 32
    channels: int = 3


@dataclass(frozen=True)
class LayerSpec:
    name: str
    kind: str                    # conv | relu | lrn | pool | dropout | fc
    out_ch: int = 0              # conv filters / fc out features
    filt: int = 0                # conv/pool window
    stride: int = 1
    drop_rate: float = 0.5


def _main_branch(cfg: BranchyAlexNetConfig) -> List[LayerSpec]:
    return [
        LayerSpec("conv1", "conv", out_ch=32, filt=5, stride=1),
        LayerSpec("relu1", "relu"),
        LayerSpec("lrn1", "lrn"),
        LayerSpec("pool1", "pool", filt=3, stride=2),
        LayerSpec("conv2", "conv", out_ch=64, filt=5, stride=1),
        LayerSpec("relu2", "relu"),
        LayerSpec("lrn2", "lrn"),
        LayerSpec("pool2", "pool", filt=3, stride=2),
        LayerSpec("conv3", "conv", out_ch=96, filt=3, stride=1),
        LayerSpec("relu3", "relu"),
        LayerSpec("conv4", "conv", out_ch=96, filt=3, stride=1),
        LayerSpec("relu4", "relu"),
        LayerSpec("conv5", "conv", out_ch=64, filt=3, stride=1),
        LayerSpec("relu5", "relu"),
        LayerSpec("pool5", "pool", filt=3, stride=2),
        LayerSpec("fc1", "fc", out_ch=256),
        LayerSpec("relu6", "relu"),
        LayerSpec("drop1", "dropout"),
        LayerSpec("fc2", "fc", out_ch=128),
        LayerSpec("relu7", "relu"),
        LayerSpec("drop2", "dropout"),
        LayerSpec("fc3", "fc", out_ch=10),
    ]


def _side_branches(cfg) -> List[Tuple[int, List[LayerSpec]]]:
    """(prefix length into main, branch layers).  Branch lengths:
    8+4=12, 10+6=16, 15+4=19, 18+2=20 — plus the 22-layer main = exit 5."""
    c = cfg.num_classes
    return [
        (8, [LayerSpec("b1_conv", "conv", out_ch=32, filt=3),
             LayerSpec("b1_relu", "relu"),
             LayerSpec("b1_pool", "pool", filt=3, stride=2),
             LayerSpec("b1_fc", "fc", out_ch=c)]),
        (10, [LayerSpec("b2_conv", "conv", out_ch=32, filt=3),
              LayerSpec("b2_relu", "relu"),
              LayerSpec("b2_pool", "pool", filt=3, stride=2),
              LayerSpec("b2_fc1", "fc", out_ch=64),
              LayerSpec("b2_relu2", "relu"),
              LayerSpec("b2_fc2", "fc", out_ch=c)]),
        (15, [LayerSpec("b3_fc1", "fc", out_ch=128),
              LayerSpec("b3_relu", "relu"),
              LayerSpec("b3_drop", "dropout"),
              LayerSpec("b3_fc2", "fc", out_ch=c)]),
        (18, [LayerSpec("b4_fc1", "fc", out_ch=32),
              LayerSpec("b4_fc2", "fc", out_ch=c)]),
    ]


# ----------------------------------------------------------------------------
# single-layer semantics
# ----------------------------------------------------------------------------

def layer_out_shape(spec: LayerSpec, in_shape):
    """in_shape excl. batch: (H, W, C) or (F,)."""
    if spec.kind == "conv":
        h, w, _ = in_shape
        return (h // spec.stride, w // spec.stride, spec.out_ch)
    if spec.kind == "pool":
        h, w, c = in_shape
        return (math.ceil(h / spec.stride), math.ceil(w / spec.stride), c)
    if spec.kind == "fc":
        return (spec.out_ch,)
    return tuple(in_shape)


def layer_features(spec: LayerSpec, in_shape) -> Dict[str, float]:
    """Table-I independent variables for the latency regression models."""
    in_size = float(np.prod(in_shape))
    out_size = float(np.prod(layer_out_shape(spec, in_shape)))
    if spec.kind == "conv":
        return {"in_maps": float(in_shape[-1]),
                "comp": (spec.filt / spec.stride) ** 2 * spec.out_ch,
                "in_size": in_size}
    if spec.kind in ("relu", "lrn", "dropout"):
        return {"in_size": in_size}
    if spec.kind == "pool":
        return {"in_size": in_size, "out_size": out_size}
    if spec.kind == "fc":
        return {"in_size": in_size, "out_size": out_size}
    raise ValueError(spec.kind)


def init_layer(spec: LayerSpec, generator: torch.Generator, in_shape,
               dtype=torch.float32, device="cuda"):
    """Random parameters of one layer, drawn from ``generator`` (on
    ``device``) with the reference's scales: conv weights OIHW (stored
    channels-last), fc weights ``[in, out]``, zero biases."""
    dev = resolve(device)
    if spec.kind == "conv":
        cin = in_shape[-1]
        w = torch.randn((spec.out_ch, cin, spec.filt, spec.filt),
                        generator=generator, device=dev, dtype=torch.float32)
        w = (w / math.sqrt(spec.filt * spec.filt * cin)).to(dtype)
        return {"w": w.contiguous(memory_format=torch.channels_last),
                "b": torch.zeros((spec.out_ch,), dtype=dtype, device=dev)}
    if spec.kind == "fc":
        fin = int(np.prod(in_shape))
        w = torch.randn((fin, spec.out_ch), generator=generator, device=dev,
                        dtype=torch.float32)
        return {"w": (w / math.sqrt(fin)).to(dtype),
                "b": torch.zeros((spec.out_ch,), dtype=dtype, device=dev)}
    return {}


def same_pads(n: int, filt: int, stride: int) -> Tuple[int, int]:
    """TensorFlow ``"SAME"`` padding of one spatial dimension of size ``n``:
    (before, after), the extra row after."""
    out = -(-n // stride)
    total = max((out - 1) * stride + filt - n, 0)
    return total // 2, total - total // 2


def lrn(x: torch.Tensor) -> torch.Tensor:
    """Local response normalisation across the last (channel) axis, window
    5, zero-padded at the channel edges: ``x / (2 + 1e-4 * sum x^2)^0.75``,
    the window summed in the reference's order."""
    win, pad = 5, 2
    sq = F.pad(x * x, (pad, pad))
    c = x.shape[-1]
    summed = sq[..., 0:c]
    for i in range(1, win):
        summed = summed + sq[..., i:i + c]
    return x / torch.pow(2.0 + 1e-4 * summed, 0.75)


def apply_layer(spec: LayerSpec, p, x, *, train=False,
                generator: Optional[torch.Generator] = None):
    """x: [B, H, W, C] or [B, F].  Dropout in training draws its mask from
    ``generator`` (on ``x``'s device)."""
    if spec.kind == "conv":
        (top, bottom), (left, right) = (same_pads(x.shape[1], spec.filt, spec.stride),
                                        same_pads(x.shape[2], spec.filt, spec.stride))
        xc = x.permute(0, 3, 1, 2)
        if (top, left) == (bottom, right):
            out = F.conv2d(xc, p["w"], p["b"], stride=spec.stride,
                           padding=(top, left))
        else:
            out = F.conv2d(F.pad(xc, (left, right, top, bottom)), p["w"],
                           p["b"], stride=spec.stride)
        return out.permute(0, 2, 3, 1)
    if spec.kind == "relu":
        return torch.relu(x)
    if spec.kind == "lrn":
        return lrn(x)
    if spec.kind == "pool":
        (top, bottom), (left, right) = (same_pads(x.shape[1], spec.filt, spec.stride),
                                        same_pads(x.shape[2], spec.filt, spec.stride))
        xc = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom),
                   value=-math.inf)
        return F.max_pool2d(xc, spec.filt, spec.stride).permute(0, 2, 3, 1)
    if spec.kind == "dropout":
        if not train:
            return x
        if generator is None:
            raise ValueError("dropout in training draws from an explicit "
                             "generator: pass generator=")
        keep = 1.0 - spec.drop_rate
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))
    if spec.kind == "fc":
        if x.ndim > 2:
            x = x.reshape(x.shape[0], -1)
        return torch.addmm(p["b"], x, p["w"])
    raise ValueError(spec.kind)


# ----------------------------------------------------------------------------
# model
# ----------------------------------------------------------------------------

class BranchyAlexNet:
    """Five-exit branchy AlexNet with an explicit per-branch layer list; its
    parameters are a dict of tensors keyed by layer name."""

    def __init__(self, cfg: BranchyAlexNetConfig):
        self.cfg = cfg
        self.main = _main_branch(cfg)
        self.sides = _side_branches(cfg)
        self.num_exits = len(self.sides) + 1  # 5

    # -- structure ---------------------------------------------------------
    def branch_layers(self, exit_idx: int) -> List[LayerSpec]:
        """Full layer list of branch `exit_idx` (1-based, paper numbering:
        exit 1 shortest ... exit 5 = main)."""
        if exit_idx == self.num_exits:
            return list(self.main)
        prefix, side = self.sides[exit_idx - 1]
        return list(self.main[:prefix]) + list(side)

    def branch_shapes(self, exit_idx: int):
        """Per-layer (in_shape, out_shape) excl. batch for branch."""
        shape = (self.cfg.image_size, self.cfg.image_size, self.cfg.channels)
        out = []
        for spec in self.branch_layers(exit_idx):
            o = layer_out_shape(spec, shape)
            out.append((shape, o))
            shape = o
        return out

    # -- params ------------------------------------------------------------
    def init(self, generator: torch.Generator, dtype=torch.float32,
             device="cuda"):
        """Random parameters drawn from ``generator`` (a seeded
        :class:`torch.Generator` on ``device``), main branch first, then
        each side branch, as the reference splits its key.  Torch cannot
        replay ``jax.random``: to hold the port against the reference,
        convert its parameters with
        :func:`repro_torch.models.convert.alexnet_params_from_numpy`."""
        dev = resolve(device)
        params = {}
        shape = (self.cfg.image_size, self.cfg.image_size, self.cfg.channels)
        for spec in self.main:
            params[spec.name] = init_layer(spec, generator, shape, dtype, dev)
            shape = layer_out_shape(spec, shape)
        for prefix, side in self.sides:
            shape = (self.cfg.image_size, self.cfg.image_size, self.cfg.channels)
            for spec in self.main[:prefix]:
                shape = layer_out_shape(spec, shape)
            for spec in side:
                params[spec.name] = init_layer(spec, generator, shape, dtype, dev)
                shape = layer_out_shape(spec, shape)
        return params

    # -- execution ---------------------------------------------------------
    def run_layers(self, params, x, layer_list, lo=0, hi=None, *, train=False,
                   generator: Optional[torch.Generator] = None):
        hi = len(layer_list) if hi is None else hi
        for spec in layer_list[lo:hi]:
            x = apply_layer(spec, params.get(spec.name, {}), x, train=train,
                            generator=generator)
        return x

    def forward_exit(self, params, x, exit_idx: int, *, train=False,
                     generator: Optional[torch.Generator] = None):
        return self.run_layers(params, x, self.branch_layers(exit_idx),
                               train=train, generator=generator)

    def forward_all(self, params, x, *, train=False,
                    generator: Optional[torch.Generator] = None):
        """Logits at every exit (BranchyNet joint training)."""
        return [self.forward_exit(params, x, i + 1, train=train,
                                  generator=generator)
                for i in range(self.num_exits)]

    def loss(self, params, batch, generator: torch.Generator, weights=None):
        """Joint weighted CE over all exits; ``batch`` is (x [B, H, W, C],
        y [B] integer labels)."""
        x, y = batch
        logits = self.forward_all(params, x, train=True, generator=generator)
        w = weights or [1.0] * self.num_exits
        idx = y.long()[:, None]
        losses = [-torch.log_softmax(lg, -1).gather(1, idx).mean()
                  for lg in logits]
        return sum(wi * li for wi, li in zip(w, losses)) / sum(w)

    def accuracy(self, params, x, y, exit_idx: int):
        logits = self.forward_exit(params, x, exit_idx)
        return (torch.argmax(logits, -1) == y.long()).float().mean()
