"""Architecture registry: ``--arch <id>`` resolves through here.

``get_config(arch)`` returns the full-size :class:`~repro_torch.config.ModelConfig`;
``get_smoke_config(arch)`` the reduced CPU-runnable variant.
"""
from __future__ import annotations

import importlib

from repro_torch.config import SHAPES, ModelConfig, ShapeConfig, cell_applicable, reduced

# arch id -> module name
_ARCH_MODULES = {
    "granite-3-2b": "granite_3_2b",
    "granite-3-8b": "granite_3_8b",
    "llama3.2-1b": "llama3_2_1b",
    "starcoder2-15b": "starcoder2_15b",
    "rwkv6-3b": "rwkv6_3b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "zamba2-2.7b": "zamba2_2_7b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return reduced(get_config(arch))


def cells():
    """Yield every assigned (arch, shape, applicable, reason) dry-run cell."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, reason = cell_applicable(cfg, shape)
            yield arch, shape.name, ok, reason
