"""Unified model facade (the counterpart of ``src/repro/models/api.py``).

``Model(cfg)`` serves the dense family in this slice of the port and
exposes ``init_params / init_cache / prefill / decode_step / logits /
forward``.  Every other family raises :class:`NotImplementedError` naming
the ``ROADMAP.md`` item that brings it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer


def _unsupported(cfg: ModelConfig) -> Optional[str]:
    """The ``ROADMAP.md`` queue step (open item 1) that ports ``cfg``'s
    family, or None for the dense family this slice serves."""
    if cfg.family in ("ssm", "hybrid"):
        return "step 2, ssm_scan with the SSM/hybrid families"
    if cfg.is_encdec:
        return "step 7, enc-dec (models/encdec.py)"
    if cfg.num_experts:
        return "step 7, MoE (models/moe.py)"
    if cfg.frontend != "none":
        return "step 7, the VLM prefix"
    if cfg.family != "dense":
        return f"step 7, the {cfg.family} family"
    return None


class Model:
    def __init__(self, cfg: ModelConfig):
        missing = _unsupported(cfg)
        if missing is not None:
            raise NotImplementedError(
                f"{cfg.name} is not ported yet: ROADMAP.md open item 1, {missing}")
        self.cfg = cfg
        self.stack = transformer

    # ------------------------------------------------------------------ params
    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.bfloat16, device="cuda"):
        return transformer.init_params(self.cfg, generator, dtype, device)

    def segment_lengths(self):
        return transformer.segment_lengths(self.cfg)

    @property
    def num_segments(self) -> int:
        return len(self.segment_lengths())

    # ------------------------------------------------------------------ eval
    def forward(self, params, tokens, *, exit_point=None, impl="kernel"):
        return transformer.forward(self.cfg, params, tokens,
                                   exit_point=exit_point, impl=impl)

    # ------------------------------------------------------------------ serving
    def init_cache(self, batch, max_seq, dtype=torch.bfloat16, device="cuda"):
        return transformer.init_cache(self.cfg, batch, max_seq, dtype, device)

    def prefill(self, params, tokens, cache, *, impl="kernel"):
        return transformer.prefill(self.cfg, params, tokens, cache, impl=impl)

    def decode_step(self, params, cache, tokens, pos, *, exit_point=None,
                    with_exit_confidence=False, impl="kernel"):
        return transformer.decode_step(self.cfg, params, cache, tokens, pos,
                                       exit_point=exit_point,
                                       with_exit_confidence=with_exit_confidence,
                                       impl=impl)

    def logits(self, params, hidden):
        return L.logits(params["embed"], hidden)
