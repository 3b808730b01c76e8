"""Unified model facade (the counterpart of ``src/repro/models/api.py``).

``Model(cfg)`` dispatches to the family stack (``transformer`` for the dense
family, ``ssm_stack`` for the ssm and hybrid families) and exposes
``init_params / init_cache / prefill / decode_step / logits / forward``.
Every other family raises :class:`NotImplementedError` naming the
``ROADMAP.md`` item that brings it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm_stack, transformer


def _unsupported(cfg: ModelConfig) -> Optional[str]:
    """The ``ROADMAP.md`` queue step (open item 1) that ports ``cfg``'s
    family, or None for the families the port serves."""
    if cfg.family in ("ssm", "hybrid"):
        return None
    if cfg.is_encdec:
        return "step 8, enc-dec (models/encdec.py)"
    if cfg.num_experts:
        return "step 8, MoE (models/moe.py)"
    if cfg.frontend != "none":
        return "step 8, the VLM prefix"
    if cfg.family != "dense":
        return f"step 8, the {cfg.family} family"
    return None


class Model:
    def __init__(self, cfg: ModelConfig):
        missing = _unsupported(cfg)
        if missing is not None:
            raise NotImplementedError(
                f"{cfg.name} is not ported yet: ROADMAP.md open item 1, {missing}")
        self.cfg = cfg
        self.stack = ssm_stack if cfg.family in ("ssm", "hybrid") else transformer

    # ------------------------------------------------------------------ params
    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.bfloat16, device="cuda"):
        return self.stack.init_params(self.cfg, generator, dtype, device)

    def segment_lengths(self):
        return self.stack.segment_lengths(self.cfg)

    @property
    def num_segments(self) -> int:
        return len(self.segment_lengths())

    # ------------------------------------------------------------------ eval
    def forward(self, params, tokens, *, exit_point=None, impl="kernel"):
        return self.stack.forward(self.cfg, params, tokens,
                                  exit_point=exit_point, impl=impl)

    # ------------------------------------------------------------------ serving
    def init_cache(self, batch, max_seq, dtype=torch.bfloat16, device="cuda"):
        return self.stack.init_cache(self.cfg, batch, max_seq, dtype, device)

    def prefill(self, params, tokens, cache, *, impl="kernel"):
        return self.stack.prefill(self.cfg, params, tokens, cache, impl=impl)

    def decode_step(self, params, cache, tokens, pos, *, exit_point=None,
                    with_exit_confidence=False, impl="kernel", mask=None):
        """``with_exit_confidence`` is ignored by the ssm and hybrid
        families, which report no intermediate exits (``[]``), as the
        reference.  ``mask`` ([B] bool) commits the cache writes of its
        rows only (the arena's masked commit)."""
        if self.stack is ssm_stack:
            return ssm_stack.decode_step(self.cfg, params, cache, tokens, pos,
                                         exit_point=exit_point, impl=impl,
                                         mask=mask)
        return transformer.decode_step(self.cfg, params, cache, tokens, pos,
                                       exit_point=exit_point,
                                       with_exit_confidence=with_exit_confidence,
                                       impl=impl, mask=mask)

    def logits(self, params, hidden):
        return L.logits(params["embed"], hidden)
