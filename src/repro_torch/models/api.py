"""Unified model facade (the counterpart of ``src/repro/models/api.py``).

``Model(cfg)`` dispatches to the family stack (``transformer`` for the dense
family, ``ssm_stack`` for the ssm and hybrid families) and exposes
``init_params / loss / init_cache / prefill / decode_step / logits /
forward``.  Every other family raises :class:`NotImplementedError` naming
the ``ROADMAP.md`` item that brings it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm_stack, transformer


EXIT_LOSS_WEIGHT = 0.3  # BranchyNet-style joint loss: side exits weighted


def _ce(h, lab, embed_table):
    logits = torch.einsum("bsd,vd->bsv", h, embed_table).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lab[..., None].long())[..., 0]
    return lse - ll


def softmax_xent(hidden, embed_table, labels, mask=None, chunk: int = 512):
    """Mean next-token CE of hidden states [B,S,D] against the tied
    embedding's logits, labels [B,S] (``mask`` [B,S] weights the tokens).

    The [B,S,V] float32 logits are never held whole: when ``chunk``
    divides S (and S > chunk) the sequence is taken ``chunk`` tokens at a
    time, and each slice runs under ``torch.utils.checkpoint``, so the
    backward recomputes a slice's logits and the peak transient is [B,
    chunk, V] — the reference's ``lax.scan`` over checkpointed slices.
    The logits are the product in the hidden states' dtype, cast to
    float32, as the reference's."""
    B, S, D = hidden.shape

    def ce(h, lab):
        return checkpoint(_ce, h, lab, embed_table, use_reentrant=False)

    if chunk and S > chunk and S % chunk == 0:
        tot = cnt = 0.0
        for c in range(0, S, chunk):
            ce_c = ce(hidden[:, c:c + chunk], labels[:, c:c + chunk])
            if mask is not None:
                m_c = mask[:, c:c + chunk]
                tot, cnt = tot + torch.sum(ce_c * m_c), cnt + torch.sum(m_c)
            else:
                tot, cnt = tot + torch.sum(ce_c), cnt + ce_c.numel()
        return tot / torch.clamp(torch.as_tensor(cnt, dtype=torch.float32,
                                                 device=hidden.device), min=1.0)
    ce_all = ce(hidden, labels)
    if mask is not None:
        return torch.sum(ce_all * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(ce_all)


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

    # ------------------------------------------------------------------ loss
    def loss(self, params, batch, *, remat=True, attn_impl="auto", scan_chunk=16,
             ce_chunk=512):
        """Joint multi-exit next-token CE (BranchyNet): each side exit
        weighted EXIT_LOSS_WEIGHT, the final exit 1, normalised, plus 0.01 of
        the stack's auxiliary loss.  batch: {"tokens": [B, S+1]}.  Returns
        (loss, metrics).  ``ce_chunk`` is the CE's slice: the reference's
        ``Model.loss`` takes ``softmax_xent``'s default of 512, which its
        ``make_train_step`` accepts as ``ce_chunk`` and does not pass on."""
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        kw: Dict[str, Any] = dict(remat=remat, impl=attn_impl)
        if self.stack is ssm_stack:
            kw["scan_chunk"] = scan_chunk
        outs, aux = self.stack.forward(self.cfg, params, inputs, **kw)
        losses = []
        for i, (_, h) in enumerate(outs):
            w = 1.0 if i == len(outs) - 1 else EXIT_LOSS_WEIGHT
            losses.append((w, softmax_xent(h, params["embed"], labels,
                                           chunk=ce_chunk)))
        total = sum(w * l for w, l in losses) / sum(w for w, _ in losses)
        total = total + 0.01 * aux
        metrics = {"loss": total, "aux": aux, "final_ce": losses[-1][1],
                   "exit_ce": torch.stack([l for _, l in losses])}
        return total, metrics

    # ------------------------------------------------------------------ eval
    def forward(self, params, tokens, *, exit_point=None, impl="kernel"):
        """Every exit's normed hidden state, a list of (exit_idx, hidden)."""
        outs, _ = self.stack.forward(self.cfg, params, tokens,
                                     exit_point=exit_point, impl=impl)
        return outs

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
