"""Unified model facade (the counterpart of ``src/repro/models/api.py``).

``Model(cfg)`` dispatches to the family stack (``ssm_stack`` for the ssm
and hybrid families, ``encdec`` for the encoder-decoder, ``transformer``
for the dense, MoE and VLM families) and exposes ``init_params /
abstract_params / param_specs / loss / init_cache / cache_specs / prefill /
decode_step / logits / forward / make_inputs``.  The enc-dec takes
``frames`` and the VLM ``prefix_emb`` where the reference's do.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import spmd
from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.device import resolve
from repro_torch.models import layers as L
from repro_torch.models import encdec, ssm_stack, transformer
from repro_torch.models.encdec import AUDIO_DIM
from repro_torch.models.transformer import VIS_DIM
from repro_torch.obs import spans


EXIT_LOSS_WEIGHT = 0.3  # BranchyNet-style joint loss: side exits weighted


def _ce(h, lab, embed_table):
    logits = torch.einsum("bsd,vd->bsv", h, embed_table).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = spmd.pick(logits, lab)
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


def _stack(cfg: ModelConfig):
    if cfg.family in ("ssm", "hybrid"):
        return ssm_stack
    if cfg.is_encdec:
        return encdec
    return transformer


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.stack = _stack(cfg)

    # ------------------------------------------------------------------ params
    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype=torch.bfloat16, device="cuda"):
        return self.stack.init_params(self.cfg, generator, dtype, device)

    def abstract_params(self, dtype=torch.bfloat16):
        """The parameters' shapes and dtypes as ``meta`` tensors (the
        reference's ``jax.eval_shape`` of ``init_params``): no memory."""
        return self.stack.init_params(self.cfg, torch.Generator(), dtype, "meta")

    def param_specs(self):
        return self.stack.param_specs(self.cfg)

    def segment_lengths(self):
        return self.stack.segment_lengths(self.cfg)

    @property
    def num_segments(self) -> int:
        return len(self.segment_lengths())

    # ------------------------------------------------------------------ loss
    def loss(self, params, batch, *, remat=True, attn_impl="auto", scan_chunk=16,
             ce_chunk=512, moe_dispatch="einsum", seq_parallel=False):
        """Joint multi-exit next-token CE (BranchyNet): each side exit
        weighted EXIT_LOSS_WEIGHT, the final exit 1, normalised, plus 0.01 of
        the stack's auxiliary loss (the MoE's load balance).  batch:
        {"tokens": [B, S+1]}, plus ``frames`` [B, S_enc, 1024] for the
        enc-dec and ``prefix_emb`` [B, P, 1024] for the VLM, whose first P
        hidden rows (the prefix) are dropped before the CE.  Returns (loss,
        metrics).  ``ce_chunk`` is the CE's slice: the reference's
        ``Model.loss`` takes ``softmax_xent``'s default of 512, which its
        ``make_train_step`` accepts as ``ce_chunk`` and does not pass on.
        ``seq_parallel`` (dense, MoE and VLM stacks, on DTensors) is
        :func:`repro_torch.models.transformer._seq_shard` between blocks."""
        cfg = self.cfg
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        kw: Dict[str, Any] = dict(remat=remat, impl=attn_impl)
        if self.stack is encdec:
            outs, aux = encdec.forward(cfg, params, inputs, batch["frames"], **kw)
        elif self.stack is ssm_stack:
            outs, aux = ssm_stack.forward(cfg, params, inputs, scan_chunk=scan_chunk, **kw)
        else:
            outs, aux = transformer.forward(cfg, params, inputs,
                                            prefix_emb=batch.get("prefix_emb"),
                                            moe_dispatch=moe_dispatch,
                                            seq_parallel=seq_parallel, **kw)
        P = cfg.num_prefix_tokens if (cfg.frontend == "vision"
                                      and batch.get("prefix_emb") is not None) else 0
        losses = []
        for i, (_, h) in enumerate(outs):
            w = 1.0 if i == len(outs) - 1 else EXIT_LOSS_WEIGHT
            losses.append((w, softmax_xent(h[:, P:], params["embed"], labels,
                                           chunk=ce_chunk)))
        total = sum(w * l for w, l in losses) / sum(w for w, _ in losses)
        total = total + 0.01 * aux
        metrics = {"loss": total, "aux": aux, "final_ce": losses[-1][1],
                   "exit_ce": torch.stack([l for _, l in losses])}
        return total, metrics

    # ------------------------------------------------------------------ eval
    def forward(self, params, tokens, *, exit_point=None, impl="kernel", frames=None,
                prefix_emb=None, moe_dispatch="einsum"):
        """Every exit's normed hidden state, a list of (exit_idx, hidden)."""
        cfg = self.cfg
        if self.stack is encdec:
            outs, _ = encdec.forward(cfg, params, tokens, frames, exit_point=exit_point,
                                     impl=impl)
        elif self.stack is ssm_stack:
            outs, _ = ssm_stack.forward(cfg, params, tokens, exit_point=exit_point,
                                        impl=impl)
        else:
            outs, _ = transformer.forward(cfg, params, tokens, prefix_emb,
                                          exit_point=exit_point, impl=impl,
                                          moe_dispatch=moe_dispatch)
        return outs

    # ------------------------------------------------------------------ serving
    def init_cache(self, batch, max_seq, dtype=torch.bfloat16, device="cuda",
                   enc_len=None, quant=False):
        """``enc_len`` (enc-dec only): the cross caches' length, ``max_seq``
        when None.  ``quant``: the int8 KV cache, which the transformer stack
        alone has (the reference builds an unquantized cache for the other
        stacks without a word; here they refuse it)."""
        cfg = self.cfg
        if quant and self.stack is not transformer:
            raise ValueError(f"{cfg.name}: the int8 KV cache is the transformer "
                             "stack's only")
        if self.stack is encdec:
            return encdec.init_cache(cfg, batch, max_seq, enc_len or max_seq, dtype,
                                     device)
        if self.stack is transformer:
            return transformer.init_cache(cfg, batch, max_seq, dtype, device, quant=quant)
        return ssm_stack.init_cache(cfg, batch, max_seq, dtype, device)

    def cache_specs(self, batch_axes="data", seq_axes="model", quant=False):
        if quant and self.stack is transformer:
            return transformer.cache_specs(self.cfg, batch_axes, seq_axes, quant=True)
        return self.stack.cache_specs(self.cfg, batch_axes, seq_axes)

    def shares_pad_prefix(self, params, cache, prefix_emb=None) -> bool:
        """Whether :meth:`prefill` of these parameters into ``cache`` takes
        ``lengths`` and computes the rows' shared left-pad prefix once: the
        dense stack without experts, no VLM prefix, a cache in the
        parameters' dtype, no DTensors
        (:func:`repro_torch.models.transformer.shares_pad_prefix`)."""
        return self.stack is transformer and transformer.shares_pad_prefix(
            self.cfg, params, cache, prefix_emb)

    def prefill(self, params, tokens, cache, *, frames=None, prefix_emb=None,
                impl="kernel", moe_dispatch="einsum", lengths=None):
        """``lengths`` (host ints, where :meth:`shares_pad_prefix`): each
        left-padded row's prompt length; the rows' pad prefix is computed
        once (:func:`repro_torch.models.transformer.prefill`)."""
        cfg = self.cfg
        if lengths is not None and self.stack is not transformer:
            raise ValueError(f"{cfg.name}: only the transformer stack's prefill "
                             "takes lengths")
        with spans.span("model.prefill", {"B": tokens.shape[0], "S": tokens.shape[1]}) \
                if spans.on() else spans.OFF:
            if self.stack is encdec:
                return encdec.prefill(cfg, params, tokens, cache, frames, impl=impl)
            if self.stack is ssm_stack:
                return ssm_stack.prefill(cfg, params, tokens, cache, impl=impl)
            return transformer.prefill(cfg, params, tokens, cache, prefix_emb, impl=impl,
                                       moe_dispatch=moe_dispatch, lengths=lengths)

    def decode_step(self, params, cache, tokens, pos, *, exit_point=None,
                    with_exit_confidence=False, impl="kernel", mask=None,
                    moe_dispatch="einsum"):
        """``with_exit_confidence`` is ignored by the ssm, hybrid and enc-dec
        families, which report no intermediate exits (``[]``), as the
        reference.  ``mask`` ([B] bool) commits the cache writes of its
        rows only (the arena's masked commit)."""
        cfg = self.cfg
        with self._decode_span(exit_point) if spans.on() else spans.OFF:
            if self.stack is encdec:
                return encdec.decode_step(cfg, params, cache, tokens, pos,
                                          exit_point=exit_point, impl=impl, mask=mask)
            if self.stack is ssm_stack:
                return ssm_stack.decode_step(cfg, params, cache, tokens, pos,
                                             exit_point=exit_point, impl=impl, mask=mask)
            return transformer.decode_step(cfg, params, cache, tokens, pos,
                                           exit_point=exit_point,
                                           with_exit_confidence=with_exit_confidence,
                                           impl=impl, mask=mask, moe_dispatch=moe_dispatch)

    def _decode_span(self, exit_point):
        """The ``model.decode_step`` span of a step that stops at
        ``exit_point``, counting the segments and layers it runs."""
        segs = self.segment_lengths()
        run = len(segs) if exit_point is None else exit_point + 1
        layers = sum(segs[:run]) * (self.cfg.num_layers // sum(segs))
        return spans.span("model.decode_step", {"exit": run - 1, "layers": layers},
                          {"model.decode_layers": layers,
                           "model.decode_segments_run": run,
                           "model.decode_segments_available": len(segs)})

    def logits(self, params, hidden):
        return L.logits(params["embed"], hidden)

    # ------------------------------------------------------------------ inputs
    def make_inputs(self, shape: ShapeConfig, *, abstract=False,
                    generator: Optional[torch.Generator] = None, device="cuda"):
        """The batch of a shape cell, as the reference's: int32 tokens
        uniform over the vocab, bf16 standard-normal frames (enc-dec) and
        prefix (VLM), and for decode one token per row with ``pos`` the
        scalar int32 ``seq_len - 1``.  ``abstract``: ``meta`` tensors (the
        dry run's inputs, no memory); otherwise drawn from ``generator``
        (a :class:`torch.Generator` on ``device``, seed 0 when None)."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        dev = torch.device("meta") if abstract else resolve(device)
        if generator is None and not abstract:
            generator = torch.Generator(device=dev).manual_seed(0)

        def arr(shp, dtype):
            if abstract:
                return torch.empty(shp, dtype=dtype, device=dev)
            if dtype == torch.int32:
                return torch.randint(0, cfg.vocab_size, shp, generator=generator,
                                     dtype=torch.int32, device=dev)
            return torch.randn(shp, generator=generator, dtype=torch.float32,
                               device=dev).to(dtype)

        if shape.kind in ("train", "prefill"):
            extra = 1 if shape.kind == "train" else 0
            if cfg.is_encdec:
                return {"tokens": arr((B, S + extra), torch.int32),
                        "frames": arr((B, S, AUDIO_DIM), torch.bfloat16)}
            if cfg.frontend == "vision":
                P = cfg.num_prefix_tokens
                return {"tokens": arr((B, S - P + extra), torch.int32),
                        "prefix_emb": arr((B, P, VIS_DIM), torch.bfloat16)}
            return {"tokens": arr((B, S + extra), torch.int32)}
        # decode: one new token against a seq_len cache
        pos = (torch.empty((), dtype=torch.int32, device=dev) if abstract
               else torch.tensor(S - 1, dtype=torch.int32, device=dev))
        return {"tokens": arr((B, 1), torch.int32), "pos": pos}
