"""Sharded step builders: train_step / prefill_step / serve_step (the
counterpart of ``src/repro/launch/steps.py``).

One function per (model, mesh, shape kind).  The reference jits each step
with explicit ``NamedSharding`` trees (FSDP on ``data``, TP on ``model``,
batch over ``pod`` + ``data``); here the same spec trees lay the inputs out
as DTensors over a ``DeviceMesh`` (:func:`repro_torch.launch.mesh.distribute`
keeps each rank's shard of a tensor every rank holds whole, a DTensor of
other placements is redistributed), the step runs eagerly, and DTensor's
sharding propagation lays out every intermediate, as GSPMD does for the
reference.  The outputs are redistributed to the reference's out-shardings:
parameters and optimiser state to the parameter specs, caches to the cache
specs, the prefill's hidden state and the served token to the batch axes.
The reference's ``_ns`` (a ``NamedSharding`` tree from a spec tree) has
no counterpart: the spec tree is the sharding tree, read by
:func:`repro_torch.launch.mesh.placements` as each tensor is placed.
Plain tensors inside the model (positions, masks, biases) meet DTensors as
replicated (``implicit_replication``).

Each builder returns ``(step, abstract_inputs)`` as the reference's does;
``abstract_inputs()`` gives the step's inputs as ``meta`` tensors (the dry
run's).  ``mesh=None`` runs the same step on one device without DTensors
(``device`` names it), the path the sharded steps are held against.

Attention: the reference's ``attn_impl="pallas"`` is the port's
``"kernel"`` (both names are taken).  The ssm and hybrid stacks run their
scan and attention kernels together (``use_kernel`` or a kernel
``attn_impl``).  The serve step runs the decode-attention and exit-head
kernels when ``use_kernel`` or ``use_exit_kernel`` is set (the reference's
decode always attends through its plain ``_sdpa``, and ``use_exit_kernel``
picks its exit head), and their plain versions otherwise.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import tree as T
from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.device import resolve
from repro_torch.launch.mesh import axis_size, batch_axes, distribute
from repro_torch.models.api import Model
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.schedule import warmup_cosine

P = T.P


def _full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """Spec tree matching :meth:`Model.make_inputs`."""
    b = batch_axes(mesh)
    bspec = b if shape.global_batch % axis_size(mesh, b) == 0 else None
    if shape.kind in ("train", "prefill"):
        out = {"tokens": P(bspec, None)}
        if cfg.is_encdec:
            out["frames"] = P(bspec, None, None)
        if cfg.frontend == "vision":
            out["prefix_emb"] = P(bspec, None, None)
        return out
    return {"tokens": P(bspec, None), "pos": P()}


def cache_sharding_axes(shape: ShapeConfig, mesh):
    """(batch_axes, seq_axes) for the KV cache / recurrent state."""
    b = batch_axes(mesh)
    if shape.global_batch % axis_size(mesh, b) == 0:
        return b, "model"
    # tiny batch (long-context): replicate batch, shard cache seq everywhere
    return None, tuple(mesh.mesh_dim_names)


def _impl(cfg: ModelConfig, attn_impl: str, use_kernel: bool) -> str:
    """The port's ``impl`` for the reference's (attn_impl, use_kernel)."""
    if attn_impl == "pallas":
        attn_impl = "kernel"
    if use_kernel and cfg.family in ("ssm", "hybrid"):
        return "kernel"
    return attn_impl


def _device(mesh, device):
    return resolve(mesh.device_type if mesh is not None else device)


# ----------------------------------------------------------------------------
# train
# ----------------------------------------------------------------------------

def make_train_step(model: Model, mesh, shape: ShapeConfig, *,
                    moment_dtype=torch.float32, peak_lr: float = 3e-4,
                    warmup: int = 200, total_steps: int = 10000,
                    remat: bool = True, moe_dispatch: str = "einsum",
                    attn_impl: str = "auto", use_kernel: bool = False,
                    ce_chunk: int = 512, scan_chunk: int = 16,
                    seq_parallel: bool = False, device="cuda"):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "final_ce"})``: the joint multi-exit loss and its backward,
    the learning rate of the warm-up cosine at the optimiser's step, then
    AdamW.  ``batch`` is :meth:`Model.make_inputs` of a train shape
    (``{"tokens": [B, S+1]}``, with ``frames`` for the enc-dec and
    ``prefix_emb`` for the VLM).  The step works on leaves that require
    grad (parameters restored from a checkpoint do not, so it marks them)
    and clears their grads when done.  The step donates the parameters and
    optimiser state it is given, as the reference's does
    (``donate_argnums=(0, 1)``): :func:`adamw_update` writes the new values
    into them (into their local shards under a mesh) and the step returns
    them, so it holds one copy of the state.  A caller that needs the
    state from before a step clones it.  ``ce_chunk`` is the CE's slice
    (the reference accepts it and keeps ``softmax_xent``'s 512).
    ``seq_parallel`` redistributes the residual stream to the sequence
    split over ``model`` between blocks (dense, MoE and VLM stacks).
    The metrics are plain replicated scalars."""
    cfg = model.cfg
    if shape.kind != "train":
        raise ValueError(f"make_train_step takes a train shape, got {shape.kind!r}")
    impl = _impl(cfg, attn_impl, use_kernel)
    dev = _device(mesh, device)
    if mesh is not None:
        p_sh = model.param_specs()
        o_sh = AdamWState(step=P(), mu=p_sh, nu=p_sh)
        b_sh = batch_specs(cfg, shape, mesh)

    def train_step(params, opt_state, batch):
        if mesh is not None:
            params = distribute(params, p_sh, mesh)
            opt_state = distribute(opt_state, o_sh, mesh)
            batch = distribute({k: batch[k] for k in b_sh}, b_sh, mesh)
        else:
            params = T.tree_map(lambda p: p.to(dev), params)
        with implicit_replication():
            params = T.tree_map(lambda p: p.detach().requires_grad_(), params)
            loss, metrics = model.loss(params, batch, remat=remat, attn_impl=impl,
                                       scan_chunk=scan_chunk, ce_chunk=ce_chunk,
                                       moe_dispatch=moe_dispatch,
                                       seq_parallel=seq_parallel and mesh is not None)
            loss.backward()
            leaves = T.leaves(params)
            grads = T.unflatten(params, [torch.zeros_like(p) if p.grad is None
                                         else _like(p.grad, p) for p in leaves])
            lr = warmup_cosine(opt_state.step, peak_lr=peak_lr, warmup=warmup,
                               total=total_steps)
            new_params, new_opt = adamw_update(grads, opt_state, params, lr=lr,
                                               donate=True)
        for p in leaves:
            p.grad = None
        return (T.tree_map(torch.Tensor.detach, new_params), new_opt,
                {"loss": _full(metrics["loss"]).detach(),
                 "final_ce": _full(metrics["final_ce"]).detach()})

    def abstract_inputs():
        params = model.abstract_params()
        return params, adamw_init(params, moment_dtype), model.make_inputs(
            shape, abstract=True)

    return train_step, abstract_inputs


def _like(g, p):
    """``g`` in ``p``'s placements (a gradient may come back partial)."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


# ----------------------------------------------------------------------------
# prefill
# ----------------------------------------------------------------------------

def make_prefill_step(model: Model, mesh, shape: ShapeConfig, *,
                      attn_impl: str = "auto", moe_dispatch: str = "einsum",
                      use_kernel: bool = False, device="cuda"):
    """``prefill_step(params, batch) -> (h [B,1,D], cache)``: a zero cache
    of ``shape.seq_len`` (bf16 as the reference's, the enc-dec's cross
    caches ``seq_len`` long) filled by :meth:`Model.prefill`."""
    cfg = model.cfg
    impl = _impl(cfg, attn_impl, use_kernel)
    dev = _device(mesh, device)
    if mesh is not None:
        baxes, saxes = cache_sharding_axes(shape, mesh)
        p_sh = model.param_specs()
        b_sh = batch_specs(cfg, shape, mesh)
        c_sh = model.cache_specs(batch_axes=baxes, seq_axes=saxes)
        h_sh = P(baxes, None, None)

    def prefill_step(params, batch):
        # the cache lives where the parameters do (meta in the dry run)
        leaf = T.leaves(params)[0]
        cache = model.init_cache(shape.global_batch, shape.seq_len, enc_len=shape.seq_len,
                                 device="meta" if leaf.is_meta else dev)
        if mesh is not None:
            params = distribute(params, p_sh, mesh)
            batch = distribute({k: batch[k] for k in b_sh}, b_sh, mesh)
            cache = distribute(cache, c_sh, mesh)
        with torch.no_grad(), implicit_replication():
            h, cache = model.prefill(params, batch["tokens"], cache,
                                     frames=batch.get("frames"),
                                     prefix_emb=batch.get("prefix_emb"),
                                     impl=impl, moe_dispatch=moe_dispatch)
        if mesh is not None:
            h = distribute(h, h_sh, mesh)
            cache = distribute(cache, c_sh, mesh)
        return h, cache

    def abstract_inputs():
        return model.abstract_params(), model.make_inputs(shape, abstract=True)

    return prefill_step, abstract_inputs


# ----------------------------------------------------------------------------
# decode (serve_step)
# ----------------------------------------------------------------------------

def make_serve_step(model: Model, mesh, shape: ShapeConfig, *,
                    exit_point=None, with_exit_confidence: bool = False,
                    use_exit_kernel: bool = False, moe_dispatch: str = "einsum",
                    use_kernel: bool = False, kv_quant: bool = False,
                    device="cuda"):
    """``serve_step(params, cache, batch) -> (token [B,1] int32, cache)``:
    one-token decode against a ``seq_len`` cache (the paper's serving step;
    ``exit_point`` right-sizes it), then the greedy token of the tied
    logits.  The cache is written in place: a sharded cache is written on
    each rank's own shard only."""
    cfg = model.cfg
    impl = "kernel" if (use_kernel or use_exit_kernel) else "dense"
    dev = _device(mesh, device)
    if mesh is not None:
        baxes, saxes = cache_sharding_axes(shape, mesh)
        p_sh = model.param_specs()
        b_sh = batch_specs(cfg, shape, mesh)
        c_sh = model.cache_specs(batch_axes=baxes, seq_axes=saxes, quant=kv_quant)
        tok_sh = P(baxes, None)

    def serve_step(params, cache, batch):
        if mesh is not None:
            params = distribute(params, p_sh, mesh)
            cache = distribute(cache, c_sh, mesh)
            batch = distribute(batch, b_sh, mesh)
        with torch.no_grad(), implicit_replication():
            h, cache, _ = model.decode_step(
                params, cache, batch["tokens"], _full(batch["pos"]), exit_point=exit_point,
                with_exit_confidence=with_exit_confidence, impl=impl,
                moe_dispatch=moe_dispatch)
            logits = model.logits(params, h)
            token = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
        if mesh is not None:
            token = distribute(token, tok_sh, mesh)
            cache = distribute(cache, c_sh, mesh)
        return token, cache

    def abstract_inputs():
        return (model.abstract_params(),
                model.init_cache(shape.global_batch, shape.seq_len, device="meta",
                                 enc_len=shape.seq_len, quant=kv_quant),
                model.make_inputs(shape, abstract=True))

    return serve_step, abstract_inputs


def make_step(model: Model, mesh, shape: ShapeConfig, **kw):
    if shape.kind == "train":
        return make_train_step(model, mesh, shape, **kw)
    if shape.kind == "prefill":
        return make_prefill_step(model, mesh, shape, **kw)
    return make_serve_step(model, mesh, shape, **kw)
