"""Explicit redistributions of DTensors, where an op's sharding is chosen
by hand rather than by DTensor's propagation.

The kernels treat batch rows and whole heads independently, and nothing
else: at a kernel boundary every other sharded dim is redistributed to
``Replicate`` (:func:`keep_sharded`), as GSPMD does around an opaque custom
call, and the kernel runs on local shards.  The plain attention cores run
the same way (:func:`local_attention`), the CE's label logits are picked
from each rank's vocab shard (:func:`pick`), and cache writes into a
sequence-sharded cache go to each rank's own shard (:func:`window`), with
no gather.  Each function returns a plain tensor unchanged (``follow``
takes a plain tensor as replicated), so the model code keeps one path.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def keep_sharded(x, dims):
    """``x`` with only the tensor dims in ``dims`` left sharded: every other
    shard and every partial sum becomes ``Replicate``."""
    if not is_dtensor(x):
        return x
    dims = {d % x.ndim for d in dims}
    pl = tuple(p if isinstance(p, Shard) and p.dim in dims else Replicate()
               for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


def follow(x, like, dim_map):
    """``x`` sharded where ``like`` is: mesh dim ``i`` shards ``x``'s dim
    ``dim_map[d]`` when it shards ``like``'s dim ``d``, and replicates
    otherwise.  A plain ``x`` is taken as replicated on ``like``'s mesh
    (its shard is then a local slice, no communication)."""
    mesh = like.device_mesh
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    pl = tuple(Shard(dim_map[p.dim]) if isinstance(p, Shard) and p.dim in dim_map
               else Replicate() for p in like.placements)
    return x if pl == tuple(x.placements) else x.redistribute(mesh, pl)


def replicate(x):
    """``x`` replicated on every mesh dim (a plain tensor as it is)."""
    return keep_sharded(x, ())


def window(x, dim: int):
    """(start, length) of this rank's shard of DTensor ``x`` along ``dim``
    in global indices ((0, size) for a plain tensor)."""
    if not is_dtensor(x):
        return 0, x.shape[dim]
    shape, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return offset[dim], shape[dim]


def head_split(q, tensor_dim: int):
    """(mesh dim, rank index, ranks) of the single mesh dim that shards
    ``q``'s head dim ``tensor_dim``, or None when none does."""
    dims = [i for i, p in enumerate(q.placements)
            if isinstance(p, Shard) and p.dim == tensor_dim]
    if not dims:
        return None
    if len(dims) > 1:
        raise ValueError(f"heads sharded over {len(dims)} mesh dims")
    i = dims[0]
    return i, q.device_mesh.get_local_rank(i), q.device_mesh.size(i)


def gqa_operands(q, kvs, head_dim: int = 2):
    """The key/value operands of a kernel whose query ``q`` (a DTensor)
    keeps its batch (dim 0) and head (``head_dim``) splits: each of ``kvs``
    follows q's batch split with its sequence and channels replicated.
    When q's heads are sharded over ``n`` ranks and the key heads divide
    by ``n`` too, the key heads follow q's split (rank c's query heads meet
    key heads c·KV/n onwards); otherwise the key heads stay replicated and
    the returned ``slice_kv(t)`` cuts, on rank c, the key heads that its
    own query heads [c·H/n, (c+1)·H/n) read under the GQA map ``h // G``.
    Returns (kvs, slice_kv)."""
    split = head_split(q, head_dim)
    H, KV = q.shape[head_dim], kvs[0].shape[head_dim]
    if split is None or KV % split[2] == 0:
        return [follow(t, q, {0: 0, head_dim: head_dim}) for t in kvs], (lambda t: t)
    _, c, n = split
    if H % n or H % KV:
        raise ValueError(f"{H} query heads over {KV} key heads do not split over {n} ranks")
    G, h_loc = H // KV, H // n
    kv0, kv1 = (c * h_loc) // G, ((c + 1) * h_loc - 1) // G + 1
    if not (h_loc % G == 0 or G % h_loc == 0):
        raise ValueError(f"{h_loc} local query heads straddle groups of {G}")
    kvs = [follow(t, q, {0: 0}) for t in kvs]
    return kvs, (lambda t: t.narrow(head_dim, kv0, kv1 - kv0))


def split_dim(x, dim: int, n: int):
    """``x`` ready to have its ``dim`` split into ``n`` outer parts (heads
    from a fused ``heads * hd`` width): when the mesh dims sharding ``dim``
    do not divide ``n``, they are redistributed to ``Replicate`` (DTensor
    cannot unflatten an uneven split)."""
    if not is_dtensor(x):
        return x
    dim %= x.ndim
    mesh = x.device_mesh
    ranks = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            ranks *= mesh.size(i)
    if n % ranks == 0:
        return x
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
               for p in x.placements)
    return x.redistribute(mesh, pl)


def pin(x, like):
    """``x`` laid out as ``like`` (DTensors of one shape), or as it is.  The
    residual stream is pinned to its layout at the unit's input after every
    block, so the sharding DTensor picks inside a block does not drift
    from unit to unit."""
    if not is_dtensor(x) or tuple(x.placements) == tuple(like.placements):
        return x
    return x.redistribute(like.device_mesh, like.placements)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: a local
    shard's gradient leaves ``local_map`` as the local tensor of a DTensor,
    which DTensor's decomposed ops (a matmul's ``view``) take to be
    contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_attention(fn, q, k, v, *rest):
    """``fn(q, k, v, *rest)`` (an attention over [B, S, H, hd] queries and
    [B, T, KV, hd] keys) on the local shards of DTensor operands, through
    ``local_map``: q keeps its batch and head splits, k and v follow q's
    batch split with their sequence gathered (a sharded cache is
    all-gathered here) and meet q's heads (:func:`gqa_operands`).  Each of
    ``rest`` whose leading dim is the batch (a [B] length, a [B, ...] bias)
    follows the batch split; a tensor of leading dim 1 is replicated and
    anything else is passed as it is.  The output is laid out as q; the
    gradients flow back through the same layouts."""
    like = next(t for t in (q, k, v) if is_dtensor(t))
    if not is_dtensor(q):
        q = follow(q, like, {0: 0})
    # the batch splits the keys have (a cache laid out by its specs) win:
    # re-splitting the small query is cheaper than gathering the cache
    pl = []
    for i, p in enumerate(q.placements):
        kp = k.placements[i] if is_dtensor(k) else None
        if isinstance(kp, Shard) and kp.dim == 0:
            p = Shard(0)
        elif not (isinstance(p, Shard) and p.dim in (0, 2)):
            p = Replicate()
        pl.append(p)
    if tuple(pl) != tuple(q.placements):
        q = q.redistribute(q.device_mesh, tuple(pl))
    (k, v), cut = gqa_operands(q, (k, v))
    B = q.shape[0]
    args, in_pl = [q, k, v], [q.placements, k.placements, v.placements]
    for r in rest:
        if isinstance(r, torch.Tensor) and r.ndim and r.shape[0] in (1, B):
            r = follow(r, q, {0: 0} if r.shape[0] == B else {})
            in_pl.append(r.placements)
        else:
            in_pl.append(None)
        args.append(r)

    def local(ql, kl, vl, *rl):
        ql, kl, vl = (_ContiguousGrad.apply(t) if t.requires_grad else t
                      for t in (ql, kl, vl))
        return fn(ql, cut(kl), cut(vl), *rl)

    return local_map(local, out_placements=(q.placements,), in_placements=tuple(in_pl),
                     device_mesh=q.device_mesh)(*args)


def pick(logits, labels):
    """``logits[..., labels]`` (labels one per row, the last dim the
    vocab).  On DTensors each rank picks from its own vocab shard, the
    rows of labels outside it give 0, and the result is a partial sum over
    the mesh dims that shard the vocab (DTensor's own gather from a
    vocab-sharded tensor fails in its masked-partial path)."""
    if not is_dtensor(logits):
        return torch.gather(logits, -1, labels[..., None].long())[..., 0]
    d = logits.ndim - 1
    logits = keep_sharded(logits, range(logits.ndim))
    labels = follow(labels, logits, {i: i for i in range(d)})
    v0, _ = window(logits, d)
    out_pl = tuple(Partial("sum") if isinstance(p, Shard) and p.dim == d else p
                   for p in logits.placements)

    def local(lg, lab):
        idx = lab.long() - v0
        inside = (idx >= 0) & (idx < lg.shape[-1])
        val = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        return torch.where(inside, val, torch.zeros_like(val))

    return local_map(local, out_placements=(out_pl,),
                     in_placements=(logits.placements, labels.placements),
                     device_mesh=logits.device_mesh)(logits, labels)
