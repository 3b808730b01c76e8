"""Per-device cost model of an eager step (the counterpart of
``src/repro/launch/hlo_cost.py``, which walks compiled HLO text).

There is no HLO here: a step runs eagerly over DTensors, and every op on
the local shards is a kernel boundary, so the cost model watches those ops
as they run.  :class:`CostCounter` is a ``TorchDispatchMode`` that sees the
local ops under DTensor (it hands every DTensor op back to DTensor, which
then runs its local ops and collectives through the mode), so the costs are
per device, from local shapes, never from the global ones.  Loops really
run in eager mode, so no trip-count walk is needed (the reference
multiplies its ``while`` bodies by their trip counts).  With meta tensors
(the dry run) nothing is computed and only shapes are read.

Per op on local tensors:

* ``flops``: matmuls and convolutions by ``torch.utils.flop_counter``'s
  formulas (2·M·N·K), every other arithmetic op |result| elements, as the
  reference's walker bills its non-dot instructions; views, copies,
  concatenations and fills count nothing;
* ``bytes_walked``: each op reads its tensor operands once and writes its
  results once (the reference's fusion-boundary model, where here every
  op is a boundary); view ops move nothing;
* ``bytes_literal``: the same with view ops billed too (every op
  materialised, the reference's ``fused=False``);
* collectives: each functional collective's kind, result bytes and group
  size, and its per-device link bytes by the reference's ring model
  (:func:`repro_torch.launch.dryrun._link_bytes`).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
#: functional collective ops by kind
_C10D = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
#: ops that return views or metadata: no data moved, no flops
_FREE = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t",
    "slice", "select", "unsqueeze", "squeeze", "alias", "detach", "as_strided",
    "unbind", "split", "split_with_sizes", "chunk", "narrow", "view_as",
    "_reshape_alias", "unflatten", "flatten", "diagonal", "lift_fresh", "empty",
    "empty_like", "empty_strided", "new_empty", "wait_tensor", "sym_size",
    "sym_stride", "sym_numel", "is_same_size", "_local_scalar_dense",
}


#: ops that only move or fill data: bytes, no flops (the reference's walker
#: bills arithmetic instructions only)
_MOVES = {
    "cat", "stack", "clone", "copy", "copy_", "_to_copy", "index", "index_put",
    "index_put_", "_unsafe_index", "gather", "scatter", "slice_scatter",
    "select_scatter", "zero_", "fill_", "zeros", "ones", "full", "zeros_like",
    "ones_like", "full_like", "new_zeros", "new_ones", "new_full", "repeat",
    "constant_pad_nd", "embedding", "_unsafe_view", "contiguous", "arange",
    "scalar_tensor", "lift_fresh_copy",
}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _group_size(name_or_size) -> int:
    if isinstance(name_or_size, int):
        return name_or_size
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name_or_size).size()


class CostCounter(TorchDispatchMode):
    """Counts the per-device costs of the ops run under it (see the module
    docstring).  ``collectives`` has the reference's record schema."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_walked = 0.0
        self.bytes_literal = 0.0
        self.ops = 0
        self.collectives = {k: {"count": 0.0, "bytes": 0.0, "link_bytes": 0.0}
                            for k in COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented          # DTensor runs its local ops under us
        out = func(*args, **kwargs)
        # DTensor's sharding propagation runs ops on fake tensors of the
        # global shapes; those are not the device's work
        if not any(issubclass(t, FakeTensor) for t in types):
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        name = func.overloadpacket.__name__
        ins = [x for x in tree_flatten((args, kwargs))[0] if isinstance(x, torch.Tensor)]
        outs = [x for x in tree_flatten(out)[0] if isinstance(x, torch.Tensor)]
        moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d_functional", "c10d"):
            kind = _C10D.get(name)
            if kind is not None:
                self._collective(kind, name, args, outs)
            return
        self.bytes_literal += moved
        if name in _FREE:
            return
        self.ops += 1
        self.bytes_walked += moved
        fn = flop_registry.get(func.overloadpacket)
        if fn is not None:
            self.flops += fn(*args, **kwargs, out_val=out)
        elif name not in _MOVES:
            self.flops += sum(x.numel() for x in outs)

    def _collective(self, kind, name, args, outs):
        from repro_torch.launch.dryrun import _link_bytes
        if name.startswith("all_gather") or name.startswith("reduce_scatter"):
            g = _group_size(args[-2])
        else:
            g = _group_size(args[-1])
        res = sum(map(_nbytes, outs))
        c = self.collectives[kind]
        c["count"] += 1
        c["bytes"] += res
        c["link_bytes"] += _link_bytes(kind, res, g)

    def collective_stats(self) -> Dict[str, object]:
        """The reference's ``collective_stats`` record."""
        out = {k: dict(v) for k, v in self.collectives.items()}
        out["total_bytes"] = sum(v["bytes"] for v in self.collectives.values())
        out["total_link_bytes"] = sum(v["link_bytes"] for v in self.collectives.values())
        return out


def walk_costs(fn: Callable, *args, **kwargs) -> Tuple[float, float]:
    """(flops, bytes_walked) per device of ``fn(*args, **kwargs)``."""
    with CostCounter() as c:
        fn(*args, **kwargs)
    return c.flops, c.bytes_walked
