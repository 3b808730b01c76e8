"""Device meshes over ``torch.distributed`` (the counterpart of
``src/repro/launch/mesh.py``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the world
of the default process group, with the reference's axis names: ``("data",
"model")``, or ``("pod", "data", "model")`` for two pods.  A sharded layout
is a DTensor: a reference ``PartitionSpec`` is a :class:`repro_torch.tree.P`
of the same per-dimension entries (``None``, an axis name, or a tuple of
names), and :func:`placements` turns it into DTensor placements for a mesh.

The reference's ``mesh_axis_kwargs`` is a shim over JAX versions (the
``axis_types=`` of ``jax.make_mesh``); a ``DeviceMesh`` has no axis types,
so it has no counterpart here.

No fallback: a mesh over CUDA devices runs on NCCL, and a world that has
none running starts one of one process on NCCL or raises; gloo is used only
when the caller asks for ``device="cpu"``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch import tree as T
from repro_torch.device import resolve

P = T.P

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def _start_world(device: torch.device):
    """The default process group, started as a world of one process when
    none is running: NCCL for a CUDA device, gloo for the CPU."""
    if dist.is_initialized():
        backend = dist.get_backend()
        if device.type == "cuda" and backend not in ("nccl", "fake"):
            raise RuntimeError(f"a CUDA mesh needs NCCL; the running world is {backend!r}")
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def _device_type(device: torch.device) -> str:
    return "cuda" if device.type == "cuda" else "cpu"


def _mesh(device: torch.device, shape, names) -> DeviceMesh:
    if device.type == "cuda" and dist.get_backend() == "nccl":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(_device_type(device), tuple(shape), mesh_dim_names=tuple(names))


def make_host_mesh(model_parallel: int = 1, device="cuda") -> DeviceMesh:
    """A ``(data, model)`` mesh over the world of the default process group
    (tests, examples and one card): ``model_parallel`` ranks along
    ``model``, the rest along ``data``.  Starts a world of one when none is
    running (NCCL on the card, gloo for ``device="cpu"``)."""
    dev = resolve(device)
    _start_world(dev)
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide a world of {n}")
    return _mesh(dev, (n // model_parallel, model_parallel), ("data", "model"))


def make_production_mesh(multi_pod: bool = False, device="cuda") -> DeviceMesh:
    """The production mesh: 16×16 ``(data, model)`` over a world of 256, or
    2×16×16 ``(pod, data, model)`` over 512.  Raises on any other world;
    it never builds a smaller mesh."""
    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    need = 1
    for s in shape:
        need *= s
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n != need:
        raise RuntimeError(f"the {'x'.join(map(str, shape))} production mesh needs a "
                           f"world of {need} ranks; this one has {n}")
    dev = torch.device(device)
    if dev.type == "cuda" and dist.get_backend() != "fake":
        dev = resolve(dev)
    return _mesh(dev, shape, names)


def batch_axes(mesh: DeviceMesh):
    """Mesh axes that shard the batch dimension."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def axis_size(mesh: DeviceMesh, axes) -> int:
    """Ranks along one mesh axis or a tuple of them (1 for None)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def placements(spec, mesh: DeviceMesh, ndim: int = None):
    """DTensor placements of a spec on ``mesh``: mesh dim ``i`` shards
    tensor dim ``d`` when the spec's entry ``d`` names axis ``i`` (alone or
    in a tuple), and replicates otherwise.  An entry ``("pod", "data")``
    shards one tensor dim over two mesh dims, pod-major as in JAX (DTensor
    splits a dim over mesh dims in mesh order).  A spec shorter than the
    tensor leaves the trailing dims replicated.  A mesh dim of one rank
    replicates (its one shard is the whole dim), which spares DTensor's
    view rules a sharded dim of size 1."""
    spec = tuple(spec)
    if ndim is not None and len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than a {ndim}-d tensor")
    names = mesh.mesh_dim_names
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        order = [names.index(a) if a in names else -1 for a in axes]
        if -1 in order:
            raise ValueError(f"spec {spec} names an axis not in the mesh {names}")
        if order != sorted(order):
            raise ValueError(f"spec entry {entry} is not in mesh order {names}")
        for i in order:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two dims of {spec}")
            out[i] = Shard(d)
    return tuple(Replicate() if mesh.size(i) == 1 else p for i, p in enumerate(out))


def distribute(tree, specs, mesh: DeviceMesh):
    """``tree``'s tensors laid out by the congruent ``specs`` tree: a plain
    tensor, which every rank holds whole (same seed, or a replicated host
    batch), becomes a DTensor of which each rank keeps its own shard, with
    no communication; a DTensor is redistributed; a meta tensor stays
    meta."""
    def put(x, spec):
        pl = placements(spec, mesh, x.ndim)
        if isinstance(x, DTensor):
            return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)
        return distribute_tensor(x, mesh, pl, src_data_rank=None)
    return T.tree_map(put, tree, specs)


def local_bytes(tree) -> int:
    """Bytes of the local shards of a tree of (D)Tensors on this rank."""
    n = 0
    for x in T.leaves(tree):
        if isinstance(x, torch.Tensor):
            loc = x.to_local() if hasattr(x, "to_local") else x
            n += loc.numel() * loc.element_size()
    return n

