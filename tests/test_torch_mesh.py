"""The port's sharding specs and meshes against the reference's, on the CPU
with no process group beyond a world of one (gloo).

* ``param_specs`` of every config at full size, entry for entry (as
  tuples) the reference's;
* ``cache_specs`` through ``cache_sharding_axes`` for every config and
  shape on the 16×16 and 2×16×16 axis sizes, the int8 cache's too;
* ``batch_specs`` and ``make_inputs(abstract=True)``'s shapes and dtypes;
* the spec → placements function on nested, replicated and short specs,
  and the meshes: ``make_production_mesh`` refuses a world of one,
  ``make_host_mesh`` builds a 1×1 mesh over it;
* ``PrefetchLoader(mesh=, spec=)`` places a batch whose local shard is the
  host batch.
(The uneven splits are held on a fake world of eight ranks in
``tests/test_torch_dryrun.py``.)
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.config import SHAPES as REF_SHAPES
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.launch import steps as ref_steps
from repro.models import Model as RefModel
from repro_torch import tree as T
from repro_torch.config import SHAPES
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import PrefetchLoader
from repro_torch.launch import mesh as M
from repro_torch.launch import steps
from repro_torch.models.api import Model

P = T.P
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


class AxisSizes:
    """The axis names and sizes of a mesh, all that the spec builders read
    (a production ``DeviceMesh`` needs a world of 256)."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)

    def size(self, i):
        return self.shape[i]


def _ref_leaves(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _same_specs(port_tree, ref_tree):
    got = [tuple(s) for s in T.leaves(port_tree)]
    want = [tuple(s) for s in _ref_leaves(ref_tree)]
    assert len(got) == len(want)
    assert got == want


def test_same_arch_ids():
    assert tuple(ARCH_IDS) == tuple(REF_ARCH_IDS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch):
    port = Model(get_config(arch)).param_specs()
    ref = RefModel(ref_get_config(arch)).param_specs()
    _same_specs(port, ref)
    # congruent with the parameters, one spec entry per dim at most
    params = Model(get_config(arch)).abstract_params()
    for spec, p in zip(T.leaves(port), T.leaves(params)):
        assert len(spec) <= p.ndim


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_reference(arch, mesh):
    shape, names = MESHES[mesh]
    rmesh = AbstractMesh(shape, names)
    pmesh = AxisSizes(shape, names)
    model, rmodel = Model(get_config(arch)), RefModel(ref_get_config(arch))
    for name in SHAPES:
        baxes, saxes = steps.cache_sharding_axes(SHAPES[name], pmesh)
        rb, rs = ref_steps.cache_sharding_axes(REF_SHAPES[name], rmesh)
        assert (baxes, saxes) == (rb, rs)
        quants = (False, True) if model.stack.__name__.endswith("transformer") else (False,)
        for quant in quants:
            _same_specs(model.cache_specs(batch_axes=baxes, seq_axes=saxes, quant=quant),
                        rmodel.cache_specs(batch_axes=rb, seq_axes=rs, quant=quant))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_and_abstract_inputs_equal_reference(arch, mesh):
    shape, names = MESHES[mesh]
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    model, rmodel = Model(cfg), RefModel(rcfg)
    for name in SHAPES:
        got = steps.batch_specs(cfg, SHAPES[name], AxisSizes(shape, names))
        want = ref_steps.batch_specs(rcfg, REF_SHAPES[name], AbstractMesh(shape, names))
        assert sorted(got) == sorted(want)
        assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}
        inputs = model.make_inputs(SHAPES[name], abstract=True)
        rinputs = rmodel.make_inputs(REF_SHAPES[name], abstract=True)
        assert sorted(inputs) == sorted(rinputs)
        for k, x in inputs.items():
            assert x.is_meta
            assert tuple(x.shape) == tuple(rinputs[k].shape), k
            assert str(x.dtype).removeprefix("torch.") == str(rinputs[k].dtype), k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_equal_reference(arch):
    params = Model(get_config(arch)).abstract_params()
    ref = RefModel(ref_get_config(arch)).abstract_params()
    want = dict(T.leaves_with_paths(jax.tree_util.tree_map(lambda s: s, ref)))
    got = dict(T.leaves_with_paths(params))
    assert sorted(got) == sorted(want)
    for k, p in got.items():
        assert p.is_meta
        assert tuple(p.shape) == tuple(want[k].shape), k
        assert str(p.dtype).removeprefix("torch.") == str(want[k].dtype), k


@pytest.fixture(scope="module")
def world_of_one():
    """A gloo world of one process for the module, torn down after."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_production_mesh_refuses_a_world_of_one(world_of_one):
    mesh = M.make_host_mesh(device="cpu")
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    for multi in (False, True):
        with pytest.raises(RuntimeError, match="needs a world of"):
            M.make_production_mesh(multi_pod=multi)
    with pytest.raises(ValueError, match="does not divide"):
        M.make_host_mesh(model_parallel=2, device="cpu")


def test_placements(world_of_one):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    R = Replicate()
    # a mesh dim of one rank replicates
    one = init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
    assert M.placements(P(None, ("pod", "data"), "model"), one) == (R, R, R)
    mesh3 = AxisSizes((2, 2, 2), ("pod", "data", "model"))
    assert M.placements(P(None, ("pod", "data"), None), mesh3) == (Shard(1), Shard(1), R)
    assert M.placements(P(("pod", "data"), None), mesh3) == (Shard(0), Shard(0), R)
    assert M.placements(P(None, ("data", "model")), mesh3) == (R, Shard(1), Shard(1))
    assert M.placements(P(), mesh3) == (R, R, R)
    assert M.placements(P(None, None), mesh3) == (R, R, R)
    assert M.placements(P("model", "data"), mesh3) == (R, Shard(1), Shard(0))
    assert M.placements(P("data"), mesh3, ndim=3) == (R, Shard(0), R)
    with pytest.raises(ValueError, match="mesh order"):
        M.placements(P(("data", "pod")), mesh3)
    with pytest.raises(ValueError, match="not in the mesh"):
        M.placements(P("pod"), AxisSizes((2, 2), ("data", "model")))
    with pytest.raises(ValueError, match="more entries"):
        M.placements(P(None, None, None), mesh3, ndim=2)
    with pytest.raises(ValueError, match="shards two dims"):
        M.placements(P("data", "data"), mesh3)


def test_distribute_keeps_the_whole_tensor_on_one_rank(world_of_one):
    mesh = M.make_host_mesh(device="cpu")
    x = torch.arange(30.0).reshape(5, 6)
    d = M.distribute({"a": x}, {"a": P("data", "model")}, mesh)
    assert torch.equal(d["a"].to_local(), x) and torch.equal(d["a"].full_tensor(), x)
    assert M.local_bytes(d) == x.numel() * 4


def test_prefetch_loader_places_on_the_mesh(world_of_one):
    from torch.distributed.tensor import DTensor, Replicate
    mesh = M.make_host_mesh(device="cpu")
    batches = [{"tokens": np.arange(12, dtype=np.int32).reshape(4, 3) + i} for i in range(3)]
    loader = PrefetchLoader(iter(batches), mesh=mesh, spec=P(("data",), None), depth=2)
    for want in batches:
        got = next(loader)["tokens"]
        # one rank along "data": its shard is the whole batch, replicated
        assert isinstance(got, DTensor) and tuple(got.placements) == (Replicate(), Replicate())
        assert torch.equal(got.to_local(), torch.from_numpy(want["tokens"]))
    loader.close()
