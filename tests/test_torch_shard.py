"""The port's geography-sharded runs (``repro_torch.sim.shard``) against
the JAX package's (``repro.sim.shard``), on the CPU.

* ``tile_spec`` gives the reference's per-tile specs;
* the merged summary and handover log of a sharded run equal the
  reference's, and ``Simulation(spec).run()``, a sequential
  ``run_sharded`` and a spawn pool (``processes=2``) agree bit for bit;
* ``engine.dtype`` names a torch dtype;
* the refusals of ``_check_shardable`` are the reference's, word for word.

These replace the refusal of ``topology.shards > 1``, ``engine.trace`` and
``engine.timeline`` that ``tests/test_torch_fleet.py`` held while the port
had no sharding and no observers (``tests/test_torch_obs.py`` holds the
observers).
"""
import dataclasses

import pytest
import torch

import repro.config as ref_config
import repro_torch.sim.build as sim_build
from repro.sim import ScenarioSpec as RefSpec
from repro.sim import Simulation as RefSimulation
from repro.sim.shard import run_sharded_info as ref_run_sharded_info
from repro.sim.shard import tile_spec as ref_tile_spec
from repro_torch.sim import EngineSpec, Simulation, get_scenario
from repro_torch.sim.shard import (RID_STRIDE, run_sharded, run_sharded_info,
                                   tile_spec)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reference_constants(monkeypatch):
    monkeypatch.setattr(sim_build, "PEAK_FLOPS", ref_config.PEAK_FLOPS_BF16)
    monkeypatch.setattr(sim_build, "HBM_BW", ref_config.HBM_BW)


def _resharded(name, *, shards, num_devices, num_edges, **engine):
    base = get_scenario(name)
    return dataclasses.replace(
        base, topology=dataclasses.replace(
            base.topology, shards=shards, num_devices=num_devices,
            num_edges=num_edges),
        engine=dataclasses.replace(base.engine, **engine))


def _ref(spec):
    return RefSpec.from_json(spec.to_json())


CASES = [("smoke-lm", 2, 40, 4),          # static fleet, bandwidth-aware router
         ("smoke-mobility", 4, 80, 8),    # mobile fleet, BOCD handovers
         ("coop", 2, 40, 4)]              # joint multi-edge planner


@pytest.mark.parametrize("name,shards,nd,ne", CASES)
def test_tile_specs_equal_reference(name, shards, nd, ne):
    spec = _resharded(name, shards=shards, num_devices=nd, num_edges=ne)
    tiles = [tile_spec(spec, g) for g in range(shards)]
    assert [t.to_dict() for t in tiles] == \
        [ref_tile_spec(_ref(spec), g).to_dict() for g in range(shards)]
    assert all(t.topology.shards == 1 for t in tiles)
    assert len({t.seed for t in tiles}) == shards
    assert sum(t.workload.resolve_rate_hz(t.topology.num_devices) for t in tiles) \
        == pytest.approx(spec.workload.resolve_rate_hz(nd))


@pytest.mark.parametrize("name,shards,nd,ne", CASES)
def test_sharded_run_equals_reference(name, shards, nd, ne, reference_constants):
    """The merged summary, handover log and event counts of the port's
    sharded run equal the reference's; ``Simulation(spec).run()`` merges
    the same tiles."""
    spec = _resharded(name, shards=shards, num_devices=nd, num_edges=ne)
    m, info = run_sharded_info(spec)
    ref_m, ref_info = ref_run_sharded_info(_ref(spec))
    assert m.summary() == ref_m.summary()
    assert m.handover_log == ref_m.handover_log
    assert info == ref_info
    assert info["shards"] == shards and info["requests"] > 0
    sim = Simulation(spec).run()
    assert sim.summary() == m.summary() and sim.handover_log == m.handover_log
    assert RefSimulation(_ref(spec)).run().summary() == m.summary()


def test_spawn_pool_equals_sequential():
    """A spawn pool of two workers and a sequential run of the same spec
    merge to the same summary and handover log (the port's own constants
    on both sides: the workers import the port afresh)."""
    spec = _resharded("smoke-mobility", shards=4, num_devices=80, num_edges=8)
    seq = run_sharded(spec)
    par, info = run_sharded_info(spec, processes=2)
    assert seq.summary() == par.summary()
    assert seq.handover_log == par.handover_log
    assert seq.summary()["handovers"] > 0 and len(info["tiles"]) == 4


def test_sharded_ids_are_globally_disjoint():
    spec = _resharded("smoke-mobility", shards=4, num_devices=80, num_edges=8)
    metrics = run_sharded(spec)
    rids = {r.rid for r in metrics.records}
    assert {rid // RID_STRIDE for rid in rids} == {0, 1, 2, 3}
    for r in metrics.records:
        assert 0 <= r.device < 80
        if r.edge >= 0:
            assert r.edge // 2 == r.device // 20     # served within its tile


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_engine_dtype_is_a_torch_name(dtype):
    """A sharded spec's ``engine.dtype`` names a torch dtype (the reference
    reads a jax.numpy name); a timing-only run does not depend on it."""
    spec = _resharded("smoke-lm", shards=2, num_devices=20, num_edges=4)
    typed = dataclasses.replace(spec, engine=EngineSpec(dtype=dtype))
    assert run_sharded(typed).summary() == run_sharded(spec).summary()
    bad = dataclasses.replace(spec, engine=EngineSpec(dtype="int4x"))
    with pytest.raises(ValueError, match="engine dtype 'int4x'"):
        run_sharded(bad)


@pytest.mark.parametrize("change", [
    lambda s: dataclasses.replace(s, engine=dataclasses.replace(
        s.engine, trace="never-written.json")),
    lambda s: dataclasses.replace(s, engine=dataclasses.replace(
        s.engine, timeline="never-written.jsonl")),
    lambda s: dataclasses.replace(s, engine=dataclasses.replace(
        s.engine, real_decode=True)),
    lambda s: dataclasses.replace(s, topology=dataclasses.replace(
        s.topology, shards=1)),
], ids=["trace", "timeline", "real_decode", "unsharded"])
def test_refusals_are_the_reference_words(change):
    spec = change(_resharded("smoke-mobility", shards=4, num_devices=80,
                             num_edges=8))
    with pytest.raises(ValueError) as port:
        run_sharded(spec)
    with pytest.raises(ValueError) as ref:
        ref_run_sharded_info(_ref(spec))
    assert str(port.value) == str(ref.value)


def test_sharded_spec_has_no_single_scenario():
    spec = _resharded("smoke-mobility", shards=4, num_devices=80, num_edges=8)
    with pytest.raises(ValueError, match="no single live Scenario") as port:
        Simulation(spec).build()
    with pytest.raises(ValueError) as ref:
        RefSimulation(_ref(spec)).build()
    assert str(port.value) == str(ref.value).replace("repro.sim", "repro_torch.sim")


@pytest.mark.parametrize("topo", [dict(shards=3, num_devices=80, num_edges=8),
                                  dict(shards=4, num_devices=80, num_edges=6),
                                  dict(shards=0)])
def test_shards_must_divide_fleet(topo):
    base = get_scenario("smoke-mobility")
    with pytest.raises(ValueError, match="shards"):
        dataclasses.replace(base, topology=dataclasses.replace(base.topology, **topo))
