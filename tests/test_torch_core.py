"""The port's planner core against the JAX package's: the same graphs,
predictors and bandwidths give the same plans, BOCD posteriors and
configuration-map entries, bit for bit (host-side numpy logic)."""
import numpy as np
import pytest

import repro.config as ref_config
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_get_smoke
from repro.core import bocd as ref_bocd
from repro.core import config_map as ref_cm
from repro.core import graph as ref_graph
from repro.core import partitioner as ref_part
from repro.core.latency_model import RooflineLatencyModel as RefRoofline
from repro.core.planner import EdgentPlanner as RefPlanner
from repro.data import bandwidth as ref_bw
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import bocd, config_map, graph, partitioner
from repro_torch.core.latency_model import RooflineLatencyModel
from repro_torch.core.planner import EdgentPlanner
from repro_torch.data import bandwidth

ARCH = "llama3.2-1b"
BWS = np.geomspace(1e5, 1e11, 25)


def _tiers(roofline):
    # the reference's constants in both packages: the roofline regime of a
    # layer, and so a cut, depends on peak / bandwidth
    kw = dict(peak_flops=ref_config.PEAK_FLOPS_BF16, hbm_bw=ref_config.HBM_BW,
              efficiency=0.4)
    return roofline(chips=8, **kw), roofline(chips=1, **kw)


def _plan_tuple(p):
    return None if p is None else (p.exit_point, p.partition, p.latency_s,
                                   p.accuracy, p.feasible, p.cuts)


def _graphs(full, batch, arch=ARCH):
    rc = ref_get_config(arch) if full else ref_get_smoke(arch)
    pc = get_config(arch) if full else get_smoke_config(arch)
    return (ref_graph.lm_graph(rc, batch=batch, seq=1),
            graph.lm_graph(pc, batch=batch, seq=1))


def test_configs_match():
    for getter, ref_getter in ((get_config, ref_get_config),
                               (get_smoke_config, ref_get_smoke)):
        a, b = getter(ARCH), ref_getter(ARCH)
        assert a.__dict__ == b.__dict__
        assert (a.padded_vocab, a.padded_heads, a.param_count()) == \
            (b.padded_vocab, b.padded_heads, b.param_count())


def _assert_graphs_equal(rg, pg):
    assert (rg.name, rg.accuracy, rg.input_bytes, rg.result_bytes) == \
        (pg.name, pg.accuracy, pg.input_bytes, pg.result_bytes)
    assert len(rg.branches) == len(pg.branches)
    for rb, pb in zip(rg.branches, pg.branches):
        assert [(l.name, l.kind, l.features, l.out_bytes, l.flops,
                 l.bytes_moved, l.state_bytes) for l in rb] == \
            [(l.name, l.kind, l.features, l.out_bytes, l.flops,
              l.bytes_moved, l.state_bytes) for l in pb]
    for e in range(1, rg.num_exits + 1):
        for p in range(len(rg.branches[e - 1]) + 1):
            assert rg.cut_bytes(e, p) == pg.cut_bytes(e, p)


@pytest.mark.parametrize("full", [True, False], ids=["full", "smoke"])
def test_lm_graph_matches(full):
    _assert_graphs_equal(*_graphs(full, batch=4))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b"])
@pytest.mark.parametrize("full", [True, False], ids=["full", "smoke"])
def test_ssm_family_graphs_match(full, arch):
    """The ssm and hybrid graphs, including the recurrent state that ships
    with a cut (``state_bytes``) and so the bytes of every cut."""
    rg, pg = _graphs(full, batch=4, arch=arch)
    _assert_graphs_equal(rg, pg)
    assert all(l.state_bytes > 0 for l in pg.branches[-1][:-1])


@pytest.mark.parametrize("full", [True, False], ids=["full", "smoke"])
@pytest.mark.parametrize("slo", [0.004, 0.05, 0.4])
def test_plans_match_over_bandwidth_sweep(full, slo):
    rg, pg = _graphs(full, batch=4)
    rfe, rfd = _tiers(RefRoofline)
    pfe, pfd = _tiers(RooflineLatencyModel)
    rp = RefPlanner(rg, latency_req_s=slo).with_models(rfe, rfd)
    pp = EdgentPlanner(pg, latency_req_s=slo).with_models(pfe, pfd)
    for bw in BWS:
        assert _plan_tuple(ref_part.optimize(rg, rfe, rfd, bw, slo)) == \
            _plan_tuple(partitioner.optimize(pg, pfe, pfd, bw, slo))
        assert _plan_tuple(rp.plan(bw)) == _plan_tuple(pp.plan(bw))
        for speeds in ((1.0,), (1.0, 2.0), (0.5, 1.0, 4.0)):
            kw = dict(device_load=1.5, edge_bw_bps=bw * 10)
            assert _plan_tuple(ref_part.optimize_multi(rg, rfe, rfd, bw, slo, speeds, **kw)) \
                == _plan_tuple(partitioner.optimize_multi(pg, pfe, pfd, bw, slo, speeds, **kw))
            assert _plan_tuple(rp.plan_multi(bw, speeds, **kw)) == \
                _plan_tuple(pp.plan_multi(bw, speeds, **kw))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b"])
@pytest.mark.parametrize("slo", [0.004, 0.05, 0.4])
def test_ssm_family_plans_match(arch, slo):
    """Edgent plans of the full-size ssm and hybrid graphs, whose cuts
    carry the recurrent state, over the bandwidth sweep."""
    rg, pg = _graphs(True, batch=4, arch=arch)
    rfe, rfd = _tiers(RefRoofline)
    pfe, pfd = _tiers(RooflineLatencyModel)
    rp = RefPlanner(rg, latency_req_s=slo).with_models(rfe, rfd)
    pp = EdgentPlanner(pg, latency_req_s=slo).with_models(pfe, pfd)
    for bw in BWS:
        assert _plan_tuple(rp.plan(bw)) == _plan_tuple(pp.plan(bw))
        kw = dict(device_load=1.5, edge_bw_bps=bw * 10)
        assert _plan_tuple(rp.plan_multi(bw, (1.0, 2.0), **kw)) == \
            _plan_tuple(pp.plan_multi(bw, (1.0, 2.0), **kw))


@pytest.mark.parametrize("trace", ["dcn", "lte"])
def test_dynamic_plans_match(trace):
    """Algorithm 2 map + Algorithm 3 BOCD-driven plans on the serve
    launcher's setup, step by step."""
    rg, pg = _graphs(True, batch=4)
    make = {"dcn": "dcn_trace", "lte": "belgium_lte_like"}[trace]
    rt, pt = getattr(ref_bw, make)(0, 600), getattr(bandwidth, make)(0, 600)
    assert np.array_equal(rt, pt)
    hist = [pt[i: i + 49] for i in range(0, 490, 49)]
    rp = RefPlanner(rg, latency_req_s=0.4).with_models(*_tiers(RefRoofline))
    pp = EdgentPlanner(pg, latency_req_s=0.4).with_models(*_tiers(RooflineLatencyModel))
    rp.offline_dynamic(hist)
    pp.offline_dynamic(hist)
    assert {k: vars(v) for k, v in rp.dynamic_opt.cmap.items()} == \
        {k: vars(v) for k, v in pp.dynamic_opt.cmap.items()}
    for bw in pt[490:]:
        assert _plan_tuple(rp.plan(bw, dynamic=True)) == \
            _plan_tuple(pp.plan(bw, dynamic=True))
    assert rp.dynamic_opt.transitions == pp.dynamic_opt.transitions


def test_bandwidth_generators_match():
    for seed in (0, 3):
        for a, b in zip(ref_bw.oboe_like_traces(seed, num=12),
                        bandwidth.oboe_like_traces(seed, num=12)):
            assert np.array_equal(a, b)
        for t in ("foot", "car"):
            assert np.array_equal(ref_bw.belgium_lte_like(seed, 300, t),
                                  bandwidth.belgium_lte_like(seed, 300, t))


@pytest.mark.parametrize("hazard,max_run", [(1 / 60, 256), (1 / 30, 64)])
def test_bocd_posteriors_match(hazard, max_run):
    rng = np.random.default_rng(0)
    xs = np.concatenate([rng.normal(m, 0.3, 70) for m in (5.0, 1.0, 3.0)])
    rd = ref_bocd.BOCD(hazard=hazard, max_run=max_run)
    pd = bocd.BOCD(hazard=hazard, max_run=max_run)
    for x in xs:
        assert rd.update(float(x)) == pd.update(float(x))
        assert np.array_equal(rd.r_prob, pd.r_prob)
        assert np.array_equal(rd.mu, pd.mu) and np.array_equal(rd.beta, pd.beta)
        assert rd.map_run == pd.map_run
    rs, ps = ref_bocd.BandwidthStateDetector(hazard=hazard), \
        bocd.BandwidthStateDetector(hazard=hazard)
    assert [rs.update(x) for x in xs] == [ps.update(x) for x in xs]
    assert rs.changes == ps.changes


def test_bocd_bank_matches():
    rng = np.random.default_rng(7)
    rb, pb = ref_bocd.BOCDBank(4, hazard=1 / 30.0, max_run=96), \
        bocd.BOCDBank(4, hazard=1 / 30.0, max_run=96)
    for _ in range(150):
        x = rng.uniform(0.5, 6.0, 4)
        assert np.array_equal(rb.update(x), pb.update(x))
        assert np.array_equal(rb.r_prob, pb.r_prob)


class _Const:
    def __init__(self, t):
        self.t = t

    def predict(self, layer):
        return self.t


def _toy(mod_graph):
    branches = [[mod_graph.GraphLayer(f"l{i}_{j}", "fc", {"in_size": 1.0, "out_size": 1.0},
                                      out_bytes=1000) for j in range(2 * i)]
                for i in range(1, 4)]
    return mod_graph.InferenceGraph("toy", branches, accuracy=[0.5, 0.7, 0.9],
                                    input_bytes=4000, result_bytes=8)


@pytest.mark.parametrize("fe,fd,req", [(0.01, 0.05, 1.0), (0.4, 2.0, 1.0),
                                       (0.001, 0.02, 0.03)])
def test_config_map_matches(fe, fd, req):
    states = [1e4, 1e5, 1e6, 3e6]
    rmap = ref_cm.build_map(_toy(ref_graph), _Const(fe), _Const(fd), states, req)
    pmap = config_map.build_map(_toy(graph), _Const(fe), _Const(fd), states, req)
    assert {k: vars(v) for k, v in rmap.items()} == {k: vars(v) for k, v in pmap.items()}
    for s in (2e5, 9e5, 5e3):
        assert vars(ref_cm.lookup(rmap, s)) == vars(config_map.lookup(pmap, s))
    traces = [[1.0, 2.0, 3.0], [10.0, 10.0], []]
    assert ref_cm.sketch_states(traces) == config_map.sketch_states(traces)
    assert ref_cm.reward_fn(0.8, 0.5, 1.0) == config_map.reward_fn(0.8, 0.5, 1.0)


def test_profiler_times_torch_layers():
    """The port's profiler times plain torch callables; its records feed
    the offline static configurator (Algorithm 1's regression stage)."""
    import torch

    from repro_torch.core import profiler

    rng = np.random.default_rng(0)
    params = {f"w{j}": torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))
              for j in range(4)}

    def fc(j):
        return graph.GraphLayer(f"fc{j}", "fc", {"in_size": 8.0 * (j + 1), "out_size": 8.0},
                                out_bytes=32, run=lambda p, x, j=j: torch.relu(x @ p[f"w{j}"]))

    layers = [fc(j) for j in range(4)]
    g = graph.InferenceGraph("toy", [layers[:2], layers], accuracy=[0.6, 0.9],
                             input_bytes=32, result_bytes=8)
    x = torch.ones((1, 8))
    profs = profiler.profile_all_branches(g, params, x, repeats=2)
    assert [p.name for p in profs] == ["fc0", "fc1", "fc2", "fc3"]
    assert all(p.latency_s > 0 and p.kind == "fc" for p in profs)
    recs = profiler.profiles_to_records(profs, scale=20.0)
    assert [r.latency_s for r in recs] == [20.0 * p.latency_s for p in profs]
    longest = profiler.profile_graph(g, params, x, repeats=2, warmup=1)
    assert [p.name for p in longest] == ["fc0", "fc1", "fc2", "fc3"]
    planner = EdgentPlanner(g, latency_req_s=1.0)
    planner.offline_static(params, x)
    plan = planner.plan(1e6)
    assert plan.exit_point in (1, 2) and plan.partition >= 0
