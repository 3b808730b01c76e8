"""The port's Edgent path on BranchyAlexNet against the JAX package's, on the
CPU: Algorithms 1-3 over the paper's own model, the two-tier executor and
the early-exit policies.

* Plans: one set of ``ProfileRecord`` rows, built once by the reference's
  ``profile_all_branches`` and scaled as ``offline_static`` scales them, is
  fitted in each package and passed through ``with_models``; the two
  planners' plans are equal over quickstart's five bandwidths, over
  ``tests/test_system.py``'s bandwidth, SLO and Fig. 9 grids, and through
  the dynamic optimiser (configuration map, BOCD states, transitions) on
  the same traces.  Plans from ``offline_static`` rest on each host's own
  timings, so they are not compared across packages.
* ``tests/test_system.py``'s properties hold on the port's own CPU
  ``offline_static``: exit monotone in bandwidth, exit and partition
  monotone in the SLO, Edgent feasible where both single-tier methods miss,
  dynamic at least as good as static under dynamic bandwidth.
* ``TwoTierExecutor``: its output equals ``forward_exit``; ``transfer_s``
  and ``hops_s`` equal the reference's exactly for 1-cut and k-cut plans;
  ``latency_s`` is the sum of its parts.
* The three early-exit policies select what the reference's select.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import early_exit as ref_ee
from repro.core import latency_model as ref_lm
from repro.core import profiler as ref_prof
from repro.core.coinference import TwoTierExecutor as RefExecutor
from repro.core.partitioner import CoInferencePlan as RefPlan
from repro.core.planner import EdgentPlanner as RefPlanner
from repro.data import bandwidth as ref_bw
from repro_torch.core import EdgentPlanner, alexnet_graph, early_exit
from repro_torch.core.coinference import TwoTierExecutor
from repro_torch.core.config_map import reward_fn
from repro_torch.core.latency_model import (ProfileRecord,
                                            RegressionLatencyModel)
from repro_torch.core.partitioner import CoInferencePlan, branch_latency
from repro_torch.data import bandwidth
from repro_torch.models.alexnet import BranchyAlexNet, BranchyAlexNetConfig
from repro_torch.models.convert import alexnet_params_from_numpy

KBPS = 125                                  # bytes/s in one kbps
QUICKSTART_KBPS = (50, 100, 250, 500, 1000)
SYSTEM_KBPS = (25, 50, 100, 250, 500, 1000, 1500, 3000)
SLO_MS = (100, 200, 300, 500, 800, 1200)
FIG9_KBPS = (25, 40, 50, 75, 100, 200, 400)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's torch work: the suite runs files
    side by side in worker processes on a shared CPU, and the port's
    ``offline_static`` below times layers on the host's clock."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def x_np():
    return np.asarray(jax.random.normal(jax.random.key(1), (1, 32, 32, 3)))


@pytest.fixture(scope="module")
def port(alexnet_setup):
    """The port's net, its graph and the reference's parameters on the
    CPU."""
    net = BranchyAlexNet(BranchyAlexNetConfig())
    params = alexnet_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, alexnet_setup[1]), device="cpu")
    return net, alexnet_graph(net), params


@pytest.fixture(scope="module")
def records(alexnet_setup, x_np):
    """(edge, device) records from one reference profile, scaled to the
    paper's endpoints as ``offline_static`` scales them."""
    _, params, graph = alexnet_setup
    profiles = ref_prof.profile_all_branches(graph, params, x_np)
    host_full = sum(p.latency_s for p in profiles if not p.name.startswith("b"))
    edge = ref_prof.profiles_to_records(profiles, scale=0.010 / host_full)
    dev = ref_prof.profiles_to_records(profiles, scale=2.3 / host_full)
    return edge, dev


def _planners(alexnet_setup, port, records, slo=1.0):
    """(reference, port) planners on fits of the same records."""
    edge, dev = records
    ref = RefPlanner(alexnet_setup[2], latency_req_s=slo).with_models(
        ref_lm.RegressionLatencyModel().fit(edge),
        ref_lm.RegressionLatencyModel().fit(dev))

    def fit(recs):
        return RegressionLatencyModel().fit(
            [ProfileRecord(r.kind, dict(r.features), r.latency_s) for r in recs])
    ported = EdgentPlanner(port[1], latency_req_s=slo).with_models(fit(edge), fit(dev))
    return ref, ported


def _plan_tuple(p):
    return (p.exit_point, p.partition, p.latency_s, p.accuracy, p.feasible,
            tuple(p.cuts))


def _set_slo(planner, slo):
    planner.latency_req_s = slo
    planner.static_opt.latency_req_s = slo


# ------------------------------------------------------- plans, one fit
def test_fits_equal_reference(alexnet_setup, port, records):
    ref, ported = _planners(alexnet_setup, port, records)
    for a, b in ((ref.f_edge, ported.f_edge), (ref.f_device, ported.f_device)):
        assert a.theta.keys() == b.theta.keys()
        for k in a.theta:
            np.testing.assert_array_equal(a.theta[k], b.theta[k])
        assert a.r2() == b.r2()


@pytest.mark.parametrize("grid", ["quickstart", "system-bandwidth", "system-slo",
                                  "fig9"])
def test_static_plans_equal_reference(alexnet_setup, port, records, grid):
    ref, ported = _planners(alexnet_setup, port, records)
    if grid == "quickstart":
        points = [(kbps, 1.0) for kbps in QUICKSTART_KBPS]
    elif grid == "system-bandwidth":
        points = [(kbps, 1.0) for kbps in SYSTEM_KBPS]
    elif grid == "system-slo":
        points = [(500, ms / 1e3) for ms in SLO_MS]
    else:
        points = [(kbps, float(slo)) for kbps in FIG9_KBPS
                  for slo in np.linspace(0.05, 2.2, 60)]
    for kbps, slo in points:
        _set_slo(ref, slo)
        _set_slo(ported, slo)
        assert _plan_tuple(ported.plan(kbps * KBPS)) == \
            _plan_tuple(ref.plan(kbps * KBPS)), (kbps, slo)


@pytest.mark.parametrize("num,length,hi_mbps", [(80, 300, 6.0), (428, 120, 10.0)])
def test_dynamic_plans_equal_reference(alexnet_setup, port, records, num,
                                       length, hi_mbps):
    """Algorithm 2's map over Oboe-like traces, then Algorithm 3 (BOCD)
    over a Belgium-LTE-like trace: the same map, states, plans and
    transitions."""
    ref, ported = _planners(alexnet_setup, port, records)
    traces = bandwidth.oboe_like_traces(seed=0, num=num)
    ref_traces = ref_bw.oboe_like_traces(seed=0, num=num)
    assert all(np.array_equal(a, b) for a, b in zip(traces, ref_traces))
    ref.offline_dynamic([t.tolist() for t in ref_traces])
    ported.offline_dynamic([t.tolist() for t in traces])
    assert ported.dynamic_opt.cmap.keys() == ref.dynamic_opt.cmap.keys()
    for k, e in ref.dynamic_opt.cmap.items():
        assert vars(ported.dynamic_opt.cmap[k]) == vars(e)
    lte = bandwidth.belgium_lte_like(seed=3, length=length, transport="bus",
                                     hi_mbps=hi_mbps)
    assert np.array_equal(lte, ref_bw.belgium_lte_like(
        seed=3, length=length, transport="bus", hi_mbps=hi_mbps))
    for bw in lte:
        assert _plan_tuple(ported.plan(bw, dynamic=True)) == \
            _plan_tuple(ref.plan(bw, dynamic=True))
        assert ported.dynamic_opt.state == ref.dynamic_opt.state
    assert ported.dynamic_opt.transitions == ref.dynamic_opt.transitions > 0


# --------------------------------------- the paper's claims, port only
@pytest.fixture(scope="module")
def port_planner(port, x_np):
    _, graph, params = port
    return EdgentPlanner(graph, latency_req_s=1.0).offline_static(
        params, torch.from_numpy(x_np.copy()))


def test_offline_static_anchors_the_tiers(port_planner):
    """``offline_static`` scales this host's main-branch time to the
    paper's endpoints (2.3 s device-only, 10 ms edge) and fits every
    Table-I kind."""
    g = port_planner.graph
    main = g.branches[-1]
    assert port_planner.device_factor / port_planner.edge_factor == \
        pytest.approx(230.0)
    assert set(port_planner.f_edge.theta) == \
        {"conv", "relu", "lrn", "pool", "dropout", "fc"}
    full_edge = sum(port_planner.f_edge.predict(l) for l in main)
    assert 0.0 < full_edge < 0.1


def test_exit_monotone_in_bandwidth(port_planner):
    _set_slo(port_planner, 1.0)
    exits = [p.exit_point for p in (port_planner.plan(k * KBPS) for k in SYSTEM_KBPS)
             if p.feasible]
    assert exits == sorted(exits), exits
    assert exits[-1] == 5


def test_latency_decreases_with_bandwidth_fixed_plan(port_planner):
    g, fe, fd = port_planner.graph, port_planner.f_edge, port_planner.f_device
    lats = [branch_latency(g, 5, 22, fe, fd, k * KBPS) for k in (50, 100, 500, 1000)]
    assert all(a >= b for a, b in zip(lats, lats[1:]))


def test_exit_partition_monotone_in_slo(port_planner):
    plans = []
    for ms in SLO_MS:
        _set_slo(port_planner, ms / 1e3)
        p = port_planner.plan(500 * KBPS)
        if p.feasible:
            plans.append((p.exit_point, p.partition))
    _set_slo(port_planner, 1.0)
    exits = [e for e, _ in plans]
    assert exits == sorted(exits), plans
    assert len(exits) >= 3
    # Algorithm 1 takes an exit's fastest partition, whatever the SLO
    for (e0, p0), (e1, p1) in zip(plans, plans[1:]):
        assert e1 != e0 or p1 == p0, plans


def test_edgent_beats_single_tier_methods(port_planner):
    """Fig. 9: some (bandwidth, deadline) where Edgent is feasible while
    both device-only and edge-only miss."""
    g, fe, fd = port_planner.graph, port_planner.f_edge, port_planner.f_device
    found = False
    for kbps in FIG9_KBPS:
        bw = kbps * KBPS
        for slo in np.linspace(0.05, 2.2, 60):
            _set_slo(port_planner, slo)
            plan = port_planner.plan(bw)
            if plan.feasible and branch_latency(g, 5, 0, fe, fd, bw) > slo \
                    and branch_latency(g, 5, 22, fe, fd, bw) > slo:
                found = True
                break
        if found:
            break
    _set_slo(port_planner, 1.0)
    assert found


def test_dynamic_beats_static_under_dynamic_bandwidth(port_planner):
    """Fig. 11: the dynamic configurator's mean reward is at least
    comparable to the static one's."""
    _set_slo(port_planner, 1.0)
    port_planner.offline_dynamic(
        [t.tolist() for t in bandwidth.oboe_like_traces(seed=0, num=80)])
    lte = bandwidth.belgium_lte_like(seed=3, length=300, transport="bus",
                                     hi_mbps=6.0)
    g, fe, fd = port_planner.graph, port_planner.f_edge, port_planner.f_device
    rew_static, rew_dyn = [], []
    for b in lte:
        ps = port_planner.plan(b, dynamic=False)
        pd = port_planner.plan(b, dynamic=True)
        rew_static.append(reward_fn(ps.accuracy, branch_latency(
            g, ps.exit_point, ps.partition, fe, fd, b), 1.0))
        rew_dyn.append(reward_fn(pd.accuracy, branch_latency(
            g, pd.exit_point, pd.partition, fe, fd, b), 1.0))
    assert np.mean(rew_dyn) >= 0.95 * np.mean(rew_static)


# ------------------------------------------------------------- executor
PLANS = [  # (exit, partition, cuts, edge slowdowns)
    (5, 8, (), None),
    (5, 0, (), None),
    (5, 22, (), None),
    (3, 19, (), None),
    (2, 12, (4, 9, 12), [1.0, 2.0, 4.0]),
    (5, 15, (3, 15), [1.5, 3.0]),
]


@pytest.mark.parametrize("exit_point,partition,cuts,slowdowns", PLANS)
def test_executor_matches_reference_accounting(alexnet_setup, port, x_np,
                                               exit_point, partition, cuts,
                                               slowdowns):
    net, graph, params = port
    kw = dict(bandwidth_bps=125e3, device_slowdown=5.0, edge_slowdown=1.5,
              edge_slowdowns=slowdowns, edge_bw_bps=2e6)
    x = torch.from_numpy(x_np.copy())
    res = TwoTierExecutor(graph, params, **kw).run(
        CoInferencePlan(exit_point, partition, 0.0, 0.8, cuts=cuts), x)
    ref = RefExecutor(alexnet_setup[2], alexnet_setup[1], **kw).run(
        RefPlan(exit_point, partition, 0.0, 0.8, cuts=cuts), x_np)
    with torch.no_grad():
        want = net.forward_exit(params, x, exit_point)
    assert torch.equal(res.output, want)
    np.testing.assert_allclose(res.output.numpy(), np.asarray(ref.output),
                               atol=1e-4, rtol=1e-4)
    assert (res.exit_point, res.partition) == (ref.exit_point, ref.partition) \
        == (exit_point, partition)
    assert res.transfer_s == ref.transfer_s
    assert res.hops_s == ref.hops_s
    if partition > 0:
        assert res.transfer_s == graph.input_bytes / 125e3 \
            + graph.cut_bytes(exit_point, partition) / 125e3
    else:
        assert res.transfer_s == 0.0 and res.edge_s == 0.0
    assert (res.hops_s > 0) == (len(cuts) > 1)
    assert res.latency_s == res.edge_s + res.device_s + res.transfer_s + res.hops_s
    assert res.device_s > 0 or partition == len(graph.branches[exit_point - 1])


def test_executor_bills_the_bandwidth_it_is_given(port, x_np):
    _, graph, params = port
    ex = TwoTierExecutor(graph, params, bandwidth_bps=1.0)
    res = ex.run(CoInferencePlan(4, 20, 0.0, 0.7), torch.from_numpy(x_np.copy()),
                 bandwidth_bps=250 * KBPS)
    assert res.transfer_s == graph.input_bytes / (250 * KBPS) \
        + graph.result_bytes / (250 * KBPS)


# --------------------------------------------------------- early exit
def test_early_exit_policies_select_as_reference():
    rng = np.random.default_rng(11)
    for e in range(1, 6):
        assert early_exit.StaticExitPolicy(e).select() == \
            ref_ee.StaticExitPolicy(e).select() == e
    for _ in range(200):
        conf = [rng.random(int(rng.integers(1, 5))) for _ in range(5)]
        thr = float(rng.random())
        assert early_exit.ConfidenceExitPolicy(thr, 5).select(conf) == \
            ref_ee.ConfidenceExitPolicy(thr, 5).select(conf)
        lats = sorted(rng.random(5).tolist())
        floor = int(rng.integers(1, 6))
        budget = float(rng.random())
        assert early_exit.DeadlineDemotionPolicy(lats, floor).select(budget) == \
            ref_ee.DeadlineDemotionPolicy(lats, floor).select(budget)
