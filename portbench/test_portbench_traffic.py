"""The traffic generator, the bandwidth trace and the tenants' SLOs, on the CPU."""
import json
from collections import Counter

import numpy as np
import pytest

from portbench.harness import spec, traffic
from portbench.reference import plan as P

MIX = spec.load_traffic("longdoc")


def sizes(batches):
    return Counter((b.tenant, tuple(sorted(len(r.prompt) for r in b.requests)),
                    tuple(sorted(r.max_new_tokens for r in b.requests))) for b in batches)


def test_draws_repeat_exactly_from_a_seed():
    a, b = traffic.Stream(MIX, 2**31 + 12345, 49155), traffic.Stream(MIX, 2**31 + 12345, 49155)
    for _ in range(2 * MIX["pool_batches"] + 3):
        x, y = a.next(), b.next()
        assert x.pool_index == y.pool_index and x.tenant == y.tenant
        for r, s in zip(x.requests, y.requests):
            assert np.array_equal(r.prompt, s.prompt) and r.max_new_tokens == s.max_new_tokens
    assert np.array_equal(traffic.bandwidth(MIX, 7), traffic.bandwidth(MIX, 7))


def test_every_seed_serves_the_same_sizes_in_another_order():
    n = MIX["pool_batches"]
    streams = [traffic.Stream(MIX, s, 49155) for s in (1, 2, 3**20, 4, 5)]
    runs = [[st.next() for _ in range(3 * n)] for st in streams]
    for r in runs:
        for c in range(3):
            assert sizes(r[c * n:(c + 1) * n]) == sizes(runs[0][:n])
    orders = {tuple(b.pool_index for b in r) for r in runs}
    assert len(orders) > 1
    # every cycle ends on the pool's last block, which does not hold its longest batch
    s = MIX["strata"]
    assert len({tuple(b.pool_index for b in r[c * n - s:c * n]) for r in runs for c in (1, 2, 3)}) == 1
    assert max(b.padded_len for b in runs[0][n - s:n]) < max(b.padded_len for b in runs[0][:n])
    ids = [r[0].requests[0].prompt for r in runs]
    assert not np.array_equal(ids[0], ids[1])


def test_pool_follows_the_mix():
    pool = traffic.pool(MIX)
    lens = sorted(r.prompt_len for b in pool for r in b.rows)
    news = [r.new_tokens for b in pool for r in b.rows]
    assert len(pool) == MIX["pool_batches"] and all(len(b.rows) == MIX["batch"] for b in pool)
    assert lens[0] >= 256 and lens[-1] == 8192
    assert abs(np.median(lens) - 2048) < 100
    assert set(news) == set(range(2, 9))
    for block in traffic.blocks(MIX, pool):
        assert Counter(b.tenant for b in block) == {"tight": 2, "loose": 2}
        cost = [b.padded_positions for b in block]
        assert cost == sorted(cost, reverse=True)       # a cut block loses its cheapest
    costs = [sum(b.padded_positions for b in bl) for bl in traffic.blocks(MIX, pool)]
    assert max(costs) / min(costs) < 1.02


def test_bandwidth_trace_is_the_programs():
    from repro_torch.data.bandwidth import dcn_trace
    for seed in (0, 5, 2**31 + 9):
        assert np.array_equal(traffic.dcn_trace(seed, 2048), dcn_trace(seed, 2048))


@pytest.mark.parametrize("cell", ["granite-3-8b"])
def test_tenant_slos_demote_tight_batches_and_keep_loose_ones(cell):
    """The SLO values of the mix, found on the CPU: the program's planner and
    deadline demotion on the full configuration's graph give every tight batch of
    the pool exit 1 at every step, every loose batch the full exit, and the
    reference's re-derivation agrees step for step."""
    from repro_torch.configs import get_config
    from repro_torch.core import EdgentPlanner, lm_graph
    from repro_torch.core.latency_model import RooflineLatencyModel
    from repro_torch.serving.engine import CoInferenceStepper

    cfg = json.loads((spec.HERE / "configs" / f"{cell}.json").read_text())
    graph = lm_graph(get_config(cfg["arch"]), batch=MIX["batch"], seq=1)
    dep = cfg["deployment"]
    planner = EdgentPlanner(graph, latency_req_s=MIX["planner_slo_s"]).with_models(
        RooflineLatencyModel(chips=dep["edge_chips"], efficiency=dep["efficiency"]),
        RooflineLatencyModel(chips=dep["device_chips"], efficiency=dep["efficiency"]))
    st = CoInferenceStepper(None, graph, planner)
    tiers = P.Tiers(cfg, MIX["batch"])
    trace = traffic.bandwidth(MIX, 3)
    idx = 0
    for b in traffic.pool(MIX):
        L, steps = b.padded_len, max(r.new_tokens for r in b.rows)
        bw = float(trace[idx])
        plan = st.plan(bw)
        clock = st.step_time(plan.exit_point, plan.partition, bw) * max(1, L // 8)
        got = []
        for k in range(steps):
            bw = float(trace[idx + k])
            e = st.choose_exit(b.slo_s - clock, st.per_exit_times(plan.partition, bw),
                               steps - k, plan.exit_point)
            got.append(e)
            clock += st.step_time(e, plan.partition, bw)
        want = [1] * steps if b.tenant == "tight" else [graph.num_exits] * steps
        assert got == want
        assert P.batch_exits(tiers, MIX["planner_slo_s"], L, steps, b.slo_s, trace, idx) == got
        idx += steps
