"""The port's ServingEngine against the JAX package's: the same 6 requests,
batch 2, static and dynamic planning, on the reference's parameters
(carried over by ``params_from_numpy``) and the reference's roofline
constants.  Tokens, summary and exits must be equal; the stepper's
``cache_stats`` keeps the reference's schema."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as ref_config
from repro.configs import get_smoke_config as ref_get_smoke
from repro.core import EdgentPlanner as RefPlanner
from repro.core import lm_graph as ref_lm_graph
from repro.core.latency_model import RooflineLatencyModel as RefRoofline
from repro.data.bandwidth import dcn_trace as ref_dcn_trace
from repro.models import Model as RefModel
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefEngine
from repro.serving.tiers import Link as RefLink
from repro_torch.configs import get_smoke_config
from repro_torch.core import EdgentPlanner, lm_graph
from repro_torch.core.latency_model import RooflineLatencyModel
from repro_torch.data.bandwidth import dcn_trace
from repro_torch.kernels import launch_counts
from repro_torch.models import Model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.tiers import Link

ARCH = "llama3.2-1b"


def _setups(arch):
    rcfg, cfg = ref_get_smoke(arch), get_smoke_config(arch)
    rmodel, model = RefModel(rcfg), Model(cfg)
    rparams = rmodel.init_params(jax.random.key(0), dtype=jnp.float32)
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, rparams),
                               device="cpu")
    return (rcfg, rmodel, rparams), (cfg, model, params)


@pytest.fixture(scope="module")
def setups():
    return _setups(ARCH)


def _requests(cls, vocab):
    rs = np.random.default_rng(0)
    # mixed prompt lengths exercise the left padding
    return [cls(rid=i, prompt=rs.integers(0, vocab, 6 + (i % 3)).astype(np.int32),
                max_new_tokens=4 + (i % 2), slo_s=0.5 if i % 4 else 0.02,
                arrival_s=0.001 * i)
            for i in range(6)]


def _planner(planner_cls, roofline, graph, dynamic, trace):
    kw = dict(peak_flops=ref_config.PEAK_FLOPS_BF16, hbm_bw=ref_config.HBM_BW,
              efficiency=0.4)
    p = planner_cls(graph, latency_req_s=0.5)
    p.with_models(roofline(chips=8, **kw), roofline(chips=1, **kw))
    if dynamic:
        p.offline_dynamic([trace[i: i + 49] for i in range(0, 490, 49)])
    return p


def _serve_both(setups, dynamic):
    (rcfg, rmodel, rparams), (cfg, model, params) = setups
    rtrace, trace = ref_dcn_trace(0, 512), dcn_trace(0, 512)
    rgraph, graph = ref_lm_graph(rcfg, batch=2, seq=1), lm_graph(cfg, batch=2, seq=1)
    reng = RefEngine(rmodel, rparams, rgraph,
                     _planner(RefPlanner, RefRoofline, rgraph, dynamic, rtrace),
                     RefLink(trace_bps=rtrace), batch_size=2, dtype=jnp.float32,
                     dynamic=dynamic)
    eng = ServingEngine(model, params, graph,
                        _planner(EdgentPlanner, RooflineLatencyModel, graph, dynamic, trace),
                        Link(trace_bps=trace), batch_size=2, dtype=torch.float32,
                        dynamic=dynamic)
    rstats = reng.serve(_requests(RefRequest, rcfg.vocab_size))
    before = launch_counts()
    stats = eng.serve(_requests(Request, cfg.vocab_size))
    assert launch_counts() == before            # the CPU path launches nothing
    assert stats.tokens == rstats.tokens
    assert stats.summary() == rstats.summary()
    assert stats.exits == rstats.exits
    assert stats.partitions == rstats.partitions
    assert stats.latencies == rstats.latencies
    # the last batch may be short: requests arrive one by one
    assert eng.last_hidden.shape[1:] == (1, cfg.d_model)
    assert torch.isfinite(eng.last_hidden).all()
    return stats


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_serve_matches_reference(setups, dynamic):
    _serve_both(setups, dynamic)


def test_serve_rwkv6_matches_reference():
    """Smoke rwkv6-3b through its scan (the kernel's plain version here)
    and the exit head gives the reference's tokens, plans and latencies."""
    _serve_both(_setups("rwkv6-3b"), dynamic=False)


def test_serve_dense_impl_matches_kernel_impl(setups):
    _, (cfg, model, params) = setups
    out = {}
    for impl in ("kernel", "dense"):
        graph = lm_graph(cfg, batch=2, seq=1)
        eng = ServingEngine(model, params, graph,
                            _planner(EdgentPlanner, RooflineLatencyModel, graph,
                                     False, None),
                            Link(trace_bps=dcn_trace(0, 512)), batch_size=2,
                            impl=impl)
        out[impl] = (eng.serve(_requests(Request, cfg.vocab_size)).tokens,
                     eng.last_hidden)
    assert out["kernel"][0] == out["dense"][0]
    np.testing.assert_allclose(out["kernel"][1].numpy(), out["dense"][1].numpy(),
                               rtol=2e-5, atol=2e-5)


def test_cache_stats_schema_matches_reference(setups):
    (rcfg, rmodel, rparams), (cfg, model, params) = setups
    from repro.serving import CoInferenceStepper as RefStepper
    from repro_torch.serving import CoInferenceStepper
    rgraph, graph = ref_lm_graph(rcfg, batch=2, seq=1), lm_graph(cfg, batch=2, seq=1)
    rs = RefStepper(rmodel, rgraph, _planner(RefPlanner, RefRoofline, rgraph, False, None))
    ps = CoInferenceStepper(model, graph,
                            _planner(EdgentPlanner, RooflineLatencyModel, graph, False, None))
    for bw in (1e6, 1e6, 5e9, 1.0001e6):
        assert vars(rs.plan(bw)) == vars(ps.plan(bw))
        assert rs.per_exit_times(1, bw) == ps.per_exit_times(1, bw)
        assert rs.per_exit_times_cached(1, bw, device_load=1.5) == \
            ps.per_exit_times_cached(1, bw, device_load=1.5)
        assert rs.per_exit_times_coop_cached(2, (1.0, 2.0), bw, edge_bw_bps=1e9) == \
            ps.per_exit_times_coop_cached(2, (1.0, 2.0), bw, edge_bw_bps=1e9)
    for ge in (1, 2, 3, None, 2):
        rs.decode_fn(ge)
        ps.decode_fn(ge)
        assert rs.to_model_exit(ge or 1) == ps.to_model_exit(ge or 1)

    def schema(d):
        return {k: schema(v) if isinstance(v, dict) else type(v).__name__
                for k, v in d.items()}
    assert schema(rs.cache_stats()) == schema(ps.cache_stats())
    assert rs.cache_stats() == ps.cache_stats()


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_serve_launcher_on_cpu(dynamic, capsys):
    """``python -m repro_torch.launch.serve --device cpu`` serves the smoke
    config through the plain versions; the default device is the card."""
    from repro_torch.launch import serve
    argv = ["--device", "cpu", "--requests", "3", "--new-tokens", "2", "--batch", "2"]
    stats = serve.main(argv + (["--dynamic"] if dynamic else []))
    assert stats.summary()["requests"] == 3
    assert all(len(t) == 2 for t in stats.tokens.values())
    assert "summary:" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(["--requests", "1"])


def test_serve_launcher_rwkv6_on_cpu(capsys):
    from repro_torch.launch import serve
    stats = serve.main(["--arch", "rwkv6-3b", "--device", "cpu", "--requests", "2",
                        "--new-tokens", "3", "--batch", "2"])
    assert all(len(t) == 3 for t in stats.tokens.values())
    assert "served rwkv6-3b-smoke on cpu" in capsys.readouterr().out
