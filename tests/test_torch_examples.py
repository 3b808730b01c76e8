"""The port's example scripts (``examples/torch_*.py``) run in process on
the CPU (``--device cpu``) with cut arguments, each held against the
reference's script where its output does not rest on wall-clock fits:

* ``torch_llm_early_exit_serving`` (static and ``--dynamic``, 4 requests of
  4 tokens) on the reference's parameters (``params_from_numpy``), with the
  reference's roofline constants in its latency models: the serving
  summary equal to the reference script's, the exit head's token equal and
  its conf and entropy within 1e-5;
* ``torch_serve_fleet``'s spec (its horizon cut to 4 s) through
  ``test_torch_fleet.hold_against_reference`` (summaries, token streams
  and decode counters against the reference's run of the same spec), and
  the script's own lines;
* ``torch_serve_dynamic_bandwidth``: the configuration map's state count
  and the BOCD state transitions equal the reference's on the same traces
  (neither depends on the planner's fitted latency models);
* ``torch_quickstart``: its plans have ``tests/test_system.py``'s
  properties (its planner is fitted to wall-clock layer timings,
  ``tests/conftest.py``, so plans are not held for equality);
* ``torch_train_branchy_alexnet`` (4 steps, a failure injected): the
  restart line and five exit accuracies (its step is held by
  ``test_torch_train.py::test_branchy_alexnet_example_step_matches_reference``).

Every script raises at its default ``--device cuda`` without a card.
"""
import dataclasses
import functools
import importlib.util
import json
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.config as ref_config
import repro_torch.sim.build as sim_build
from repro.core import config_map as ref_cm
from repro.core.runtime_optimizer import DynamicRuntimeOptimizer
from repro.data.bandwidth import belgium_lte_like as ref_lte
from repro.data.bandwidth import oboe_like_traces as ref_oboe
from repro.sim import ScenarioSpec as RefScenarioSpec
from repro_torch.core.latency_model import RooflineLatencyModel
from repro_torch.models.convert import params_from_numpy
from test_torch_fleet import _port_run, _ref_run, hold_against_reference

ROOT = Path(__file__).resolve().parents[1]
EXIT_TOL = 1e-5
LLM_ARGS = ["--requests", "4", "--new-tokens", "4"]
FLEET_HORIZON_S = 4.0
SCRIPTS = ("torch_quickstart", "torch_serve_dynamic_bandwidth",
           "torch_llm_early_exit_serving", "torch_serve_fleet",
           "torch_train_branchy_alexnet")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs files side by side on few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    """``examples/<name>.py`` loaded as a fresh module."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", SCRIPTS)
def test_scripts_need_a_card_by_default(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        _example(name).main([])


# ------------------------------------------------------------------ LLM serving
@pytest.fixture(scope="module")
def llm_reference():
    """The reference script's run, static and ``--dynamic``, at LLM_ARGS:
    its serving summary, its exit head's outputs and its parameters."""
    mod = _example("llm_early_exit_serving")
    runs = {}
    for dynamic in (False, True):
        rec = {}

        class Engine(mod.ServingEngine):
            def serve(self, requests):
                stats = super().serve(requests)
                rec["summary"] = stats.summary()
                return stats

        class Model(mod.Model):
            def init_params(self, *a, **kw):
                params = super().init_params(*a, **kw)
                rec["params"] = jax.tree_util.tree_map(np.asarray, params)
                return params

        def exit_confidence(h, emb, _inner=mod.exit_ops.exit_confidence):
            out = _inner(h, emb)
            rec["exit_head"] = {k: np.asarray(v)[0, 0].item() for k, v in out.items()}
            return out

        argv = ["llm_early_exit_serving.py", *LLM_ARGS] + (["--dynamic"] if dynamic else [])
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, "ServingEngine", Engine)
            mp.setattr(mod, "Model", Model)
            mp.setattr(mod, "exit_ops", types.SimpleNamespace(exit_confidence=exit_confidence))
            mp.setattr(sys, "argv", argv)
            mod.main()
        runs[dynamic] = rec
    return runs


@pytest.mark.parametrize("dynamic", [False, True])
def test_llm_early_exit_serving_matches_reference(llm_reference, dynamic, monkeypatch,
                                                  capsys):
    ref = llm_reference[dynamic]
    mod = _example("torch_llm_early_exit_serving")

    class Model(mod.Model):
        def init_params(self, *a, **kw):
            return params_from_numpy(self.cfg, ref["params"], device="cpu")

    monkeypatch.setattr(mod, "Model", Model)
    monkeypatch.setattr(mod, "RooflineLatencyModel", functools.partial(
        RooflineLatencyModel, peak_flops=ref_config.PEAK_FLOPS_BF16,
        hbm_bw=ref_config.HBM_BW))
    out = mod.main([*LLM_ARGS, "--device", "cpu"] + (["--dynamic"] if dynamic else []))
    assert json.dumps(out["summary"], sort_keys=True) == \
        json.dumps(ref["summary"], sort_keys=True)
    got, want = out["exit_head"], ref["exit_head"]
    assert got["token"] == want["token"]
    assert abs(got["conf"] - want["conf"]) <= EXIT_TOL
    assert abs(got["entropy"] - want["entropy"]) <= EXIT_TOL
    assert 0 < got["conf"] <= 1 and got["entropy"] <= out["log_vocab"]
    text = capsys.readouterr().out
    assert "serving summary: {'requests': 4," in text
    assert "fused exit-head on last prefill token: token=" in text


# ------------------------------------------------------------------ fleet
@pytest.fixture(scope="module")
def fleet_runs():
    """The script's spec with its horizon cut, the reference's run of it
    (batched decode, the spec's default) and the port's serial run on the
    reference's parameters, with the reference's roofline constants."""
    mod = _example("torch_serve_fleet")
    spec = dataclasses.replace(mod.SPEC, workload=dataclasses.replace(
        mod.SPEC.workload, horizon_s=FLEET_HORIZON_S))
    ref = _ref_run(RefScenarioSpec.from_json(spec.to_json()))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sim_build, "PEAK_FLOPS", ref_config.PEAK_FLOPS_BF16)
        mp.setattr(sim_build, "HBM_BW", ref_config.HBM_BW)
        serial = _port_run(dataclasses.replace(spec, engine=dataclasses.replace(
            spec.engine, batch_decode=False)), ref[3], margins=True)
    return mod, spec, ref, serial


def test_serve_fleet_spec_holds_against_reference(fleet_runs, monkeypatch):
    _, spec, ref, serial = fleet_runs
    monkeypatch.setattr(sim_build, "PEAK_FLOPS", ref_config.PEAK_FLOPS_BF16)
    monkeypatch.setattr(sim_build, "HBM_BW", ref_config.HBM_BW)
    assert spec.engine.real_decode and spec.engine.dtype == "float32"
    # its decode groups are of one or two requests: the batched path pads none
    hold_against_reference(ref, serial, spec, "batched", pads=False)


def test_serve_fleet_script_prints_its_table(fleet_runs, monkeypatch, capsys):
    mod, spec = fleet_runs[:2]
    monkeypatch.setattr(mod, "SPEC", spec)
    out = mod.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    n = len(out["tokens"])
    assert f"fleet: 8 devices x 2 edges, {n} requests over 4s (virtual)" in lines
    assert any(ln.startswith("SLO attainment: ") for ln in lines)
    rows = lines[lines.index(" rid  tenant       dev edge  exit  latency(ms)  met  tokens") + 1:]
    assert len(rows) == 10 and n > 10
    for row in rows:
        rid = int(row.split()[0])
        assert row.endswith(str(out["tokens"][rid]))
        assert len(out["tokens"][rid]) > 0


# ------------------------------------------------------------------ AlexNet
def test_serve_dynamic_bandwidth_states_and_transitions_match_reference(capsys):
    """The map's states and BOCD's transitions over the LTE-like trace,
    against the reference's sketch and detector on its own traces."""
    out = _example("torch_serve_dynamic_bandwidth").main(["--device", "cpu"])
    states = ref_cm.sketch_states([t.tolist() for t in ref_oboe(seed=0, num=428)])
    opt = DynamicRuntimeOptimizer({float(s): object() for s in states})
    for bw in ref_lte(seed=3, length=120, transport="bus", hi_mbps=10.0):
        opt.step(bw)
    assert out["states"] == len(opt.cmap) == 428
    assert out["transitions"] == opt.transitions > 0
    assert out["steps"] == 120 and 0 <= out["met"] <= 120
    text = capsys.readouterr().out
    assert f"state transitions: {opt.transitions}" in text
    assert "configuration map: 428 bandwidth states" in text


def test_quickstart_plans_have_the_system_properties(capsys):
    """tests/test_system.py's properties on the script's own plans: the
    exit never falls as the bandwidth rises (Fig. 8a), the fastest link's
    plan is feasible, and the executed plan is the planner's, its latency
    the sum of its edge, device and transfer parts."""
    out = _example("torch_quickstart").main(["--device", "cpu"])
    plans, res, planner = out["plans"], out["result"], out["planner"]
    assert list(plans) == [50, 100, 250, 500, 1000]
    exits = [p.exit_point for p in plans.values() if p.feasible]
    assert exits == sorted(exits) and plans[1000].feasible
    assert (res.exit_point, res.partition) == (plans[500].exit_point, plans[500].partition)
    assert res.latency_s == pytest.approx(res.edge_s + res.device_s + res.transfer_s,
                                          rel=1e-12)
    assert tuple(res.output.shape) == (1, 10) and bool(torch.isfinite(res.output).all())
    assert set(planner.f_edge.r2()) == {"conv", "relu", "lrn", "pool", "fc", "dropout"}
    lines = capsys.readouterr().out.splitlines()
    assert sum(" kbps: exit=" in ln for ln in lines) == 5
    assert lines[-1].startswith("co-inference: exit=") and lines[-1].endswith("logits (1, 10)")


def test_train_branchy_alexnet_restarts_and_reports_five_exits(tmp_path, capsys):
    out = _example("torch_train_branchy_alexnet").main(
        ["--device", "cpu", "--steps", "4", "--batch", "8", "--inject-failure-at", "2",
         "--ckpt-dir", str(tmp_path / "ck")])
    lines = capsys.readouterr().out.splitlines()
    # no checkpoint before step 100: the restart is cold
    assert "[restart] at step 0" in lines
    assert out["info"] == {"restarts": 1, "final_step": 4}
    assert any(ln.startswith("trained 4 steps in ") and ln.endswith("(restarts=1)")
               for ln in lines)
    assert sorted(out["accuracy"]) == [1, 2, 3, 4, 5]
    assert all(0.0 <= a <= 1.0 for a in out["accuracy"].values())
    assert sum(ln.startswith("  exit ") for ln in lines) == 5
    assert np.isfinite(out["losses"][0])
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step_000000004"]
