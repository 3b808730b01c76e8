"""The port's sweeps (``repro_torch.sim.sweep``) against the JAX
package's (``repro.sim.sweep``), on the CPU.

* ``grid_cells`` / ``random_cells`` give the reference's specs;
* ``run_sweep`` rows equal the reference's per row (``wall_s`` aside), for
  timing-only cells and for real-decode cells with their ``decode``
  columns (the metrics of a real-decode run are virtual times, and the
  counters depend on the schedule alone);
* a spawn pool (``processes=2``, ``device="cpu"``) gives the inline rows;
* ``pareto_frontier`` and the CLI equal the reference's.

Cells compared with the reference run with the reference's roofline
constants put into ``repro_torch.sim.build``.  The spawn workers import
the port afresh, with its own (the H100's) constants, so the pool is held
against an inline run without the patch.
"""
import json

import pytest
import torch

import repro.config as ref_config
import repro_torch.sim.build as sim_build
from repro.sim import ScenarioSpec as RefSpec
from repro.sim import grid_cells as ref_grid_cells
from repro.sim import pareto_frontier as ref_pareto_frontier
from repro.sim import random_cells as ref_random_cells
from repro.sim import run_sweep as ref_run_sweep
from repro.sim.sweep import main as ref_sweep_main
from repro_torch.sim import (ScenarioSpec, Simulation, apply_overrides,
                             get_scenario, grid_cells, pareto_frontier,
                             random_cells, run_sweep)
from repro_torch.sim.sweep import main as sweep_main

SMALL = {"workload.horizon_s": 5.0, "topology.num_devices": 8}
# a real-decode cell small enough for the CPU: 5 requests of 8-token prompts
TINY_DECODE = {"topology.num_devices": 4, "workload.horizon_s": 2.0,
               "engine.real_decode": True}


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


def _base(overrides=SMALL):
    return apply_overrides(get_scenario("smoke-lm"), overrides)


def _ref(spec):
    return RefSpec.from_json(spec.to_json())


def _strip(rows):
    """Rows as JSON without their host wall time."""
    return json.loads(json.dumps([{k: v for k, v in r.items() if k != "wall_s"}
                                  for r in rows], default=float))


AXES = [{"topology.num_devices": [4, 8], "router.name": ["rr", "jsq"]},
        {"seed": [1, 2, 3], "workload.horizon_s": [3.0, 5.0]},
        {"engine.real_decode": [False, True], "planner.arch":
         ["llama3.2-1b", "zamba2-2.7b"]}]


@pytest.mark.parametrize("axes", AXES)
def test_grid_cells_equal_reference(axes):
    cells = grid_cells(_base(), axes)
    assert [c.to_dict() for c in cells] == \
        [c.to_dict() for c in ref_grid_cells(_ref(_base()), axes)]
    assert len(cells) == len(list(axes.values())[0]) * len(list(axes.values())[1])
    assert _base().topology.num_devices == 8            # the base is untouched


@pytest.mark.parametrize("seed", [0, 9])
def test_random_cells_equal_reference(seed):
    axes = {"seed": [1, 2, 3, 4], "router.name": ["rr", "jsq"]}
    cells = random_cells(_base(), axes, 6, seed=seed)
    assert [c.to_dict() for c in cells] == \
        [c.to_dict() for c in ref_random_cells(_ref(_base()), axes, 6, seed=seed)]
    assert [c.to_dict() for c in cells] == \
        [c.to_dict() for c in random_cells(_base(), axes, 6, seed=seed)]


def test_grid_cells_reject_unknown_axis():
    with pytest.raises(ValueError):
        grid_cells(_base(), {"topology.nope": [1]})


def test_run_sweep_rows_equal_reference(tmp_path, reference_constants):
    """Timing-only rows: metrics and event counts equal the reference's,
    the JSONL on disk is the rows, and each row's spec re-runs to its
    metrics."""
    cells = grid_cells(_base(), {"router.name": ["rr", "jsq"], "seed": [0, 1]})
    out = tmp_path / "rows.jsonl"
    rows = run_sweep(cells, out_path=str(out), device="cpu")
    ref_rows = ref_run_sweep([_ref(c) for c in cells])
    assert _strip(rows) == _strip(ref_rows)
    assert [json.loads(line) for line in out.read_text().splitlines()] == \
        json.loads(json.dumps(rows))
    for row in rows:
        again = Simulation(ScenarioSpec.from_dict(row["spec"])).run()
        assert again.summary() == row["metrics"]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b"])
def test_real_decode_rows_equal_reference(arch, reference_constants):
    """Real-decode cells (serial and arena) on the CPU: the metrics and the
    ``decode`` columns from the port's ``cache_stats()`` equal the
    reference's row for row."""
    base = apply_overrides(_base(TINY_DECODE), {"planner.arch": arch})
    cells = grid_cells(base, {"engine.arena_decode": [False, True]})
    rows = run_sweep(cells, device="cpu")
    ref_rows = ref_run_sweep([_ref(c) for c in cells])
    assert _strip(rows) == _strip(ref_rows)
    assert rows[1]["decode"]["arena_calls"] > 0
    assert rows[0]["decode"]["serial_tokens"] > rows[1]["decode"]["serial_tokens"]


def test_spawn_pool_equals_inline():
    """``processes=2`` (spawn workers, ``device="cpu"``) gives the inline
    rows, ``wall_s`` aside, for timing-only and real-decode cells."""
    cells = grid_cells(_base(), {"router.name": ["rr", "jsq"]}) + \
        grid_cells(_base(TINY_DECODE), {"engine.arena_decode": [False, True]})
    inline = run_sweep(cells, device="cpu")
    pooled = run_sweep(cells, processes=2, device="cpu")
    assert _strip(inline) == _strip(pooled)
    assert "decode" in inline[3] and "decode" not in inline[0]


def test_real_decode_cells_need_a_card_unless_asked_for_the_cpu():
    """A real-decode cell defaults to the card: without one the sweep raises
    (inline, and in the parent before a pool starts); nothing falls back."""
    cells = grid_cells(_base(TINY_DECODE), {"seed": [0, 1]})
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        run_sweep(cells)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        run_sweep(cells, processes=2)


def _row(x, y):
    return {"metrics": {"cost_usd": x, "slo_attainment": y}}


@pytest.mark.parametrize("rows", [
    [_row(1.0, 0.5), _row(2.0, 0.9), _row(1.5, 0.4), _row(3.0, 0.9)],
    [_row(1.0, 0.5), _row(1.0, 0.5), _row(0.5, 0.2), None,
     {"metrics": {"slo_attainment": 1.0}}, _row(4.0, 1.0)],
    [_row(2.0, 0.7)],
])
def test_pareto_frontier_equals_reference(rows):
    assert pareto_frontier(rows) == ref_pareto_frontier(rows)
    assert pareto_frontier(rows, x="slo_attainment", y="cost_usd") == \
        ref_pareto_frontier(rows, x="slo_attainment", y="cost_usd")


def test_pareto_frontier_of_an_elastic_sweep(reference_constants):
    """Cost-vs-SLO frontier over real rows of an elastic sweep."""
    cells = grid_cells(get_scenario("elastic-smoke"),
                       {"seed": [0, 1], "workload.horizon_s": [4.0, 8.0]})
    rows = run_sweep(cells, device="cpu")
    ref_rows = ref_run_sweep([_ref(c) for c in cells])
    front = pareto_frontier(rows)
    assert front and all("cost_usd" in r["metrics"] for r in front)
    assert _strip(front) == _strip(ref_pareto_frontier(ref_rows))


def test_sweep_cli_equals_reference(tmp_path, capsys, reference_constants):
    args = ["--scenario", "smoke-lm", "--set", "workload.horizon_s=4",
            "--set", "topology.num_devices=6",
            "--grid", 'router.name=["rr","jsq"]', "--grid", "seed=[0,3]"]
    assert sweep_main(args + ["--out", str(tmp_path / "port.jsonl"),
                              "--frontier", str(tmp_path / "port_f.jsonl")]) == 0
    port_out = capsys.readouterr().out
    assert ref_sweep_main(args + ["--out", str(tmp_path / "ref.jsonl"),
                                  "--frontier", str(tmp_path / "ref_f.jsonl")]) == 0
    ref_out = capsys.readouterr().out

    def rows(name):
        return _strip([json.loads(line) for line in
                       (tmp_path / name).read_text().splitlines()])
    assert len(rows("port.jsonl")) == 4
    assert rows("port.jsonl") == rows("ref.jsonl")
    assert rows("port_f.jsonl") == rows("ref_f.jsonl")
    assert port_out.replace("port", "ref") == ref_out


@pytest.mark.parametrize("args,match", [
    (["--grid", "seed=[1]"], "exactly one of"),
    (["--scenario", "smoke-lm"], "at least one --grid"),
    (["--scenario", "smoke-lm", "--grid", "seed"], "PATH=JSON_LIST"),
    (["--scenario", "smoke-lm", "--grid", "seed=[]"], "non-empty"),
    (["--scenario", "smoke-lm", "--grid", "seed=oops"], "JSON list"),
])
def test_sweep_cli_rejects_bad_usage_as_reference(tmp_path, args, match):
    out = ["--out", str(tmp_path / "x.jsonl")]
    with pytest.raises(ValueError, match=match) as port:
        sweep_main(args + out)
    with pytest.raises(ValueError) as ref:
        ref_sweep_main(args + out)
    assert str(port.value) == str(ref.value)
