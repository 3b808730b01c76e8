"""``python -m repro_torch.sim`` against ``python -m repro.sim``, on the
CPU: the ``--json`` payload (scenario, spec, metrics, events) equals the
reference's for ``--scenario``, ``--spec`` and ``--set``, for a sharded
spec, with ``--trace`` / ``--timeline``, and for a real-decode spec with
``--device cpu``; the human-readable listing and the usage errors are the
reference's too.  The reference's roofline constants are put into
``repro_torch.sim.build`` (the port's own are the H100's)."""
import json

import pytest
import torch

import repro.config as ref_config
import repro_torch.sim.build as sim_build
from repro.sim.cli import main as ref_main
from repro_torch.sim import apply_overrides, get_scenario
from repro_torch.sim.cli import main as sim_main

TINY_DECODE = ["--set", "engine.real_decode=true", "--set", "topology.num_devices=4",
               "--set", "workload.horizon_s=2.0"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def reference_constants(monkeypatch):
    monkeypatch.setattr(sim_build, "PEAK_FLOPS", ref_config.PEAK_FLOPS_BF16)
    monkeypatch.setattr(sim_build, "HBM_BW", ref_config.HBM_BW)


def _both(capsys, args, port_extra=()):
    """The port's and the reference's stdout for the same arguments."""
    capsys.readouterr()
    assert sim_main(list(args) + list(port_extra)) == 0
    port = capsys.readouterr().out
    assert ref_main(list(args)) == 0
    return port, capsys.readouterr().out


@pytest.mark.parametrize("args", [
    ["--scenario", "smoke-lm"],
    ["--scenario", "smoke-mobility"],
    ["--scenario", "coop"],
    ["--scenario", "elastic-smoke"],
    ["--scenario", "smoke-lm", "--set", "topology.num_devices=6",
     "--set", "workload.horizon_s=4.0", "--set", "router.name=jsq"],
    ["--scenario", "smoke-lm", "--set", "topology.num_devices=20",
     "--set", "topology.num_edges=4", "--set", "topology.shards=2",
     "--set", "workload.horizon_s=4.0"],
], ids=["smoke-lm", "smoke-mobility", "coop", "elastic-smoke", "set", "sharded"])
def test_json_equals_reference(capsys, args):
    port, ref = _both(capsys, args + ["--json"])
    port, ref = json.loads(port), json.loads(ref)
    assert port == ref
    assert port["metrics"]["requests"] > 0 and port["events"]["processed"] > 0


def test_spec_file_equals_reference(tmp_path, capsys):
    spec = apply_overrides(get_scenario("smoke-mobility"),
                           {"topology.num_devices": 12, "workload.horizon_s": 6.0})
    path = tmp_path / "cell.json"
    path.write_text(spec.to_json())
    port, ref = _both(capsys, ["--spec", str(path), "--json"])
    assert json.loads(port) == json.loads(ref)
    assert json.loads(port)["spec"] == spec.to_dict()


def test_real_decode_on_the_cpu_equals_reference(capsys):
    """A real-decode spec, its model on the CPU (``--device cpu``): the
    metrics and event counts of the reference's run."""
    port, ref = _both(capsys, ["--scenario", "smoke-lm", "--json"] + TINY_DECODE,
                      port_extra=["--device", "cpu"])
    port, ref = json.loads(port), json.loads(ref)
    assert port["spec"]["engine"]["real_decode"] is True
    assert port == ref


def test_real_decode_needs_a_card_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        sim_main(["--scenario", "smoke-lm", "--json"] + TINY_DECODE)


def test_observers_leave_the_metrics_bit_identical(tmp_path, capsys):
    """``--trace`` / ``--timeline``: metrics equal to the same command
    without them (and to the reference's), artifacts equal to the
    reference's artifacts of the same command."""
    base = json.loads(_both(capsys, ["--scenario", "smoke-mobility", "--json"])[0])
    capsys.readouterr()
    assert sim_main(["--scenario", "smoke-mobility", "--json",
                     "--trace", str(tmp_path / "p.json"),
                     "--timeline", str(tmp_path / "p.jsonl")]) == 0
    port = json.loads(capsys.readouterr().out)
    assert ref_main(["--scenario", "smoke-mobility", "--json",
                     "--trace", str(tmp_path / "r.json"),
                     "--timeline", str(tmp_path / "r.jsonl")]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert port["metrics"] == base["metrics"] == ref["metrics"]
    assert port["events"] == ref["events"]
    assert json.loads((tmp_path / "p.json").read_text()) == \
        json.loads((tmp_path / "r.json").read_text())
    assert (tmp_path / "p.jsonl").read_text() == (tmp_path / "r.jsonl").read_text()


@pytest.mark.parametrize("args", [["--list"],
                                  ["--scenario", "smoke-lm", "--set",
                                   "topology.num_devices=6"]],
                         ids=["list", "listing"])
def test_text_output_equals_reference(capsys, args):
    port, ref = _both(capsys, args)
    # the registry's descriptions name each package's own modules
    assert port.replace("repro_torch.", "repro.") == ref and port


@pytest.mark.parametrize("args,match", [
    (["--json"], "exactly one of"),
    (["--scenario", "smoke-lm", "--set", "oops"], "key=value"),
    (["--scenario", "nope"], "unknown scenario"),
])
def test_rejects_bad_usage_as_reference(args, match):
    with pytest.raises(ValueError, match=match) as port:
        sim_main(args)
    with pytest.raises(ValueError) as ref:
        ref_main(args)
    assert str(port.value) == str(ref.value)
