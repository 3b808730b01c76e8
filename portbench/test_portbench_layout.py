"""BENCHMARK.json against the benchmark's contract, and the data-driven layout:
every cell, configuration, traffic mix and metric sits in files of its own that
the harness finds by name."""
import json
import re
import shutil

from portbench.harness import spec

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expan|_dim$|_rank$|per_tok|experts_per)")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_names_and_units():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"] and b["paths"] == ["portbench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert not any(WIDTH.search(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_resolves_by_name():
    b = bench()
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"])
        names = {m.name for m in cell.metrics}
        assert {"setup_s", "prompt_tokens_per_s", "request_p95_s"} <= names
        assert any(m.kind == "per_layer" for m in cell.metrics)
        assert (spec.HERE / "limits" / f"{w['name']}.json").is_file()
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        ref = spec.HERE / "reference" / f"{cell.config['reference']}.py"
        assert ref.is_file()


def test_run_length_fits_the_check_with_every_cell():
    rs = bench()["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_files_are_named_from_name_characters():
    for p in spec.HERE.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./\-]+$", rel), rel


def test_a_new_cell_needs_no_edit_of_an_existing_file(tmp_path):
    """A later change adds a traffic file, a limits file and a workload entry (and
    may add a metric's reader): the harness finds them by name."""
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    b = bench()
    mix = json.loads((spec.HERE / "traffic" / "longdoc.json").read_text())
    mix.update(batch=64, prompt_len=dict(mix["prompt_len"], median=192, sigma=0.5, min=32, max=512))
    (tmp_path / "portbench" / "traffic" / "shortburst.json").write_text(json.dumps(mix))
    (tmp_path / "portbench" / "limits" / "granite-3-8b.shortburst.json").write_text(
        json.dumps({"logit_gap": {"limit": 0.1}}))
    (tmp_path / "portbench" / "metrics" / "batch_rows.py").write_text(
        "def read(run):\n    return float(len(run.requests()))\n")
    b["workloads"].append({"name": "granite-3-8b.shortburst", "config": "granite-3-8b",
                           "traffic": "shortburst", "chips": 1, "why": "short prompts"})
    b["per_layer"].append({"name": "batch_rows", "unit": "1", "better": "higher",
                           "source": "program_counter", "layer": "engine",
                           "moves": "prompt_tokens_per_s", "workloads": ["granite-3-8b.shortburst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell("granite-3-8b.shortburst", tmp_path)
    assert cell.traffic["batch"] == 64
    assert "batch_rows" in {m.name for m in cell.metrics}
    old = spec.load_cell("granite-3-8b.longdoc", tmp_path)
    assert "batch_rows" not in {m.name for m in old.metrics}
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())
