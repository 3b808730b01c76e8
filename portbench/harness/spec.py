"""Everything a cell needs, found by name: the cell in ``BENCHMARK.json``, its
configuration file, its traffic file and the readers of its metrics.

A later change adds a configuration, a traffic mix, a cell or a metric by adding
files and entries; nothing here names one of them."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

#: the benchmark's folder; the checkout's root is its parent
HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


@dataclass
class Metric:
    name: str
    unit: str
    kind: str                      # "end_to_end" or "per_layer"
    read: Callable                 # read(run) -> float or None


@dataclass
class Cell:
    name: str
    config: dict                   # the configuration file, as run
    traffic: dict                  # the traffic file
    chips: int
    metrics: List[Metric]          # every metric this cell reports, both kinds


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def metric_reader(name: str, here: Path = HERE) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, here: Path = HERE) -> List[Metric]:
    """The metrics ``cell`` reports: an end-to-end metric without a ``workloads``
    key, or one that lists the cell; a per-layer metric whose ``workloads`` lists
    the cell, or without the key one whose ``moves`` the cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    e2e_names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return ([Metric(m["name"], m["unit"], "end_to_end", metric_reader(m["name"], here))
             for m in e2e]
            + [Metric(m["name"], m["unit"], "per_layer", metric_reader(m["name"], here))
               for m in per])


def load_cell(name: str, root: Path = ROOT, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = load_traffic(w["traffic"], root / "portbench")
    return Cell(name=name, config=config, traffic=traffic, chips=int(w["chips"]),
                metrics=cell_metrics(bench, name, root / "portbench"))


def load_traffic(name: str, here: Path = HERE) -> Dict:
    return json.loads((here / "traffic" / f"{name}.json").read_text())
