"""The port's dry run, cost model and roofline against the reference's.

* A dry run on a fake world of 8 ranks (a subprocess: the fake default
  process group must not outlive it) for the cells of
  ``tests/test_dryrun_small.py``: granite-3-2b, llama4-scout train,
  rwkv6-3b decode and zamba2-2.7b prefill on 2×4 ``(data, model)``, and
  granite on 2×2×2 ``(pod, data, model)``, at smoke size: per-device FLOPs
  and collective link bytes above zero, and no collective on a 1×1 mesh.
* The reference's scanned-matmul check of its HLO walker
  (``test_hlo_cost_walker_exact_on_matmul_and_scan``): five [64,128] @
  [128,128] products of a 2×4-sharded loop give per-device FLOPs within 2%
  of 5·2·64·128·128/8.
* Uneven splits: a [5, 6] tensor laid out ``P("data", "model")`` on the
  fake 2×4 mesh keeps torch.chunk's shards (3|2 rows, 2|2|1|1 columns).
* ``_link_bytes`` for every kind and group size 2-16, ``model_flops`` for
  every arch × shape, ``terms_from_record`` and ``report`` on the same
  record with the same constants: equal to the reference's.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.config import HBM_BW, ICI_BW, PEAK_FLOPS_BF16
from repro.config import SHAPES as REF_SHAPES
from repro.launch import roofline as ref_roofline
from repro_torch.configs import ARCH_IDS
from repro_torch.launch import dryrun, roofline

ROOT = Path(__file__).resolve().parents[1]


def _ref_link_bytes():
    """The reference's ``_link_bytes``.  Its module sets ``XLA_FLAGS`` to
    512 host devices when imported (its dry run forces them before JAX
    starts); the flag is put back at once, so that no JAX backend of this
    process starts with it."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import _link_bytes
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return _link_bytes

WORLD = r"""
import json
import torch
torch.set_num_threads(1)
import faulthandler
faulthandler.dump_traceback_later(400, exit=True)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from repro_torch import spmd
from repro_torch.config import ShapeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as M
from repro_torch.launch.hlo_cost import CostCounter
from repro_torch.models.api import Model

out = {"cells": {}}
dryrun.fake_world(8)
m24 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
for arch, kind in [("granite-3-2b", "train"), ("llama4-scout-17b-a16e", "train"),
                   ("rwkv6-3b", "decode"), ("zamba2-2.7b", "prefill")]:
    r = dryrun.run_model_cell(Model(get_smoke_config(arch)), ShapeConfig("t", 64, 8, kind), m24)
    out["cells"][arch + "|" + kind] = r

# the reference's scanned matmul: x P("data", None), ws P(None, "data", "model")
x = M.distribute(torch.randn(64, 128, device="meta"), M.P("data", None), m24)
ws = M.distribute(torch.randn(5, 128, 128, device="meta"), M.P(None, "data", "model"), m24)
with CostCounter() as c:
    for i in range(5):
        x = x @ ws[i]
out["scan"] = {"flops": c.flops, "expect": 5 * 2 * 64 * 128 * 128 / 8}

# uneven splits: torch.chunk's shards
t = M.distribute(torch.arange(30.0).reshape(5, 6), M.P("data", "model"), m24)
out["uneven"] = {"placements": str(tuple(t.placements)), "local": list(t.to_local().shape),
                 "rows": spmd.window(t, 0), "cols": spmd.window(t, 1)}

m222 = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
out["cells"]["granite-3-2b|train|multipod"] = dryrun.run_model_cell(
    Model(get_smoke_config("granite-3-2b")), ShapeConfig("t", 64, 8, "train"), m222)

dryrun.fake_world(1)
m11 = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
out["cells"]["granite-3-2b|train|1x1"] = dryrun.run_model_cell(
    Model(get_smoke_config("granite-3-2b")), ShapeConfig("t", 64, 8, "train"), m11)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", WORLD], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=500)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


CELLS = ["granite-3-2b|train", "llama4-scout-17b-a16e|train", "rwkv6-3b|decode",
         "zamba2-2.7b|prefill", "granite-3-2b|train|multipod"]


@pytest.mark.parametrize("cell", CELLS)
def test_small_mesh_dryrun(fake_runs, cell):
    r = fake_runs["cells"][cell]
    assert r["status"] == "ok" and r["chips"] == 8
    assert r["flops"] > 0 and r["bytes_walked"] > 0
    assert r["collectives"]["total_link_bytes"] > 0      # a sharded step communicates
    mem = r["memory"]
    assert mem["argument_bytes"] > 0 and mem["generated_code_bytes"] is None
    assert mem["alias_bytes"] is None
    assert r["analytic_state_bytes_per_chip"] > 0


def test_one_chip_mesh_has_no_collectives(fake_runs):
    r = fake_runs["cells"]["granite-3-2b|train|1x1"]
    assert r["chips"] == 1 and r["flops"] > 0
    assert r["collectives"]["total_link_bytes"] == 0
    # eight ranks share the work: each does less than the one chip
    assert fake_runs["cells"]["granite-3-2b|train"]["flops"] < r["flops"]


def test_cost_counter_exact_on_matmul_and_loop(fake_runs):
    s = fake_runs["scan"]
    assert abs(s["flops"] - s["expect"]) / s["expect"] < 0.02


def test_uneven_split_keeps_chunk_shards(fake_runs):
    u = fake_runs["uneven"]
    assert u["placements"] == "(Shard(dim=0), Shard(dim=1))"
    assert u["local"] == [3, 2]                       # rank 0: rows 0-2, columns 0-1
    assert u["rows"] == [0, 3] and u["cols"] == [0, 2]


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce", "reduce-scatter",
                                  "all-to-all", "collective-permute"])
def test_link_bytes_equal_reference(kind):
    ref = _ref_link_bytes()
    for g in range(2, 17):
        for result in (1, 1000, 4096, 123457):
            assert dryrun._link_bytes(kind, result, g) == ref(kind, result, g)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_reference(arch):
    for shape in REF_SHAPES:
        assert roofline.model_flops(arch, shape) == ref_roofline.model_flops(arch, shape)


def _record(arch, shape):
    return {"status": "ok", "arch": arch, "shape": shape, "chips": 256,
            "flops": 3.5e12, "bytes_accessed": 2.0e11, "flops_walked": 4.1e12,
            "bytes_walked": 2.2e11, "collectives": {"total_link_bytes": 7.5e9}}


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-3b", "llama4-scout-17b-a16e"])
def test_roofline_terms_equal_reference(arch, tmp_path):
    consts = dict(peak=PEAK_FLOPS_BF16, hbm=HBM_BW, link=ICI_BW)
    for shape in REF_SHAPES:
        rec = _record(arch, shape)
        got = roofline.terms_from_record(rec, **consts)
        want = ref_roofline.terms_from_record(rec, **consts)
        assert got.__dict__ == want.__dict__
    results = {f"{arch}|{s}|single": _record(arch, s) for s in REF_SHAPES}
    results[f"{arch}|x|single"] = {"status": "skipped", "reason": "not run"}
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(results))
    assert roofline.report(path, **consts) == ref_roofline.report(str(path))
