"""The control on the card, at the cell's own size: the reference in float8 e4m3
matmuls, put in the program's place over the rows a run samples, fails the
cell's limit, which the program's run meets.  Skips without a CUDA card; on the
card: ``python -m pytest -q portbench/test_portbench_card.py`` (a few minutes)."""
import gc
import json
import time

import pytest
import torch

from portbench.harness import cellrun, check, spec

CELLS = {"granite-3-8b.longdoc": 16}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_control_fails_where_the_program_passes(name, card):
    cell = spec.load_cell(name)
    limit = json.loads((spec.HERE / "limits" / f"{name}.json").read_text())["logit_gap"]["limit"]
    keep = {}
    out, _ = cellrun.run(cell, 20260, CELLS[name], False, time.monotonic(), keep=keep)
    assert out["correct"], out["checks"]
    ctrl = check.control_gap(cell.config, keep["params"], keep["jobs"], keep["ref"])
    assert ctrl > limit >= out["checks"]["logit_gap"]["value"]
    del keep
    gc.collect()
    torch.cuda.empty_cache()
