"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at the
smoke size, once for each fault a served cell can have.  Each fault sits inside
the program, under the calls the harness wraps.  (A cell on one chip has no
exchange between chips to leave out.)"""
import time

import pytest
import torch

from portbench.harness import cellrun, spec

CELLS = ["granite-3-8b.longdoc"]


def leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def stacks():
    from repro_torch.models import ssm_stack, transformer
    return transformer, ssm_stack


@pytest.fixture
def stale_state(monkeypatch):
    """Every decode step returns the state it was given, unchanged."""
    for mod in stacks():
        step = mod.decode_step

        def stale(cfg, params, cache, tokens, pos, _step=step, **kw):
            saved = [t.clone() for t in leaves(cache)]
            h, _, confs = _step(cfg, params, cache, tokens, pos, **kw)
            for t, s in zip(leaves(cache), saved):
                t.copy_(s)
            return h, cache, confs
        monkeypatch.setattr(mod, "decode_step", stale)


@pytest.fixture
def half_batch(monkeypatch):
    """The prefill computes the first half of the batch; the other rows get its
    results."""
    for mod in stacks():
        prefill = mod.prefill

        def half(cfg, params, tokens, cache, *a, _prefill=prefill, **kw):
            B = tokens.shape[0]
            k = (B + 1) // 2
            return _prefill(cfg, params, torch.cat([tokens[:k], tokens[:k]])[:B], cache, *a, **kw)
        monkeypatch.setattr(mod, "prefill", half)


@pytest.fixture
def altered_token(monkeypatch):
    """The exit head's token, altered where it is produced."""
    from repro_torch.kernels.exit_head import ops
    head = ops.exit_confidence

    def altered(h, emb):
        out = head(h, emb)
        return dict(out, token=(out["token"] + 1) % emb.shape[0])
    monkeypatch.setattr(ops, "exit_confidence", altered)


def run(name):
    cell = spec.load_cell(name)
    cell.traffic = dict(cell.traffic, prompt_len=dict(cell.traffic["prompt_len"],
                                                      median=24, min=4, max=48))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out, _ = cellrun.run(cell, 123, 0.2, False, time.monotonic(), device=torch.device("cpu"),
                             smoke=True)
    finally:
        torch.set_num_threads(n)
    return out


def gap_fails(out):
    return out["checks"]["logit_gap"]["value"] > out["checks"]["logit_gap"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_a_step_that_returns_its_state_unchanged_is_not_correct(name, stale_state):
    out = run(name)
    assert not out["correct"] and gap_fails(out)


@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_left_out_is_not_correct(name, half_batch):
    out = run(name)
    assert not out["correct"] and gap_fails(out)


@pytest.mark.parametrize("name", CELLS)
def test_an_altered_token_is_not_correct(name, altered_token):
    out = run(name)
    assert not out["correct"] and gap_fails(out)
