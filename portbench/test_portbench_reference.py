"""The plain reference against the port's own CPU path (the kernels' plain
versions, float32) on the smoke configuration of each cell's family, and the
check's sample."""
import json
import time

import numpy as np
import pytest
import torch

from portbench.harness import cellrun, check, serve, spec, traffic, weights
from portbench.reference import common as C
from portbench.reference import dense
from portbench.reference import plan as P

CELLS = ["granite-3-8b.longdoc"]
SHORT = {"median": 24, "min": 4, "max": 48}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke_cell(name, **mix):
    cell = spec.load_cell(name)
    cell.traffic = dict(cell.traffic, prompt_len=dict(cell.traffic["prompt_len"], **SHORT), **mix)
    return cell


def smoke_params(arch):
    from repro_torch.models import Model
    cfg = json.loads((spec.HERE / "configs" / f"{arch}.json").read_text())
    cfg.update(serve.smoke_sizes(cfg))
    model = Model(serve.port_config(cfg, smoke=True))
    return cfg, model, weights.make(model.abstract_params(torch.float32), 11, torch.device("cpu"))


@pytest.mark.parametrize("pad", [0, 5, 9])
def test_the_pad_prefix_stands_for_a_rows_padded_head(pad, one_thread):
    """A row read with its pad positions from a prefix worked out over a longer
    pad gives the logits of the whole row run from position 0."""
    cfg, _, params = smoke_params("granite-3-8b")
    C.exact_matmul()
    n_seg = len(P.segment_lengths(cfg))
    rng = np.random.default_rng(pad)
    L, exits = 16, [1, n_seg, 2]
    tokens = np.concatenate([np.zeros(pad, np.int64), rng.integers(1, cfg["vocab_size"], L - pad),
                             rng.integers(1, cfg["vocab_size"], len(exits))])
    depth = np.concatenate([np.full(L, n_seg), exits])
    picks = [(L - 1, n_seg)] + [(L + j, e) for j, e in enumerate(exits)]
    row = C.Row(tokens, depth, picks, pad)
    mm, emb = C.Matmul("f32"), params["embed"].float()
    whole = dense.row_logits(cfg, params, row, mm, emb)
    prefix = dense.pad_prefix(cfg, params, 11, mm, emb)
    for a, b in zip(whole, dense.row_logits(cfg, params, row, mm, emb, prefix)):
        assert torch.allclose(a, b, atol=1e-5), (a - b).abs().max()


def test_the_sample_holds_the_longest_and_enough_picks():
    mix = spec.load_traffic("longdoc")
    stream = traffic.Stream(mix, 2**31 + 7, 49155)
    batches = []
    for _ in range(mix["pool_batches"]):
        b = stream.next()
        batches.append(check.Served(b.requests, 0, None, [1] * b.steps, None, {}))
    pairs = check.sample(batches, 300, 2**31 + 7)
    picks = [1 + max(r.max_new_tokens for r in b.requests) for b, _ in pairs]
    assert sum(picks) >= 300 > sum(picks[:-1])
    lens = [len(r.prompt) for _, r in pairs]
    every = [len(r.prompt) for b in batches for r in b.requests]
    assert lens[0] == max(every) and len({id(r) for _, r in pairs}) == len(pairs)
    assert np.median(lens[1:]) < np.median(every)       # short prompts cost the reference least
    assert check.sample(batches, 300, 2**31 + 7) == pairs
    assert check.sample(batches, 300, 5) != pairs


@pytest.mark.parametrize("arch", ["granite-3-8b"])
def test_reference_follows_the_port_through_mixed_exits(arch, one_thread):
    """A left-padded batch prefilled at full depth, then decode steps at exits that
    change from step to step: the positions an exit left out of a layer are zero
    keys there, in both."""
    cfg, model, params = smoke_params(arch)
    n_seg = len(P.segment_lengths(cfg))
    assert n_seg == model.num_segments
    exits = [n_seg, 1, 2, 1, n_seg, 1][:5] if n_seg > 2 else [2, 1, 1, 2, 1]
    rng = np.random.default_rng(3)
    L, B = 20, 2
    prompts = [rng.integers(1, cfg["vocab_size"], n) for n in (20, 13)]
    toks = np.zeros((B, L), np.int64)
    for i, p in enumerate(prompts):
        toks[i, L - len(p):] = p
    cache = model.init_cache(B, L + len(exits) + 1, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        h, cache = model.prefill(params, torch.from_numpy(toks).int(), cache, impl="kernel")
        got, fed = [h[:, -1] @ params["embed"].T], []
        for j, e in enumerate(exits):
            t = got[-1].argmax(-1).int()[:, None]
            fed.append(t[:, 0].numpy())
            ep = None if e == n_seg else e - 1
            h, cache, _ = model.decode_step(params, cache, t, L + j, exit_point=ep, impl="kernel")
            got.append(h[:, -1] @ params["embed"].T)
    C.exact_matmul()
    fam = __import__(f"portbench.reference.{cfg['reference']}", fromlist=["row_logits"])
    for i in range(B):
        tokens = np.concatenate([toks[i], [f[i] for f in fed]])
        depth = np.concatenate([np.full(L, n_seg), exits])
        picks = [(L - 1, n_seg)] + [(L + j, e) for j, e in enumerate(exits)]
        ref = fam.row_logits(cfg, params, C.Row(tokens, depth, picks), C.Matmul("f32"),
                             params["embed"].float())
        for r, g in zip(ref, got):
            assert torch.allclose(r, g[i], atol=2e-4), (r - g[i]).abs().max()


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name, one_thread):
    out, rec = cellrun.run(smoke_cell(name), 2**31 + 99, 0.3, False, time.monotonic(),
                           device=torch.device("cpu"), smoke=True)
    assert out["correct"], out["checks"]
    assert out["checks"]["logit_gap"]["value"] <= 1e-4
    assert out["attempted"] == len(rec.requests()) > 0
    assert set(out["metrics"]) == {"prompt_tokens_per_s", "request_p95_s", "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_demoted_decode_is_checked_at_its_exit(name, one_thread):
    tight = [{"name": "tight", "share": 1.0, "slo_s": 1e-9}]
    out, rec = cellrun.run(smoke_cell(name, tenants=tight), 5, 0.3, False, time.monotonic(),
                           device=torch.device("cpu"), smoke=True)
    assert out["correct"], out["checks"]
    assert all(e == 0 for c in rec.calls for e in c.exits)      # exit 1: the first segment


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reads_its_layers(name, one_thread):
    out, _ = cellrun.run(smoke_cell(name), 17, 0.3, True, time.monotonic(),
                         device=torch.device("cpu"), smoke=True)
    assert out["correct"]
    m = out["metrics"]
    assert {"pad_share", "decode_depth_share", "prefill_ms_per_kpos", "decode_step_ms"} <= set(m)
    assert 0 < m["pad_share"]["value"] < 100 and m["decode_depth_share"]["value"] == 100.0
    # no device on the CPU: no roofline, idle share or mfu is reported
    assert not any(k.endswith("_roofline") or k in ("serve_mfu", "device_idle_share") for k in m)
    assert list(out)[-1] == "checks" and "breakdown" in out
