"""The shared pad prefix: a prefill of left-padded rows of unequal prompts that
computes the rows' pad prefix once (``Model.prefill``'s ``lengths``), held
against the padded prefill on the smoke configs in float32; the serving engine
takes it only where the model's arithmetic allows, and counts it."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models import layers as L
from repro_torch.obs import spans
from repro_torch.serving import Request

DENSE = ["llama3.2-1b", "granite-3-8b", "starcoder2-15b"]
#: the longest row (no pad), a one-token row, two equal rows
LENGTHS = [13, 1, 7, 7, 4]
#: float32 on both paths: the same terms, summed in another order at most (a
#: projection over another number of rows, a row's softmax over its keys in
#: another blocking); a few float32 ulps a layer on values of order 1
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.reset()
    yield
    spans.reset()
    torch.set_num_threads(n)


def model_of(arch):
    model = Model(get_smoke_config(arch))
    params = model.init_params(torch.Generator().manual_seed(0), dtype=torch.float32,
                               device="cpu")
    return model, params


def padded(lengths, vocab, seed=0):
    """Rows of ``lengths`` random prompts, left-padded with token 0."""
    rs = np.random.default_rng(seed)
    S = max(lengths)
    toks = np.zeros((len(lengths), S), np.int32)
    for i, n in enumerate(lengths):
        toks[i, S - n:] = rs.integers(1, vocab, n)
    return torch.from_numpy(toks)


def requests(lengths, vocab, seed=0):
    rs = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rs.integers(1, vocab, n).astype(np.int32),
                    max_new_tokens=3, slo_s=0.4) for i, n in enumerate(lengths)]


def record_prefills(model):
    """Each ``Model.prefill`` call's tokens shape and keyword arguments."""
    calls, prefill = [], model.prefill

    def rec(params, tokens, cache, **kw):
        calls.append((tuple(tokens.shape), sorted(kw)))
        return prefill(params, tokens, cache, **kw)
    model.prefill = rec
    return calls


def test_layout_of_a_small_batch():
    pack = L.pad_prefix([3, 1, 2], 3, "cpu")
    # the prefix: the first 2 positions of row 1, padded most; then each row
    assert pack.prefix == 2 and pack.seq == 3 and pack.rows == ((2, 3), (5, 1), (6, 2))
    assert pack.take.tolist() == [3, 4, 0, 1, 2, 5, 7, 8]
    assert pack.positions.tolist() == [[0, 1, 0, 1, 2, 2, 1, 2]]
    assert pack.src.tolist() == [[2, 3, 4], [0, 1, 5], [0, 6, 7]]
    assert pack.last.tolist() == [4, 5, 7]
    for bad in ([], [0, 2], [4, 1]):
        with pytest.raises(ValueError, match="lengths"):
            L.pad_prefix(bad, 3, "cpu")


@pytest.mark.parametrize("impl", ["kernel", "dense"])
@pytest.mark.parametrize("arch", DENSE)
def test_shared_prefill_is_the_padded_prefill(arch, impl):
    """The last hidden states and every row's cache over [0, S) in every
    segment; the rest of the cache is left as it was."""
    model, params = model_of(arch)
    toks = padded(LENGTHS, model.cfg.vocab_size)
    B, S = toks.shape
    out = []
    for kw in ({}, {"lengths": LENGTHS}):
        cache = model.init_cache(B, S + 4, dtype=torch.float32, device="cpu")
        h, cache = model.prefill(params, toks, cache, impl=impl, **kw)
        out.append((h, cache))
    (h_pad, c_pad), (h_sh, c_sh) = out
    assert h_sh.shape == h_pad.shape == (B, 1, model.cfg.d_model)
    torch.testing.assert_close(h_sh, h_pad, **TOL)
    for si, (sp, ss) in enumerate(zip(c_pad, c_sh)):
        for name in sp:
            torch.testing.assert_close(ss[name][:, :, :S], sp[name][:, :, :S], **TOL,
                                       msg=f"segment {si} {name}")
            assert not ss[name][:, :, S:].any()


def test_one_flash_call_for_the_prefix_and_one_a_row(monkeypatch):
    """B + 1 flash calls a layer on the shared path, the prefix's [1, P] and
    each row's [1, L_i] queries over its cache row's S keys; one a layer on
    the padded path."""
    model, params = model_of("granite-3-8b")
    toks = padded(LENGTHS, model.cfg.vocab_size)
    B, S = toks.shape
    P = S - min(LENGTHS)
    shapes, flash = [], fa_ops.flash_attention

    def rec(q, k, v, *, causal=True):
        shapes.append((q.shape[:2], k.shape[:2], causal))
        return flash(q, k, v, causal=causal)
    monkeypatch.setattr(fa_ops, "flash_attention", rec)
    model.prefill(params, toks, model.init_cache(B, S, dtype=torch.float32, device="cpu"))
    n = model.cfg.num_layers
    assert shapes == [((B, S), (B, S), True)] * n
    shapes.clear()
    model.prefill(params, toks, model.init_cache(B, S, dtype=torch.float32, device="cpu"),
                  lengths=LENGTHS)
    layer = [((1, P), (1, P), True)] + [((1, m), (1, S), True) for m in LENGTHS]
    assert shapes == layer * n


def test_serve_gives_the_padded_paths_tokens():
    """Two engines alike, one whose model refuses the shared pad prefix."""
    out = []
    for shared in (True, False):
        cfg, eng = serve.build("granite-3-8b", torch.device("cpu"), batch=len(LENGTHS))
        calls = record_prefills(eng.model)
        if not shared:
            eng.model.shares_pad_prefix = lambda *a, **k: False
        out.append((eng.serve(requests(LENGTHS, cfg.vocab_size)), eng.last_hidden, calls))
    (st_sh, h_sh, calls_sh), (st_pad, h_pad, calls_pad) = out
    B, S = len(LENGTHS), max(LENGTHS)
    assert calls_sh == [((B, S), ["impl", "lengths"])] and calls_pad == [((B, S), ["impl"])]
    assert st_sh.tokens == st_pad.tokens
    assert st_sh.exits == st_pad.exits and st_sh.latencies == st_pad.latencies
    torch.testing.assert_close(h_sh, h_pad, **TOL)


@pytest.mark.parametrize("arch,lengths", [
    ("llama4-scout-17b-a16e", LENGTHS),        # experts
    ("llama4-maverick-400b-a17b", LENGTHS),    # experts every other layer
    ("rwkv6-3b", LENGTHS),                     # the ssm scan
    ("zamba2-2.7b", LENGTHS),                  # the hybrid
    ("granite-3-8b", [7, 7, 7, 7]),            # equal prompts: no pad
], ids=["moe", "moe-period-2", "ssm", "hybrid", "equal"])
def test_the_engine_keeps_the_padded_call(arch, lengths):
    cfg, eng = serve.build(arch, torch.device("cpu"), batch=len(lengths))
    calls = record_prefills(eng.model)
    with torch.profiler.profile():
        stats = eng.serve(requests(lengths, cfg.vocab_size))
    assert calls == [((len(lengths), max(lengths)), ["impl"])]
    assert all(len(t) == 3 for t in stats.tokens.values())
    assert "engine.pad_prefix.batches" not in spans.REGISTRY


def _cache(model, params, **kw):
    return model.init_cache(2, 8, dtype=params["embed"].dtype, device="cpu", **kw)


def test_who_shares_the_pad_prefix():
    for arch in DENSE + ["llava-next-mistral-7b"]:
        model, params = model_of(arch)
        assert model.shares_pad_prefix(params, _cache(model, params)), arch
    model, params = model_of("llava-next-mistral-7b")
    prefix = torch.zeros(2, model.cfg.num_prefix_tokens, 1024)
    assert not model.shares_pad_prefix(params, _cache(model, params), prefix_emb=prefix)
    with pytest.raises(ValueError, match="cannot share the pad prefix"):
        model.prefill(params, padded([4, 2], model.cfg.vocab_size), _cache(model, params),
                      prefix_emb=prefix, lengths=[4, 2])
    model, params = model_of("granite-3-8b")
    assert not model.shares_pad_prefix(params, _cache(model, params, quant=True))
    assert not model.shares_pad_prefix(
        params, model.init_cache(2, 8, dtype=torch.bfloat16, device="cpu"))
    for arch in ("llama4-scout-17b-a16e", "rwkv6-3b", "zamba2-2.7b", "seamless-m4t-large-v2"):
        model, params = model_of(arch)
        assert not model.shares_pad_prefix(params, _cache(model, params)), arch


@pytest.mark.parametrize("arch,match", [
    ("llama4-scout-17b-a16e", "cannot share the pad prefix"),
    ("rwkv6-3b", "only the transformer stack"),
    ("seamless-m4t-large-v2", "only the transformer stack"),
])
def test_a_prefill_that_cannot_share_refuses_lengths(arch, match):
    model, params = model_of(arch)
    toks = padded([4, 2], model.cfg.vocab_size)
    with pytest.raises(ValueError, match=match):
        model.prefill(params, toks, _cache(model, params), lengths=[4, 2])


def test_dtensors_do_not_share_the_pad_prefix():
    """On a mesh (a gloo world of one, torn down after) the prefill keeps its
    padded call."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    assert not dist.is_initialized()
    try:
        mesh = M.make_host_mesh(device="cpu")
        model, params = model_of("granite-3-8b")
        assert model.shares_pad_prefix(params, _cache(model, params))
        dparams = M.distribute(params, model.param_specs(), mesh)
        dcache = M.distribute(_cache(model, params), model.cache_specs(), mesh)
        assert not model.shares_pad_prefix(dparams, dcache)
        assert not model.shares_pad_prefix(params, dcache)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_counters_count_the_batches_that_shared_and_their_prefix():
    cfg, eng = serve.build("granite-3-8b", torch.device("cpu"), batch=len(LENGTHS))
    batches = [LENGTHS, [5] * len(LENGTHS), [9, 2, 9, 3, 6]]
    with torch.profiler.profile():
        for i, lens in enumerate(batches):
            eng.serve(requests(lens, cfg.vocab_size, seed=i))
    c = spans.REGISTRY.counter
    mixed = [b for b in batches if min(b) < max(b)]
    assert c("engine.pad_prefix.batches").value == 2
    assert c("engine.pad_prefix.positions").value == sum(max(b) - min(b) for b in mixed)
    assert c("engine.pad_prefix.positions_skipped").value == sum(
        len(b) * max(b) - (max(b) - min(b)) - sum(b) for b in mixed)
    # the padded batch the prefill is handed, as the benchmark reads it
    assert c("engine.positions_computed").value == sum(len(b) * max(b) for b in batches)
