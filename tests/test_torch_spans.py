"""The serving engine's spans and counters (``repro_torch.obs.spans``) on the
smoke config through ``ServingEngine``, built as ``launch/serve.py`` builds
it: recorded only while ``torch.profiler`` records, nested as the engine's
work nests, counting the padding and the right-sizing of the batches served,
and changing no token."""
import numpy as np
import pytest
import torch

from repro_torch.launch import serve
from repro_torch.obs import spans
from repro_torch.serving import Request

ARCH = "granite-3-8b"
BATCH = 4
BATCHES = 3

#: each span and the spans around it, innermost first
CHAINS = {
    "engine.batch": [()],
    "engine.setup": [("engine.batch",)],
    "engine.plan": [("engine.batch",)],
    "engine.token_read": [("engine.batch",)],
    "model.prefill": [("engine.batch",)],
    "model.decode_step": [("engine.batch",)],
    "kernel.exit_head": [("engine.batch",)],
    "model.segment": [("model.prefill", "engine.batch"),
                      ("model.decode_step", "engine.batch")],
    "kernel.flash_attention": [("model.segment", "model.prefill", "engine.batch")],
    "kernel.decode_attention": [("model.segment", "model.decode_step", "engine.batch")],
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.reset()
    yield
    spans.reset()
    torch.set_num_threads(n)


def build():
    """The engine, and ``BATCHES`` batches of ``BATCH`` requests of unequal
    prompts (so a batch pads) and budgets; each batch is one ``serve()``."""
    cfg, eng = serve.build(ARCH, torch.device("cpu"), batch=BATCH)
    rs = np.random.default_rng(7)
    batches, rid = [], 0
    for _ in range(BATCHES):
        b = []
        for _ in range(BATCH):
            n = int(rs.integers(4, 48))
            b.append(Request(rid=rid, prompt=rs.integers(0, cfg.vocab_size, n).astype(np.int32),
                             max_new_tokens=int(rs.integers(1, 5)), slo_s=0.4))
            rid += 1
        batches.append(b)
    return eng, batches


def serve_all(eng, batches):
    return [eng.serve(b).tokens for b in batches]


def name(ev):
    return ev.name[len(spans.PREFIX):]


def around(ev):
    """The spans around ``ev``, innermost first."""
    out, p = [], ev.cpu_parent
    while p is not None:
        if p.name.startswith(spans.PREFIX):
            out.append(name(p))
        p = p.cpu_parent
    return tuple(out)


def test_every_span_appears_nested_as_the_engine_works():
    eng, batches = build()
    with torch.profiler.profile(record_shapes=True) as prof:
        serve_all(eng, batches)
    evs = [e for e in prof.events() if e.name.startswith(spans.PREFIX)]
    assert {name(e) for e in evs} == set(CHAINS)
    for e in evs:
        assert around(e) in CHAINS[name(e)], (name(e), around(e))
    batch = [e for e in evs if e.name == spans.PREFIX + "engine.batch"]
    assert len(batch) == BATCHES
    for e, b in zip(batch, batches):
        lens = [len(r.prompt) for r in b]
        assert e.kwinputs == {"B": len(lens), "S": max(lens), "prompt": sum(lens)}
    n_seg = eng.model.num_segments
    segs = [e for e in evs if e.name == spans.PREFIX + "model.segment"]
    assert sorted({e.kwinputs["index"] for e in segs}) == list(range(n_seg))
    reg = spans.REGISTRY
    assert reg.counter("engine.batch.calls").value == BATCHES
    steps = sum(max(r.max_new_tokens for r in b) for b in batches)
    assert reg.counter("model.decode_step.calls").value == steps
    assert 0 < reg.counter("model.decode_step.kernel_ns").value <= \
        reg.counter("model.decode_step.host_ns").value


def test_counters_reproduce_the_benchmarks_pad_and_depth_readers():
    """The quantities ``pad_share`` and ``decode_depth_share`` are made of:
    the prompt positions and the ``B x S`` each prefill is handed, and the
    segments each decode step ran of the model's (the benchmark's own test
    holds its readers to these counters); and the pad positions the shared
    pad prefix computed once and those it did not compute."""
    eng, batches = build()
    stepper = eng.stepper
    exits = []

    def choose_exit(remaining, per_exit, left, preferred):
        # at the smoke size no deadline demotes a step: every exit in turn instead
        exits.append(1 + left % stepper.n_graph)
        return exits[-1]

    stepper.choose_exit = choose_exit
    with torch.profiler.profile():
        serve_all(eng, batches)
    c = spans.REGISTRY.counter
    assert c("engine.prompt_positions").value == sum(len(r.prompt) for b in batches for r in b)
    assert c("engine.positions_computed").value == \
        sum(len(b) * max(len(r.prompt) for r in b) for b in batches)
    lens = [[len(r.prompt) for r in b] for b in batches]
    assert all(min(n) < max(n) for n in lens)
    assert c("engine.pad_prefix.batches").value == BATCHES
    assert c("engine.pad_prefix.positions").value == sum(max(n) - min(n) for n in lens)
    assert c("engine.pad_prefix.positions_skipped").value == \
        sum(len(n) * max(n) - (max(n) - min(n)) - sum(n) for n in lens)
    n_seg = eng.model.num_segments
    run = [min(stepper.to_model_exit(g), n_seg) for g in exits]
    assert len(set(run)) > 1
    assert c("model.decode_segments_run").value == sum(run)
    assert c("model.decode_segments_available").value == n_seg * len(exits)
    segs = eng.model.segment_lengths()
    per_unit = eng.model.cfg.num_layers // sum(segs)
    assert c("model.decode_layers").value == sum(sum(segs[:k]) * per_unit for k in run)


def test_one_first_token_sample_per_request_within_its_serve_wall():
    eng, batches = build()
    walls = []
    with torch.profiler.profile():
        for b in batches:
            t0 = spans.clock()
            eng.serve(b)
            walls.append((spans.clock() - t0) * 1e-9)
    first = spans.REGISTRY.histogram("engine.first_token_s").samples
    assert len(first) == BATCHES * BATCH
    assert "engine.last_token_s" not in spans.REGISTRY
    for i, wall in enumerate(walls):
        f = first[i * BATCH:(i + 1) * BATCH]
        assert len(set(f)) == 1                     # one read holds the batch's first tokens
        assert 0 < f[0] <= wall


def test_without_a_profiler_nothing_records_and_tokens_match_a_recorded_run(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("recorded with the gate off")

    checks = []

    def gate():
        checks.append(1)
        return torch.autograd._profiler_enabled()

    eng, batches = build()
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        m.setattr(torch.autograd.profiler, "record_function", refuse)
        m.setattr(spans, "_range", refuse)
        m.setattr(spans, "clock", refuse)
        m.setattr(spans, "on", gate)
        off = serve_all(eng, batches)
    assert spans.REGISTRY.names() == []
    checks_off = len(checks)

    eng, batches = build()
    with monkeypatch.context() as m:
        m.setattr(spans, "on", gate)
        with torch.profiler.profile():
            on = serve_all(eng, batches)
    assert on == off
    opened = sum(spans.REGISTRY.counter(n).value for n in spans.REGISTRY.names()
                 if n.endswith(".calls"))
    # off, each call site checks the gate once: once a span and once a serve()
    assert checks_off == opened + BATCHES
    assert len(checks) == 2 * checks_off
