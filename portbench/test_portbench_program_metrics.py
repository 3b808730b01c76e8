"""The readers of the program's own spans and counters (``repro_torch.obs.spans``):
on a registry filled by hand, silent on an empty registry and on a program without
one; and the program's pad and depth counters against the readers of the benchmark's
own wrappers on the same served batches."""
import sys

import numpy as np
import pytest
import torch

from portbench.harness import cellrun, serve, spec, trace, traffic

CELL = "granite-3-8b.longdoc"
SEED = 2_621_634_535


@pytest.fixture
def reg():
    from repro_torch.obs import spans
    spans.reset()
    yield spans.REGISTRY
    spans.reset()


def window(sizes, pool_batches=4):
    """A run record whose window served batches of ``sizes`` requests."""
    calls, rid = [], 0
    for i, n in enumerate(sizes):
        reqs = [traffic.Request(rid + j, np.zeros(4, np.int32), 2, 1.0, "t") for j in range(n)]
        rid += n
        calls.append(serve.Call(traffic.Batch(i, "t", reqs), 0))
    return cellrun.RunRecord({}, {"pool_batches": pool_batches}, 1.0, 10.0, calls)


def test_decode_host_us_per_layer_leaves_out_the_kernel_spans(reg):
    reg.counter("model.decode_step.host_ns").inc(90_000_000)   # 90 ms of steps
    reg.counter("model.decode_step.kernel_ns").inc(30_000_000)  # 30 ms in kernel spans
    reg.counter("model.decode_layers").inc(48)                  # one step at 40, one at 8
    assert spec.metric_reader("decode_host_us_per_layer")(None) == pytest.approx(60e3 / 48)


@pytest.mark.parametrize("served", [2, 3, 5], ids=["half-pool", "more", "most"])
def test_first_token_p95_s_over_the_windows_first_half_pool(reg, served):
    """The same first batches give the same reading, however many more the window
    served after them."""
    first = [0.5 + 0.01 * i for i in range(2 * 8)]
    for s in first + [9.0] * 8 * (served - 2):
        reg.histogram("engine.first_token_s").observe(s)
    assert spec.metric_reader("first_token_p95_s")(window([8] * served)) == pytest.approx(
        float(np.percentile(first, 95)))


def test_first_token_p95_s_reads_a_short_window_whole(reg):
    samples = [0.5, 0.7, 0.9]
    for s in samples:
        reg.histogram("engine.first_token_s").observe(s)
    assert spec.metric_reader("first_token_p95_s")(window([3])) == pytest.approx(
        float(np.percentile(samples, 95)))


@pytest.mark.parametrize("name", ["decode_host_us_per_layer", "first_token_p95_s"])
def test_none_on_an_empty_registry(reg, name):
    assert spec.metric_reader(name)(window([8])) is None
    reg.counter("model.decode_layers")                # registered, never counted
    assert spec.metric_reader(name)(window([8])) is None


@pytest.mark.parametrize("name", ["decode_host_us_per_layer", "first_token_p95_s"])
def test_none_from_a_program_without_the_registry(reg, monkeypatch, name):
    import repro_torch.obs
    reg.counter("model.decode_layers").inc(8)
    reg.histogram("engine.first_token_s").observe(1.0)
    assert spec.metric_reader(name)(window([1])) is not None
    monkeypatch.delattr(repro_torch.obs, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.obs.spans", None)
    assert spec.metric_reader(name)(window([1])) is None


def test_program_counters_equal_the_pad_and_depth_readers(reg):
    """On the smoke config, the program's counters give what ``pad_share`` and
    ``decode_depth_share`` read from the benchmark's wrappers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cell = spec.load_cell(CELL)
        mix = dict(cell.traffic, prompt_len=dict(cell.traffic["prompt_len"],
                                                 median=24, min=4, max=48))
        cfg = dict(cell.config, **serve.smoke_sizes(cell.config))
        eng = serve.build(cfg, mix, SEED, torch.device("cpu"), torch.float32, smoke=True)
        stream = traffic.Stream(mix, SEED, cfg["vocab_size"])
        stepper = eng.engine.stepper
        # at the smoke size no deadline demotes a step: every exit in turn instead
        stepper.choose_exit = lambda remaining, per_exit, left, pref: 1 + left % stepper.n_graph
        calllog = serve.CallLog(eng)
        tracer = trace.Tracer(eng, torch.device("cpu"))
        tracer.install()
        try:
            with torch.profiler.profile():
                calls = [calllog.serve(stream.next()) for _ in range(3)]
        finally:
            tracer.uninstall()
    finally:
        torch.set_num_threads(n)
    rec = cellrun.RunRecord(cfg, mix, 0.0, 1.0, calls, tracer.data)
    pad = spec.metric_reader("pad_share")(rec)
    depth = spec.metric_reader("decode_depth_share")(rec)
    c = reg.counter
    prompt, computed = c("engine.prompt_positions").value, c("engine.positions_computed").value
    run, avail = c("model.decode_segments_run").value, c("model.decode_segments_available").value
    assert 100.0 * (1.0 - prompt / computed) == pad
    assert 100.0 * run / avail == depth
    assert 0 < depth < 100 and 0 < pad < 100
