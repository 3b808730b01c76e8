"""The per-layer readers and the trace's reduction, on synthetic call logs."""
import numpy as np
import pytest

from portbench.harness import cellrun, peaks, serve, spec, trace, traffic

CFG = {"family": "dense", "num_layers": 40, "num_exits": 4, "d_model": 8, "num_heads": 2,
       "num_kv_heads": 1, "head_dim": 4, "d_ff": 16, "vocab_size": 100}


def reader(name):
    return spec.metric_reader(name)


def req(rid, n, new=3):
    return traffic.Request(rid, np.zeros(n, np.int32), new, 1.0, "t")


def record(spans=(), ops=(), busy=0.0, window=0.0, calls=()):
    data = trace.TraceData(ops=list(ops), spans=list(spans), busy_s=busy, window_s=window)
    return cellrun.RunRecord(CFG, {}, 1.0, 10.0, list(calls), data)


def test_pad_share_from_the_shapes_prefill_received():
    calls = [serve.Call(traffic.Batch(0, "t", [req(0, 3), req(1, 5)]), 0),
             serve.Call(traffic.Batch(1, "t", [req(2, 4), req(3, 4)]), 0)]
    spans = [trace.Span("prefill", "pb:prefill:1", 1.0, {"B": 2, "S": 5}),
             trace.Span("prefill", "pb:prefill:2", 1.0, {"B": 2, "S": 4})]
    assert reader("pad_share")(record(spans, calls=calls)) == pytest.approx(100 * (1 - 16 / 18))
    assert reader("pad_share")(record(calls=calls)) is None


def test_decode_depth_share_from_the_exits_decode_steps_received():
    spans = [trace.Span("decode_step", f"pb:decode_step:{i}", 1.0,
                        {"B": 8, "segments": s, "n_segments": 5}) for i, s in enumerate([1, 1, 5, 5, 3])]
    assert reader("decode_depth_share")(record(spans)) == pytest.approx(100 * 15 / 25)


def test_model_step_spans():
    spans = [trace.Span("prefill", "a", 30.0, {"B": 2, "S": 1000}),
             trace.Span("decode_step", "b", 4.0, {"B": 2, "segments": 1, "n_segments": 5}),
             trace.Span("decode_step", "c", 6.0, {"B": 2, "segments": 5, "n_segments": 5})]
    assert reader("prefill_ms_per_kpos")(record(spans)) == pytest.approx(15.0)
    assert reader("decode_step_ms")(record(spans)) == pytest.approx(5.0)


def test_roofline_reader_and_its_silence():
    ops = [trace.OpCall("flash_attention", "x", 989e12 * 1e-3, 0.0, 2, device_s=2e-3, kernels=1),
           trace.OpCall("flash_attention", "y", 0.0, 3.35e12 * 1e-3, 2, device_s=2e-3, kernels=1),
           trace.OpCall("flash_attention", "z", 1e9, 0.0, 2, device_s=0.0, kernels=0)]
    assert reader("flash_attention_roofline")(record(ops=ops)) == pytest.approx(50.0)
    assert reader("decode_attention_roofline")(record(ops=ops)) is None
    assert reader("flash_attention_roofline")(record()) is None


def test_idle_share_and_mfu():
    calls = [serve.Call(traffic.Batch(0, "t", [req(0, 10, 2)]), 0, exits=[None, 0])]
    rec = record(busy=3.0, window=4.0, calls=calls)
    assert reader("device_idle_share")(rec) == pytest.approx(25.0)
    from portbench.harness import flops
    want = flops.request_flops(CFG, 10, [40, 8])
    assert reader("serve_mfu")(rec) == pytest.approx(100 * want / (4.0 * peaks.PEAK_FLOPS_BF16))
    assert reader("serve_mfu")(record(busy=0.0, window=4.0, calls=calls)) is None


def test_end_to_end_readers():
    calls = [serve.Call(traffic.Batch(0, "t", [req(0, 10), req(1, 30)]), 0, t0=0.0, t1=2.0),
             serve.Call(traffic.Batch(1, "t", [req(2, 20), req(3, 20)]), 0, t0=2.0, t1=3.0)]
    rec = cellrun.RunRecord(CFG, {}, 7.5, 3.0, calls)
    assert reader("prompt_tokens_per_s")(rec) == pytest.approx(80 / 3.0)
    assert reader("request_p95_s")(rec) == pytest.approx(np.percentile([2, 2, 1, 1], 95))
    assert reader("setup_s")(rec) == 7.5


def test_reduce_takes_each_calls_operations_between_its_markers():
    """The host's spans are skewed against the device's clock: the markers on the
    device's own timeline still give each call its own kernels."""
    M = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    ev = [("pb:window:0", False, 0, 1000, ),
          ("pb:exit_confidence:1", False, 100, 300),
          ("pb:decode_step:2", False, 400, 600),
          ("pb:decode_attention:3", False, 450, 550),
          # the device clock runs 120 ns behind the host's
          (M, True, 10, 12), ("exit_head", True, 20, 200), (M, True, 205, 207),
          ("rms_norm", True, 260, 270),
          (M, True, 330, 332), ("decode_attn", True, 335, 380), (M, True, 385, 387)]
    data = trace.TraceData(ops=[trace.OpCall("exit_confidence", "pb:exit_confidence:1", 0, 0, 2),
                                trace.OpCall("decode_attention", "pb:decode_attention:3", 0, 0, 2)])
    trace.reduce_events(ev, data, "pb:window:0")
    assert data.unattributed_calls == 0
    assert data.ops[0].kernels == 1 and data.ops[0].device_s == pytest.approx(180e-9)
    assert data.ops[1].kernels == 1 and data.ops[1].device_s == pytest.approx(45e-9)
    assert data.busy_s == pytest.approx(235e-9) and data.window_s == pytest.approx(1e-6)
    assert "spin_kernel" not in " ".join(n for n, _ in data.device_ops)
    assert sum(v for _, v in data.idle_gaps) == pytest.approx(1e-6 - 235e-9)


def test_reduce_refuses_markers_that_do_not_pair_with_the_calls():
    """A wrapper that nests calls, or a marker that leaves the trace, would give a
    call another's kernels: the reduction refuses the trace."""
    M = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    ev = [("pb:window:0", False, 0, 100), ("pb:flash_attention:1", False, 10, 50),
          (M, True, 12, 13), ("flash", True, 20, 40), ("other", True, 60, 70)]
    data = trace.TraceData(ops=[trace.OpCall("flash_attention", "pb:flash_attention:1", 0, 0, 2)])
    with pytest.raises(RuntimeError, match="1 marker kernels in the window for 1"):
        trace.reduce_events(ev, data, "pb:window:0")


def test_reduce_without_device_operations_leaves_the_calls_without_device_time():
    """A run on the CPU: no device operation, no marker; idle gaps by host span."""
    ev = [("pb:window:0", False, 0, 100), ("pb:flash_attention:1", False, 10, 50)]
    data = trace.TraceData(ops=[trace.OpCall("flash_attention", "pb:flash_attention:1", 0, 0, 2)])
    trace.reduce_events(ev, data, "pb:window:0")
    assert data.ops[0].kernels == 0 and data.unattributed_calls == 1
    assert data.busy_s == 0 and data.window_s == pytest.approx(100e-9)
    assert reader("flash_attention_roofline")(record(ops=data.ops)) is None
