"""One run of one cell: set-up, warm-up, the measured window, the metrics, the
check, and the result line.

Set-up is everything from process start to the first timed batch: imports, the
kernel library (built into the checkout's ``build/`` on a first run), the weights
made on the device, the engine, and a warm-up that serves the pool's costliest
batch and a cheap one under the other tenant, through the same engine object the
window then drives.  The window hands ``serve()`` one batch at a time and closes
when the first call that ends past ``seconds`` returns.
"""
from __future__ import annotations

import gc
import json
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from portbench.harness import check, serve, spec, trace, traffic
from portbench.reference.plan import segment_lengths

BANNED = ("jax", "jaxlib", "flax", "repro")


@dataclass
class RunRecord:
    """What the metric readers read."""
    cfg: dict
    mix: dict
    setup_s: float
    window_s: float
    calls: List[serve.Call]
    trace: Optional[trace.TraceData] = None
    setup_parts: Dict[str, float] = field(default_factory=dict)

    def requests(self):
        return [r for c in self.calls for r in c.batch.requests]

    def decode_layers(self, call: serve.Call) -> List[int]:
        """Layers each decode step of ``call`` ran."""
        segs = segment_lengths(self.cfg)
        n = len(segs)
        return [sum(segs[:n if e is None else e + 1]) for e in call.exits]


def banned_modules(names=None) -> List[str]:
    """Banned top-level names, compared whole, among ``names`` (the modules loaded
    in this process when None)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(BANNED))


def load_limits(cell: str) -> dict:
    data = json.loads((spec.HERE / "limits" / f"{cell}.json").read_text())
    return {k: v["limit"] for k, v in data.items()}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, t_start: float,
        device: Optional[torch.device] = None, smoke: bool = False,
        keep: Optional[dict] = None, t_torch: Optional[float] = None):
    """Returns (result dict, RunRecord).  ``smoke``: the port's CPU-sized config in
    float32 on ``device`` (the tests'; the command line never takes it).
    ``keep`` receives the check's sampled jobs and their reference logits;
    ``t_torch``: when ``import torch`` returned, to split the imports' time."""
    device = device or torch.device("cuda")
    on_card = device.type == "cuda"
    cfg, mix = cell.config, cell.traffic
    if smoke:
        cfg = dict(cfg, **serve.smoke_sizes(cfg))
    dtype = torch.bfloat16 if cfg["dtype"] == "bfloat16" and not smoke else torch.float32
    parts: Dict[str, float] = {}
    import repro_torch.serving  # noqa: F401  (the program's imports, counted as such)
    if t_torch is not None:
        parts["torch_import_s"] = t_torch - t_start
        parts["program_import_s"] = time.monotonic() - t_torch
    else:
        parts["import_s"] = time.monotonic() - t_start
    if on_card:
        t = time.monotonic()
        from repro_torch.kernels import build
        build.library()
        parts["kernel_load_s"] = time.monotonic() - t
        torch.cuda.reset_peak_memory_stats(device)
    t = time.monotonic()
    eng = serve.build(cfg, mix, seed, device, dtype, smoke=smoke, timings=parts)
    parts["engine_s"] = time.monotonic() - t - parts["weights_s"]
    calllog = serve.CallLog(eng)
    stream = traffic.Stream(mix, seed, cfg["vocab_size"])
    t = time.monotonic()
    for b in stream.warmup():
        calllog.serve(b)
    if on_card:
        torch.cuda.synchronize(device)
    parts["warmup_s"] = time.monotonic() - t

    tracer = prof = None
    if traced:
        tracer = trace.Tracer(eng, device)
        tracer.install()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    calls = []
    t_w0 = time.monotonic()
    setup_s = t_w0 - t_start
    with torch.profiler.record_function(f"{trace.PREFIX}window:0"):
        while True:
            call = calllog.serve(stream.next())
            calls.append(call)
            if call.t1 - t_w0 >= seconds:
                break
    window_s = calls[-1].t1 - t_w0
    tdata = None
    if traced:
        prof.__exit__(None, None, None)
        tracer.uninstall()
        t = time.monotonic()
        tdata = tracer.data
        trace.reduce(prof, tdata, f"{trace.PREFIX}window:0")
        del prof
        log(f"trace reduced in {time.monotonic() - t:.1f} s: {len(tdata.ops)} kernel-wrapper "
            f"calls, {tdata.unattributed_calls} with no device operation between their markers")
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    rec = RunRecord(cfg, mix, setup_s, window_s, calls, tdata, parts)
    log("set-up split (s): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; setup_s {setup_s:.3f}")
    n_req = len(rec.requests())
    log(f"window {window_s:.3f} s: {len(calls)} batches, {n_req} requests "
        f"(request_p95_s over {n_req} samples)")

    metrics = {}
    kind = "per_layer" if traced else "end_to_end"
    for m in cell.metrics:
        if m.kind != kind:
            continue
        v = m.read(rec)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}

    # the program's state goes before the reference runs
    n_seg = eng.model.num_segments
    served = [serve.served_batch(c, n_seg) for c in calls]
    for c in calls:
        c.prompts, c.picks = [], []
    params, bw = eng.params, eng.trace
    eng.engine.last_hidden = None
    del eng, calllog
    gc.collect()             # the call log's wrappers and the engine form cycles
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    t = time.monotonic()
    res = check.check(cfg, mix, params, served, bw, seed, load_limits(cell.name), keep=keep)
    if keep is not None:
        keep["params"] = params
    log(f"check: {res['picks_compared']} picks compared in {time.monotonic() - t:.1f} s")

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if traced:
        dev["busy_s"], dev["window_s"] = tdata.busy_s, tdata.window_s
    out = {"correct": bool(res["correct"]), "attempted": n_req, "failed": 0,
           "metrics": metrics, "device": dev}
    if traced:
        out["breakdown"] = {"device_ops": [list(x) for x in tdata.device_ops],
                            "idle_gaps": [list(x) for x in tdata.idle_gaps]}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in res["checks"].items()}
    return out, rec
