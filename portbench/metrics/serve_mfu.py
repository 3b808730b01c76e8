"""serve_mfu (%, the served window): the model FLOPs the window's requests need
(unpadded prompts at full depth with the last position's head, and each served
decode token at the depth its step ran) over the traced window's time at the bf16
peak (989 TFLOP/s, the card at its full 700 W)."""
from portbench.harness import flops, peaks


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    need = 0.0
    for c in run.calls:
        layers = run.decode_layers(c)
        for r in c.batch.requests:
            need += flops.request_flops(run.cfg, len(r.prompt), layers[:r.max_new_tokens])
    return 100.0 * need / (t.window_s * peaks.PEAK_FLOPS_BF16)
