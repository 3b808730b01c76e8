"""decode_step_ms (ms, model step): ``Model.decode_step`` span time (synchronised at
both ends) per decode step, at whatever exit the step ran."""
from portbench.harness.readers import spans


def read(run):
    dec = spans(run, "decode_step")
    return sum(s.ms for s in dec) / len(dec) if dec else None
