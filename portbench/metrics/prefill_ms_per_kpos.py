"""prefill_ms_per_kpos (ms, model step): ``Model.prefill`` span time (synchronised
at both ends) per 1000 positions it computed, padding included."""
from portbench.harness.readers import spans


def read(run):
    pre = spans(run, "prefill")
    pos = sum(s.info["B"] * s.info["S"] for s in pre)
    return sum(s.ms for s in pre) / (pos / 1000.0) if pos else None
