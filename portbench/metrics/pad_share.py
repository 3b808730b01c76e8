"""pad_share (%, engine): padded positions over the positions ``Model.prefill``
computed, from the shapes it received and the requests' own prompt lengths."""
from portbench.harness.readers import spans


def read(run):
    pre = spans(run, "prefill")
    computed = sum(s.info["B"] * s.info["S"] for s in pre)
    if not computed:
        return None
    return 100.0 * (1.0 - sum(len(r.prompt) for r in run.requests()) / computed)
