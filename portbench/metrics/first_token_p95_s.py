"""first_token_p95_s (s, engine): the 95th percentile, over the requests of the traced
window's first half-pool of batches (16 of ``longdoc``'s 32), of the host seconds from
the program's ``ServingEngine.serve`` entry to the return of the token read that first
holds the request's first generated token, from the program's span registry
(``repro_torch.obs.spans``), which records while the traced window's profiler runs.

The batches are fixed by ``--seed`` alone: a change that serves faster fits more batches
into the window but does not change which batches this reads (a window that serves fewer
than half the pool is read whole).  Each ``serve()`` call is one batch, and the registry
keeps one sample per request in serving order.  None where the program has no such
registry or it holds no request."""
import numpy as np


def read(run):
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    reg = spans.REGISTRY
    if "engine.first_token_s" not in reg:
        return None
    calls = run.calls[:run.mix["pool_batches"] // 2]
    n = sum(1 for c in calls for r in c.batch.requests if r.max_new_tokens)
    samples = reg.histogram("engine.first_token_s").samples[:n]
    return float(np.percentile(samples, 95)) if samples else None
