"""request_p95_s (s, host clock): the 95th percentile, over every request completed
in the window, of the wall from the moment its batch is handed to ``serve()`` to
that call's return (which ends on a host read of the tokens)."""
import numpy as np


def read(run):
    walls = [c.wall_s for c in run.calls for _ in c.batch.requests]
    return float(np.percentile(walls, 95)) if walls else None
