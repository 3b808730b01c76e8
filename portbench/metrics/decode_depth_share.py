"""decode_depth_share (%, planner and right-sizing): segments run per decode step
over the model's segments, from the exit each ``Model.decode_step`` received."""
from portbench.harness.readers import spans


def read(run):
    dec = spans(run, "decode_step")
    if not dec:
        return None
    return 100.0 * sum(s.info["segments"] for s in dec) / sum(s.info["n_segments"] for s in dec)
