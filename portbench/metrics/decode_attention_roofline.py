"""decode_attention_roofline (%, kernels): the least time of every ``decode_attention`` call (from its
arguments) over the device time of the kernels launched inside the calls."""
from portbench.harness.readers import roofline


def read(run):
    return roofline(run, "decode_attention")
