"""exit_confidence_roofline (%, kernels): the least time of every ``exit_confidence`` call (from its
arguments) over the device time of the kernels launched inside the calls."""
from portbench.harness.readers import roofline


def read(run):
    return roofline(run, "exit_confidence")
