"""device_idle_share (%, device): one minus the union of the device's operation
intervals over the profiled window."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
