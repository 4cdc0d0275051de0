"""device_idle_frac (device): the share of the traced window in which
``cuda:0`` ran no kernel, copy or set (the union of the profiler's
device intervals)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
