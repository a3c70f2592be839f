"""Share of the profiled ticks' wall time in which no kernel, copy or
set ran on the device: 1 minus the union of their intervals (%)."""


def read(run, name):
    if run.trace is None:
        return None
    t = run.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
