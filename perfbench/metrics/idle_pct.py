"""Share of the traced window in which no operation ran on the device
(kernels, copies and sets, from the profiler's trace)."""


def read(run):
    trace = run.get("trace")
    if trace is None or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
