"""``sim_scan``'s share of its roofline: the least time of the window's
launches (48 bytes an element at the HBM rate, perfbench.yardstick) over
the kernel's device time in the profiler's trace."""

from perfbench.yardstick import sim_scan_bound_s


def read(run):
    trace = run.get("trace")
    if trace is None:
        return None
    names = [n for n in trace.device_s if "sim_scan_kernel" in n]
    kernel_s = sum(trace.device_s[n] for n in names)
    launches = sum(trace.device_n[n] for n in names)
    if kernel_s <= 0 or launches != len(run["scan_shapes"]):
        return None
    return 100.0 * sim_scan_bound_s(run["scan_shapes"]) / kernel_s
