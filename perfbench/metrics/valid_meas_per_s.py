"""Valid per-call measurements in the records of every campaign the window
ran, over the window's wall time (host clock, ending in a device
synchronize)."""


def read(run):
    return run["valid"] / run["wall_s"] if run["wall_s"] > 0 else None
