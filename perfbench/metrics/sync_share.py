"""Share of the window's wall in the backend's ``make_epoch``: a fresh
simulated cluster and its clock synchronization (host spans)."""


def read(run):
    s = run["span_s"].get("sync")
    return 100.0 * s / run["wall_s"] if s else None
