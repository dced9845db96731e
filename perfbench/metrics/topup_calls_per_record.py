"""Engine windows (``run_windowed_torch``) run inside ``_top_up``, per
record measured in the window (each record is topped up once)."""


def read(run):
    return run["topup_calls"] / run["records"] if run["records"] else None
