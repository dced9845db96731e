"""Share of the window's records in which the window scheme discarded every
call, first window and top-ups alike (counted in the backend's ``_top_up``):
records delivered with no valid measurement."""


def read(run):
    return 100.0 * run["empty"] / run["records"] if run["records"] else None
