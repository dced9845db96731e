"""Share of the window's wall in the backend's ``_top_up``: the windows
that replace discarded calls, and the record's assembly (host spans)."""


def read(run):
    s = run["span_s"].get("topup")
    return 100.0 * s / run["wall_s"] if s else None
