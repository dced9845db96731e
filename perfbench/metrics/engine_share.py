"""Share of the window's wall in the engine's first windows
(``run_windowed_epochs_torch``, and ``run_windowed_torch`` outside any
top-up): host spans, no top-up inside."""


def read(run):
    s = run["span_s"].get("engine")
    return 100.0 * s / run["wall_s"] if s else None
