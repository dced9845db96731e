"""Share of the window's wall growing the walking clocks' drift paths on
the host for the deadline inversion, on a thread pool: the program's
``drift.deadlines`` spans (``repro_torch.core.telemetry``, around
``grow_paths_for_deadlines``). Nothing to read on affine clocks, or where
the program records no such span."""


def read(run):
    try:
        from repro_torch.core import telemetry
    except ImportError:
        return None
    s = telemetry.snapshot()["totals"].get("drift.deadlines")
    return 100.0 * s["total_s"] / run["wall_s"] if s else None
