"""Share of the window's wall growing the walking clocks' drift paths on
the host for the forward reads of the stamps, serially: the program's
``drift.reads`` spans (``repro_torch.core.telemetry``, around
``grow_paths_for_reads``). Nothing to read on affine clocks, or where the
program records no such span."""


def read(run):
    try:
        from repro_torch.core import telemetry
    except ImportError:
        return None
    s = telemetry.snapshot()["totals"].get("drift.reads")
    return 100.0 * s["total_s"] / run["wall_s"] if s else None
