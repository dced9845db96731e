"""Share of the window's wall sending the drift paths' new nodes to their
device mirror: the program's ``drift.upload`` spans
(``repro_torch.core.telemetry``, around ``_DevicePaths.upload``). Nothing
to read on affine clocks, or where the program records no such span."""


def read(run):
    try:
        from repro_torch.core import telemetry
    except ImportError:
        return None
    s = telemetry.snapshot()["totals"].get("drift.upload")
    return 100.0 * s["total_s"] / run["wall_s"] if s else None
