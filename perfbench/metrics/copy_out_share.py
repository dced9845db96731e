"""Share of the window's wall in the engine's read-back copies: the self
time of the program's ``engine.copy_out`` spans
(``repro_torch.core.telemetry``), which follow an explicit wait for the
window's device work, so they time the device-to-host copies alone.
Nothing to read where the program records no such span."""


def read(run):
    try:
        from repro_torch.core import telemetry
    except ImportError:
        return None
    s = telemetry.snapshot()["totals"].get("engine.copy_out")
    return 100.0 * s["self_s"] / run["wall_s"] if s else None
