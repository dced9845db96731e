"""Device-to-host reads that block the host (the program's
``engine.readbacks`` counter, ``repro_torch.core.telemetry``) per engine
window (``engine.windows``; a fused epoch counts once). Nothing to read
where the program keeps no such counters."""


def read(run):
    try:
        from repro_torch.core import telemetry
    except ImportError:
        return None
    c = telemetry.snapshot()["counters"]
    windows = c.get("engine.windows", 0)
    return c["engine.readbacks"] / windows if windows and "engine.readbacks" in c else None
