"""Bytes the engine read back from the device (the program's
``engine.d2h_bytes`` counter, ``repro_torch.core.telemetry``) per valid
measurement its records hold (``records.valid_calls``). Nothing to read
where the program keeps no such counters."""


def read(run):
    try:
        from repro_torch.core import telemetry
    except ImportError:
        return None
    c = telemetry.snapshot()["counters"]
    valid = c.get("records.valid_calls", 0)
    return c["engine.d2h_bytes"] / valid if valid and "engine.d2h_bytes" in c else None
