"""Share of the window's wall in HCA's O(log p) tree: the self time of the
program's ``sync.hca.tree`` spans (``repro_torch.core.telemetry``), the
fitpoint sweeps, RTTs and model merges of every round. Nothing to read
where the program records no such span."""


def read(run):
    try:
        from repro_torch.core import telemetry
    except ImportError:
        return None
    s = telemetry.snapshot()["totals"].get("sync.hca.tree")
    return 100.0 * s["self_s"] / run["wall_s"] if s else None
