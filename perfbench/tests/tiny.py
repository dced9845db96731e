"""Each cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds,
by its system module's ``System.tiny``: the same configuration and
traffic mix, at that module's CPU size."""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench import run as harness  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def system_of(name: str) -> str:
    """The system module's name of cell ``name``."""
    return harness.cell(BENCH, name)[1].get("system", harness.DEFAULT_SYSTEM)


#: The cells that ``sim_campaign`` runs.
SIM_CELLS = [n for n in CELLS if system_of(n) == "sim_campaign"]


def tiny(name: str):
    """``(workload, config, traffic, metrics)`` of cell ``name``, cut down."""
    w, cfg, traffic, metrics = harness.cell(BENCH, name)
    cfg, traffic = harness.system_module(cfg).System.tiny(cfg, traffic)
    return w, cfg, traffic, metrics


def run_tiny(name: str, seed: int = 2**31 + 7, trace: bool = False, seconds: float = 0.2):
    """Cell ``name`` cut down, on the CPU, with one intra-op thread: the
    test workers share the host's cores, and a pool of threads per worker
    oversubscribes them, so that the run's thread is descheduled for tens
    of milliseconds at a time. Blocked modules that other tests already
    loaded into this process are tolerated; none that the run loads is."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.execute(*tiny(name), seed=seed, seconds=seconds, trace=trace,
                               device="cpu", tolerate=frozenset(harness.blocked_modules()))
    finally:
        torch.set_num_threads(threads)
