"""Each cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds:
the same configuration and traffic mix with 8 hosts, HCA at 20 x 5, two
epochs a campaign, every epoch checked, and nrep 300 (drawn in buckets)
or 1100 (drawn at its own length) for mixes above and below 1024."""

from __future__ import annotations

import copy
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


def tiny(name: str):
    """``(workload, config, traffic, metrics)`` of cell ``name``, cut down."""
    w, cfg, traffic, metrics = harness.cell(BENCH, name)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg.update(p=8, n_fitpts=20, n_exchanges=5)
    traffic.update(nrep=1100 if traffic["nrep"] >= 1024 else 300,
                   epochs_per_campaign=2, check_epochs_per_campaign=2)
    return w, cfg, traffic, metrics


def run_tiny(name: str, seed: int = 2**31 + 7, trace: bool = False, seconds: float = 0.2):
    """Cell ``name`` cut down, on the CPU. Blocked modules that other tests
    already loaded into this process are tolerated; none that the run
    loads is."""
    return harness.execute(*tiny(name), seed=seed, seconds=seconds, trace=trace, device="cpu",
                           tolerate=frozenset(harness.blocked_modules()))
