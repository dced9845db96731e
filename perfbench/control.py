"""The precision control of the correctness check.

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3 [--campaigns 3]

The plain reference, put in the program's place and computed in float32
(the precision below the configuration's float64) at the cell's own sizes,
measures the epochs a run of ``--campaigns`` campaigns would check, top-ups
by its own flags; the check then compares it with the float64 reference
as it compares the program. Prints one JSON line per seed with the numbers
compared and the limits. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def captures(cfg: dict, traffic: dict, seed: int, campaigns: int, device) -> dict:
    import torch

    from perfbench.reference.engine import Epoch, case_orders
    from perfbench.traffic import campaign

    out = {}
    for k in range(campaigns):
        plan = campaign(traffic, seed, k)
        order = case_orders(plan.design_seed, plan.epochs, list(plan.cases))
        for e in plan.check_epochs:
            ep = Epoch(cfg, plan.seed0, e, device, dtype=torch.float32)
            cap = {"sync": (ep.sync.slope, ep.sync.intercept, ep.sync.init),
                   "calls": [], "records": {}}
            for op, m in order[e]:
                runs, rec = ep.measure(op, m, plan.nrep)
                cap["calls"] += [(op, m, size, t, er) for size, t, er in runs]
                cap["records"][(op, m)] = rec
            out[(plan, e)] = cap
    return out


def readings(cfg: dict, traffic: dict, seed: int, campaigns: int, device) -> dict:
    from perfbench.check import check

    return check(cfg, captures(cfg, traffic, seed, campaigns, device), device)


def main(argv=None) -> None:
    sys.path[:0] = [str(ROOT)]
    from perfbench.check import NUMBERS, verdict
    from perfbench.run import cell, load_json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--campaigns", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, cfg, traffic, _ = cell(load_json(ROOT / "BENCHMARK.json"), args.workload)
    for seed in args.seeds:
        nums = readings(cfg, traffic, seed, args.campaigns, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fails": not verdict(nums, cfg["limits"]),
                          "numbers": nums, "limits": {k: cfg["limits"].get(k) for k in NUMBERS}}),
              flush=True)


if __name__ == "__main__":
    main()
