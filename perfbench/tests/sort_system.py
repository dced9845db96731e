"""A second system module, for the harness's own tests: batches of rows
sorted by ``torch.sort``, checked against NumPy's sort of the same rows. It lives
beside the tests and not in ``perfbench/systems/``, so no configuration
can name it and it adds no cell; the tests hand it to
``harness.execute(..., system=...)``.

Its configuration gives ``rows`` and ``n`` (a batch is ``rows`` rows of
``n`` numbers) and the limit of ``sort_gap``; a batch's rows come from the
run's seed and the batch's index.
"""

from __future__ import annotations

import copy
import time

import numpy as np

NUMBERS = ("sort_gap",)


def sort_rows(x):
    """What the window times."""
    import torch

    return torch.sort(x, dim=1).values


class System:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str, tracer):
        self.cfg, self.seed, self.device, self.tracer = cfg, int(seed), device, tracer
        self.kept: list = []

    @staticmethod
    def tiny(cfg: dict, traffic: dict) -> tuple[dict, dict]:
        cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
        cfg.update(rows=8, n=64)
        return cfg, traffic

    def batch(self, k: int):
        """Batch ``k`` of the run, on the host as float64."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed % 2**64, k]))
        return rng.standard_normal((self.cfg["rows"], self.cfg["n"]))

    def setup(self) -> dict:
        import torch

        t = time.perf_counter()
        sort_rows(torch.zeros((self.cfg["rows"], self.cfg["n"]), dtype=torch.float64,
                              device=self.device))
        return {"warm": time.perf_counter() - t}

    def run(self, seconds: float) -> dict:
        import torch

        k = 0
        with self.tracer.annotate("window"):
            t0 = time.perf_counter()
            while True:
                x = torch.from_numpy(self.batch(k)).to(self.device)
                self.kept.append((k, sort_rows(x).cpu().numpy()))
                k += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            wall = time.perf_counter() - t0
        rows = k * self.cfg["rows"]
        return dict(wall_s=wall, due=rows, records=rows, valid=rows * self.cfg["n"], batches=k)

    def check(self) -> dict:
        gap = 0.0
        for k, got in self.kept:
            gap = max(gap, float(np.abs(got - np.sort(self.batch(k), axis=1)).max()))
        return {"sort_gap": gap, "batches_checked": len(self.kept)}

    @staticmethod
    def summary(run: dict, numbers: dict) -> dict:
        return {"wall_s": run["wall_s"], "batches": run["batches"], "check_s": run["check_s"],
                "setup_parts": run["setup_parts"], "batches_checked": numbers["batches_checked"]}
