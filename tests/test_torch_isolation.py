"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package ``repro``, checked statically over the
sources and at run time in a subprocess where both are blocked (a
simulated campaign, a kernel guideline campaign, a two-cell factor sweep,
a drift audit and a two-cell in-process fleet under soft crashes, on the
CPU)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
BLOCKED = ("jax", "jaxlib", "repro")


def _blocked(module: str) -> bool:
    top = module.split(".")[0]
    return top in BLOCKED


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _blocked(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


_BLOCKED_RUN = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
from repro_torch import Campaign, CampaignSpec, ExperimentDesign, TestCase, TorchSimBackend

spec = CampaignSpec([TestCase("allreduce", 512), TestCase("bcast", 4096)],
                    ExperimentDesign(n_launch_epochs=2, nrep=20, seed=1))
res = Campaign(spec, TorchSimBackend(p=4, device="cpu",
                                     sync_kw=dict(n_fitpts=20, n_exchanges=5))).run()
assert len(res.records) == 4 and all(r.times.size for r in res.records)

import dataclasses
from repro_torch import TorchKernelBackend
from repro_torch.guidelines import KERNEL_GUIDELINES, verify_guidelines

family = [dataclasses.replace(g, msizes=(32,)) for g in KERNEL_GUIDELINES]
report = verify_guidelines(family, TorchKernelBackend(device="cpu", heads=2, head_dim=16),
                           design=ExperimentDesign(n_launch_epochs=2, nrep=3, seed=1))
assert len(report.verdicts) == 2 and report.n_measured == 8

from repro_torch.campaign import SweepScheduler
from repro_torch.history import audit_tables
from repro_torch.sweeps import default_sim_sweep

sweep_spec, sweep_backend = default_sim_sweep(seed=1, axes=("tuning",), msizes=(512,),
                                              n_launch_epochs=2, nrep=10, p=4,
                                              device="cpu")
sweep = SweepScheduler(sweep_spec, sweep_backend).run()
assert len(sweep.cells) == 2
audit = audit_tables(sweep.cells[0].table, sweep.cells[1].table)
assert len(audit.cells) == 1

import tempfile
from pathlib import Path
from repro_torch.campaign import ResultStore
from repro_torch.fleet import FaultPlan, FleetConfig, FleetScheduler

store = ResultStore(Path(tempfile.mkdtemp()) / "fleet.jsonl")
fleet = FleetScheduler(sweep_spec, sweep_backend, store,
                       FleetConfig(n_workers=1, sleep=lambda s: None,
                                   faults=FaultPlan(seed=0, p_crash=1.0,
                                                    within_calls=1))).run()
assert len(fleet.cells) == 2 and not fleet.quarantined
assert fleet.fleet["n_failed_attempts"] == 2
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not loaded, loaded
print("ok", len(res.records), report.n_measured, len(sweep.cells), len(audit.cells),
      len(fleet.cells))
"""


def test_port_runs_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "ok 4 8 2 1 2"
