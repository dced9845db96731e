"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and
``examples/serve_lm_torch.py`` import neither JAX nor the JAX package
``repro``, checked statically over the sources and at run time in a
subprocess where both are blocked (a simulated campaign, the same
campaign through the reference's numpy ``batch`` engine, the
``batch_rw`` and ``scalar`` windows on walking clocks and a JK fitpoint,
a kernel
guideline campaign, a two-cell factor sweep, a drift audit, a two-cell
in-process fleet under soft crashes, and the model zoo's serving path:
``repro_torch.configs``, ``repro_torch.models`` and
``repro_torch.launch`` on every smoke architecture, then the serve
example; and the training path: a bf16 train step, a checkpoint saved and
restored, and the supervised trainer through a failure, with ``ml_dtypes``
blocked too, since the card's machine lacks it; and real collectives: a
two-epoch ``TorchCollectiveBackend`` campaign on two gloo ranks, a fresh
rank group each epoch; and the dry run: ``repro_torch.parallel`` and
``repro_torch.launch.dryrun`` on smoke gemma2-2b's train cell over a fake
world of 8 ranks; all on the CPU)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("*_torch.py"))
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
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"):
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

from repro_torch.core import ClockParams, SimNet, make_op, make_sync, run_windowed
from repro_torch.core.sync import collect_fitpoint

np_res = Campaign(spec, TorchSimBackend(p=4, device="cpu", engine="batch",
                                        sync_kw=dict(n_fitpts=20, n_exchanges=5))).run()
assert [r.meta["engine"] for r in np_res.records] == ["batch"] * 4
net = SimNet(4, seed=2, clocks=ClockParams(rw_sigma=1e-7))
sync = make_sync("hca", n_fitpts=20, n_exchanges=5).synchronize(net)
for engine in ("batch_rw", "scalar"):
    assert run_windowed(net, sync, make_op("bcast"), 256, 10, 300e-6, device="cpu",
                        engine=engine).times.shape == (10,)
assert len(collect_fitpoint(net, 1, 0, 2e-5, 5)) == 2

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

import runpy
import torch
from repro_torch.configs import ARCHS, get_smoke
from repro_torch.launch import make_decode_step, make_prefill_step
from repro_torch.models import init_cache, init_params, prefill
from repro_torch.models.lm import encode

n_archs = 0
for arch in ARCHS:
    cfg = get_smoke(arch)
    model = init_params(cfg, device="cpu", seed=0)
    toks = torch.randint(0, cfg.vocab_size, (1, 8))   # a multiple of the SSM chunk
    batch = {"tokens": toks}
    if cfg.frontend == "vision":
        batch["embeds"] = torch.randn(1, cfg.frontend_tokens, cfg.d_model)
    if cfg.frontend == "audio":
        batch["memory"] = encode(cfg, model, torch.randn(1, cfg.frontend_tokens, cfg.d_model))
    logits = make_prefill_step(cfg)(model, batch)
    _, cache = prefill(cfg, model, toks[:, :4], memory=batch.get("memory"), max_len=6)
    step, _ = make_decode_step(cfg)(model, cache, dict(batch, tokens=toks[:, 4:5]))
    assert logits.shape == (1, 8, cfg.vocab_size) and bool(torch.isfinite(step).all())
    n_archs += 1

sys.argv = ["serve_lm_torch.py", "--device", "cpu", "--batch", "2", "--prompt-len", "4",
            "--tokens", "6"]
runpy.run_path(EXAMPLE, run_name="__main__")

from repro_torch.checkpoint import CheckpointConfig, CheckpointStore
from repro_torch.convert import load_train_state, train_state_tree
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import init_train_state, make_train_step
from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig, run_supervised
from repro_torch.runtime.trainer import to_device

cfg = get_smoke("gemma2-2b").scaled(dtype="bfloat16")
state = init_train_state(init_params(cfg, device="cpu", seed=0))
batch = to_device(SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                         global_batch=2)).batch_at(0), "cpu")
state, metrics = make_train_step(cfg)(state, batch)
ckpt = CheckpointStore(CheckpointConfig(directory=tempfile.mkdtemp()))
ckpt.save(1, train_state_tree(state))
other = init_train_state(init_params(cfg, device="cpu", seed=1))
restored, _ = ckpt.restore(train_state_tree(other))
load_train_state(other, restored)
assert torch.equal(other["params"].embed, state["params"].embed)
trainer = Trainer(cfg.scaled(dtype="float32"),
                  DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2),
                  trainer_cfg=TrainerConfig(total_steps=4, save_every=2, log_every=100),
                  ckpt_cfg=CheckpointConfig(directory=tempfile.mkdtemp()), device="cpu")
trained = run_supervised(trainer, FailureInjector((3,)))
assert trained["restarts"] == 1 and bool(torch.isfinite(metrics["loss"]))

from repro_torch import TorchCollectiveBackend

with TorchCollectiveBackend(n_ranks=2, device="cpu") as coll:
    coll_res = Campaign(CampaignSpec([TestCase("psum", 256), TestCase("all_gather", 256)],
                                     ExperimentDesign(n_launch_epochs=2, nrep=5, seed=1)),
                        coll).run()
assert len({tuple(r.meta["rank_pids"]) for r in coll_res.records}) == 2

from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ShapeSpec
from repro_torch.launch.dryrun import lower_cell
from repro_torch.launch.mesh import fake_world, mesh_device_type
from repro_torch.parallel import param_specs  # noqa: F401

with fake_world(8):
    mesh = init_device_mesh(mesh_device_type(), (4, 2), mesh_dim_names=("data", "model"))
    cell, _ = lower_cell("gemma2-2b", ShapeSpec("t", 32, 8, "train"), mesh=mesh,
                         cfg=get_smoke("gemma2-2b"))
assert cell.flops_per_device > 0 and cell.collective_ops

loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))
assert not loaded, loaded
print("ok", len(res.records), report.n_measured, len(sweep.cells), len(audit.cells),
      len(fleet.cells), n_archs, len(trained["losses"]), len(coll_res.records), cell.mesh)
"""


def test_port_runs_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    example = ROOT / "examples" / "serve_lm_torch.py"
    proc = subprocess.run([sys.executable, "-c", f"EXAMPLE = {str(example)!r}\n" + _BLOCKED_RUN],
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("prefill: 2x4 tokens in ")          # the serve example
    assert lines[-1] == "ok 4 8 2 1 2 10 5 4 4x2"
