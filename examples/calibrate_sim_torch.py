"""Sim↔real calibration walkthrough on the PyTorch port: fitting the
simulator, then certifying the fit. The port of
``examples/calibrate_sim.py``.

A simulator predicts real MPI behavior only when its *variability* model
is calibrated against measurements (Cornebize & Legrand). By default this
script plays that loop with a simulated "truth" standing in for hardware:
measure the truth, fit SimNet's noise knobs by deterministic quantile
matching, certify the fitted simulator EQUIVALENT on held-out launch
epochs the fit never saw (TOST ±10%, Holm-corrected), and show that a
killed fit resumes by replaying its persisted ``calib-round`` search
state. Every candidate samples through ``sim_scan`` on ``--device`` (the
card by default).

``--target collective`` fits against real collectives instead: a
``TorchCollectiveBackend`` of ``--ranks`` ranks (``psum`` and
``all_gather`` at 512 and 4096 B, a fresh rank group each launch epoch),
with the reference CLI's defaults (``benchmarks/run.py calibrate --target
jax``: ``op.alpha,op.noise_sigma,op.tail_prob``, 12 epochs, nrep 30, the
latency bounds widened 100x). The process-group backend is gloo unless
``--dist-backend nccl`` is given, which takes one rank per GPU. Against
real hardware the verdict is a finding, not a gate.

    PYTHONPATH=src python examples/calibrate_sim_torch.py
    PYTHONPATH=src python examples/calibrate_sim_torch.py --device cpu
    PYTHONPATH=src python examples/calibrate_sim_torch.py --target collective \\
        --ranks 4 --device cpu
"""

import argparse
import json
import tempfile
import time
from pathlib import Path

from repro_torch.calibrate import calibrate, default_space
from repro_torch.campaign import (ResultStore, TorchCollectiveBackend,
                                  TorchSimBackend)
from repro_torch.core import ExperimentDesign, TestCase
from repro_torch.history import RunArchive, format_audit_report

SYNC = dict(n_fitpts=60, n_exchanges=20)
TRUTH_ALPHA = 6e-6
COLLECTIVE_PARAMS = ("op.alpha", "op.noise_sigma", "op.tail_prob")


def walkthrough(device: str, root: Path) -> dict:
    """The reference's shifted-truth walkthrough: fit, certify, resume."""
    archive = RunArchive(root / "archive")
    cases = [TestCase(op, m) for op in ("allreduce", "bcast") for m in (512, 4096)]
    design = ExperimentDesign(n_launch_epochs=24, nrep=30, seed=3)

    # --- 1. the "truth": what hardware would be ---------------------------
    # a simulator with a deliberately shifted latency term and its own
    # seed0 (the fit must match the *distribution*, not one realization)
    truth = TorchSimBackend(p=8, seed0=1009, op_kw=dict(alpha=TRUTH_ALPHA),
                            sync_kw=dict(SYNC), device=device)

    # --- 2. fit a bounded noise-model surface -----------------------------
    # one strongly identifiable knob keeps the walkthrough fast
    space = default_space(base=TorchSimBackend(p=8, seed0=0, sync_kw=dict(SYNC),
                                               device=device),
                          names=["op.alpha"])
    store = ResultStore(archive.new_store_path(stem="calib"))
    result = calibrate(space, truth, cases=cases, design=design,
                       store=store, archive=archive, seed=3)

    fitted = result.params["op.alpha"]
    print(f"truth alpha = {TRUTH_ALPHA:.3e}, fitted = {fitted:.3e} "
          f"({abs(fitted - TRUTH_ALPHA) / TRUTH_ALPHA:.1%} off), "
          f"objective {result.objective:.4f} after {len(result.rounds)} rounds")
    print()
    print(format_audit_report(result.report,
                              title="held-out certification (fit never saw "
                                    "these epochs)"))
    assert result.ok, result.verdict
    print(f"\narchived as run {result.run_entry.run_id} "
          f"[{result.run_entry.tag}]; fit report kinds in the manifest: "
          f"{len(archive.calibrations())}")

    # --- 3. a killed fit resumes ------------------------------------------
    # truncate the store right after the first persisted search round (the
    # moment a SIGKILL might land) and run the identical calibrate() again
    lines = store.path.read_text().splitlines(keepends=True)
    cut = next(i for i, ln in enumerate(lines)
               if json.loads(ln).get("kind") == "calib-round") + 1
    killed = root / "killed.jsonl"
    killed.write_text("".join(lines[:cut]))
    resumed = calibrate(space, truth, cases=cases, design=design,
                        store=ResultStore(killed), seed=3)
    assert resumed.params == result.params
    assert resumed.n_rounds_resumed == 1
    print(f"\nresumed fit: {resumed.n_rounds_resumed} round replayed from the "
          f"store, identical params {resumed.params} — "
          f"verdict {resumed.verdict}")
    return dict(result=result, resumed=resumed)


def fit_collective(device: str, root: Path, ranks: int = 4,
                   dist_backend: str = "gloo", params=COLLECTIVE_PARAMS,
                   epochs: int = 12, nrep: int = 30, rounds: int = 8,
                   seed: int = 0) -> dict:
    """Fit ``TorchSimBackend(p=ranks)`` to real collectives on ``ranks``
    ranks of ``dist_backend`` and certify it on the held-out epochs. The
    fit's wall includes the target campaign (a rank group per epoch)."""
    archive = RunArchive(root / "archive")
    # real collectives cost far more per call than the stock latency
    # bounds allow (sized for simulator-scale tens of us): widen them
    space = default_space(base=TorchSimBackend(p=ranks, seed0=seed,
                                               sync_kw=dict(SYNC), device=device),
                          names=list(params), latency_scale=100.0)
    # the reference's op names: make_op starts them from the base noise
    # model, so the fit, not a preset, reproduces the measured latencies
    cases = [TestCase(op, m) for op in ("psum", "all_gather") for m in (512, 4096)]
    design = ExperimentDesign(n_launch_epochs=epochs, nrep=nrep, seed=seed)
    store = ResultStore(archive.new_store_path(stem="calib"))
    t = time.perf_counter()
    with TorchCollectiveBackend(n_ranks=ranks, device=device,
                                dist_backend=dist_backend) as target:
        result = calibrate(space, target, cases=cases, design=design,
                           store=store, archive=archive, seed=seed,
                           max_rounds=rounds)
    wall = time.perf_counter() - t
    fitted = ", ".join(f"{k}={v:.4g}" for k, v in result.params.items())
    print(format_audit_report(
        result.report, title=f"calibration certification [{ranks} {dist_backend} "
                             f"ranks on {device} -> sim, {result.n_heldout_epochs} "
                             "held-out epochs]"))
    print(f"fitted: {fitted}; objective {result.objective:.6f} after "
          f"{len(result.rounds)} rounds; verdict {result.verdict}; "
          f"{result.spent_nrep} nrep spent; wall {wall:.2f} s")
    return dict(result=result, wall=wall, store=store.path)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--target", default="sim", choices=("sim", "collective"),
                    help="a shifted-truth simulator (default) or real "
                         "collectives on torch.distributed")
    ap.add_argument("--ranks", type=int, default=4,
                    help="ranks of the collective target (default 4)")
    ap.add_argument("--dist-backend", default="gloo", choices=("gloo", "nccl"),
                    help="process-group backend of the collective target")
    ap.add_argument("--rounds", type=int, default=8,
                    help="coordinate-descent rounds of the collective fit")
    args = ap.parse_args(argv)
    root = Path(tempfile.mkdtemp(prefix="calibrate_sim_torch_"))
    if args.target == "sim":
        return walkthrough(args.device, root)
    return fit_collective(args.device, root, ranks=args.ranks,
                          dist_backend=args.dist_backend, rounds=args.rounds)


if __name__ == "__main__":
    main()
