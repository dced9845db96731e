"""Reproducibility-audit walkthrough on the PyTorch port: certifying a
re-run. The port of ``examples/repro_audit.py``.

The paper's headline claim is *reproducible* measurement — but a
difference test can only ever fail to refute sameness. This script shows
the audit layer doing the stronger thing: archiving a reference run,
re-measuring, and positively certifying EQUIVALENT within a ±10% margin
(TOST on per-epoch medians, Holm across the cell family, bootstrap CIs
on the median ratio) — then catching a seeded drift and showing that a
killed audit resumes from its cell log. Every campaign samples through
``sim_scan`` on ``--device`` (the card by default).

    PYTHONPATH=src python examples/repro_audit_torch.py
    PYTHONPATH=src python examples/repro_audit_torch.py --device cpu
"""

import argparse
import tempfile
from pathlib import Path

from repro_torch.campaign import Campaign, CampaignSpec, ResultStore, TorchSimBackend
from repro_torch.core import ExperimentDesign, TestCase
from repro_torch.history import (RunArchive, audit_runs, format_audit_report,
                                 format_drift)

CASES = [TestCase(op, m) for op in ("allreduce", "bcast", "alltoall")
         for m in (512, 4096)]
DESIGN = ExperimentDesign(n_launch_epochs=12, nrep=40, seed=0)
SYNC = dict(n_fitpts=60, n_exchanges=20)


def walkthrough(device: str = "cuda", root: Path | None = None) -> dict:
    """Steps 1-4 of the reference at its sizes, the archive under ``root``
    (a new temporary directory by default); raises where its checks fail.
    Returns the three audit reports."""
    root = Path(tempfile.mkdtemp()) if root is None else Path(root)
    archive = RunArchive(root / "archive")

    def measure_and_register(tag=None, per_op_kw=None):
        backend = TorchSimBackend(p=8, seed0=0, per_op_kw=per_op_kw or {},
                                  sync_kw=dict(SYNC), device=device)
        store = ResultStore(archive.new_store_path())
        Campaign(CampaignSpec(CASES, DESIGN, name="repro-audit"),
                 backend, store).run()
        return archive.register(store.path, tag=tag)

    # --- 1. measure and archive the reference -----------------------------
    ref = measure_and_register(tag="reference")
    print(f"archived reference: run {ref.run_id} "
          f"({ref.n_records} records, host {ref.host})")

    # --- 2. re-run and certify --------------------------------------------
    # The archive resolves the baseline (latest earlier run with the same
    # factor fingerprint); every cell must come out EQUIVALENT.
    cand = measure_and_register()
    report = audit_runs(archive, cand)
    print()
    print(format_audit_report(report, title="same-seed re-run vs reference"))
    if not report.all_equivalent:
        raise AssertionError("the same-seed re-run must be EQUIVALENT in every cell")

    # --- 3. a drifted collective is caught --------------------------------
    # Mis-tune bcast (4x latency term): the audit flags exactly its cells.
    bad = measure_and_register(per_op_kw={"bcast": dict(alpha=12e-6, gamma=6e-6)})
    drifted = audit_runs(archive, bad, baseline_tag="reference")
    print()
    print(format_audit_report(drifted, title="mis-tuned bcast vs reference"))
    print()
    print(format_drift(drifted))
    if {c.op for c in drifted.drifted()} != {"bcast"}:
        raise AssertionError("the mis-tuned run must drift in exactly the bcast cells")

    # --- 4. a killed audit resumes from its cell log ----------------------
    # Truncate audits.jsonl to two finished cells, as a kill mid-comparison
    # would leave it; the re-run recomputes only the missing cells.
    log = archive.root / "audits.jsonl"
    lines = log.read_text().splitlines()
    cells = [i for i, ln in enumerate(lines) if '"audit-cell"' in ln]
    log.write_text("\n".join(lines[:cells[1] + 1]) + "\n")
    resumed = audit_runs(archive, cand)
    same = [c.verdict for c in resumed.cells] == [c.verdict for c in report.cells]
    print(f"\nkilled after 2 cells -> resume: {resumed.n_resumed} cells loaded, "
          f"{resumed.n_computed} recomputed "
          f"(verdicts unchanged: {same})")
    return dict(report=report, drifted=drifted, resumed=resumed, same=same)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return walkthrough(args.device)


if __name__ == "__main__":
    main()
