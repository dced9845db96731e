"""Guideline verification walkthrough on the PyTorch port: auditing a
collectives library. The port of ``examples/verify_guidelines.py``.

PGMPI-style performance guidelines (arXiv:1606.00215) are self-consistency
requirements — "allgather must not lose to alltoall", "bcast must not lose
to a scatter+allgather mock-up of itself" — and the paper's measurement
method exists precisely so such claims get defensible verdicts. This
script verifies the stock guideline family against an honest simulated
library, then against one with a deliberately mis-tuned collective, and
shows the resumable store in between. Every campaign samples through
``sim_scan`` on ``--device`` (the card by default).

    PYTHONPATH=src python examples/verify_guidelines_torch.py
    PYTHONPATH=src python examples/verify_guidelines_torch.py --device cpu
"""

import argparse
import os
import tempfile

from repro_torch.campaign import ResultStore, TorchSimBackend
from repro_torch.core import ExperimentDesign
from repro_torch.guidelines import (SIM_GUIDELINES, Guideline, format_report,
                                    format_violations, verify_guidelines)


DESIGN = ExperimentDesign(n_launch_epochs=10, nrep_min=20, nrep_max=120,
                          rel_ci_target=0.05, seed=0)


def walkthrough(device: str = "cuda") -> dict:
    """Steps 1-4 of the reference at its sizes. Returns the honest, the
    resumed and the mis-tuned reports."""
    # --- 1. the guideline family ------------------------------------------
    # Each guideline is `lhs ⪯ rhs` over op expressions: "+" sequences
    # collectives inside one timed region (a mock-up), "*k" scales the
    # message size, "@half" runs a term on half the processes
    # (split-robustness).
    for g in SIM_GUIDELINES:
        print(f"  {g.name:<30} {g.lhs} ⪯ {g.rhs}"
              + (f"  (rhs at {g.rhs_msize_scale:g}x msize)"
                 if g.rhs_msize_scale != 1.0 else ""))

    # --- 2. verify against an honest library, through a persistent store --
    store_path = os.path.join(tempfile.mkdtemp(), "guidelines.jsonl")
    honest = TorchSimBackend(p=8, seed0=0, device=device)
    report = verify_guidelines(SIM_GUIDELINES, honest, design=DESIGN,
                               store=ResultStore(store_path))
    print()
    print(format_report(report, title="honest library"))

    # --- 3. re-running resumes: every cell loads, nothing is re-measured --
    report2 = verify_guidelines(SIM_GUIDELINES, honest, design=DESIGN,
                                store=ResultStore(store_path))
    print(f"\nresume: measured={report2.n_measured} "
          f"resumed={report2.n_resumed} (same verdicts: "
          f"{[v.verdict for v in report2.verdicts] == [v.verdict for v in report.verdicts]})")

    # --- 4. a mis-tuned collective is flagged -----------------------------
    # Inflate alltoall's latency terms; the mock-up bound that holds for
    # the honest model is now broken, and only it. per_op_kw is part of the
    # factor fingerprint, so this campaign cannot silently resume the
    # honest one.
    family = list(SIM_GUIDELINES) + [
        Guideline("alltoall_mock_bound", lhs="alltoall",
                  rhs="allreduce*2+bcast*2",
                  description="mock-up bound: alltoall ⪯ allreduce(2m)+bcast(2m)"),
    ]
    seeded = TorchSimBackend(p=8, seed0=0,
                             per_op_kw={"alltoall": dict(alpha=12e-6, gamma=10e-6)},
                             device=device)
    bad = verify_guidelines(family, seeded, design=DESIGN)
    print()
    print(format_report(bad, title="mis-tuned alltoall"))
    print()
    print(format_violations(bad) or "no violations")
    return dict(report=report, resumed=report2, bad=bad)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return walkthrough(args.device)


if __name__ == "__main__":
    main()
