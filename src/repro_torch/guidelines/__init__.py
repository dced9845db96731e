"""repro_torch.guidelines — PGMPI-style performance-guideline verification.

Copied from the JAX package's ``repro.guidelines`` (numpy host logic over
the port's campaign layer); the kernel family compares the hand-written
kernels with their plain versions.

Declares performance guidelines (``lhs ⪯ rhs`` over collective/mock-up
expressions) as first-class objects and verifies them against any
:class:`~repro_torch.campaign.MeasurementBackend` through the campaign layer:
resumable stores, adaptive ``nrep``, Wilcoxon verdicts with Holm
family-wise correction. This turns the repo from "measures collectives"
into "audits implementations". ::

    from repro_torch.campaign import ResultStore, TorchKernelBackend
    from repro_torch.guidelines import (KERNEL_GUIDELINES, format_report,
                                        verify_guidelines)

    report = verify_guidelines(KERNEL_GUIDELINES, TorchKernelBackend(),
                               store=ResultStore("g.jsonl"))
    print(format_report(report))
    assert report.ok, "guideline violations found"
"""

from .engine import (DEFAULT_MSIZES, GuidelineReport, GuidelineVerdict,
                     compile_cases, verdicts_from_table, verify_guidelines)
from .report import format_report, format_violations
from .rules import (KERNEL_GUIDELINES, SIM_GUIDELINES, Guideline,
                    default_guidelines)

__all__ = [
    "Guideline",
    "SIM_GUIDELINES",
    "KERNEL_GUIDELINES",
    "default_guidelines",
    "GuidelineVerdict",
    "GuidelineReport",
    "compile_cases",
    "verdicts_from_table",
    "verify_guidelines",
    "DEFAULT_MSIZES",
    "format_report",
    "format_violations",
]
