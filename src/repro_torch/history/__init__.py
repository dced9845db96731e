"""repro_torch.history — the cross-run reproducibility-audit layer.

Everything below this package measures and compares *within* a run; this
package is about runs separated by time. A :class:`RunArchive` indexes
many :class:`~repro_torch.campaign.ResultStore` JSONLs (factor fingerprint +
host + timestamp, one manifest so lookups never re-parse the stores), and
:func:`audit_runs` issues per-cell ``EQUIVALENT`` / ``DRIFTED`` /
``INCONCLUSIVE`` verdicts — TOST equivalence with a relative margin,
two-sided drift evidence, bootstrap CIs on the median ratio, Holm across
the family — resumably, through an append-only audit log. ::

    from repro_torch.history import RunArchive, audit_runs, format_audit_report

    archive = RunArchive("runs/")
    ref = archive.register("runs/run-000.jsonl", tag="reference")
    cand = archive.register("runs/run-001.jsonl")
    report = audit_runs(archive, cand, baseline_tag="reference")
    print(format_audit_report(report))
    assert report.ok, "performance drifted vs the archived reference"

Every measurement backend — simulated today, real hardware tomorrow —
reports through this layer: a campaign store registered into an archive
becomes tomorrow's baseline. The manifest and audit-log lines are the
reference package's, so an archive either package wrote reads in the
other (``benchmarks/reference_archive/`` audits a port run directly).
"""

from .archive import CONTROL_TAG, RunArchive, RunEntry
from .audit import (DEFAULT_MARGIN, AuditReport, CellVerdict, audit_runs,
                    audit_tables)
from .report import format_audit_report, format_drift

__all__ = [
    "RunArchive",
    "RunEntry",
    "CONTROL_TAG",
    "AuditReport",
    "CellVerdict",
    "audit_tables",
    "audit_runs",
    "DEFAULT_MARGIN",
    "format_audit_report",
    "format_drift",
]
