"""Drift-report formatting: the audit verdict table, paper style.

One row per audited (op, msize) cell — both sides' per-epoch-median
averages, the median ratio with its bootstrap CI, both Holm-adjusted
p-values, and the verdict — plus the factor-diff note that tells a reader
*what changed between the runs* before they interpret any drift.
"""

from __future__ import annotations

from .audit import EQUIVALENT, AuditReport

__all__ = ["format_audit_report", "format_drift"]


def format_audit_report(report: AuditReport, title: str = "") -> str:
    """The full audit table; reads like the guideline verdict tables."""
    lines = []
    if title:
        lines.append(f"# {title}")
    runs = ""
    if report.candidate is not None and report.baseline is not None:
        runs = (f" candidate={report.candidate.run_id}"
                f" baseline={report.baseline.run_id}"
                + (f"[{report.baseline.tag}]" if report.baseline.tag else ""))
    lines.append(
        f"# reproducibility audit{runs} margin=±{report.margin:.0%} "
        f"alpha={report.alpha} statistic={report.statistic} "
        f"cells={len(report.cells)} computed={report.n_computed} "
        f"resumed={report.n_resumed}")
    if report.factor_diffs:
        diffs = ", ".join(f"{k}: {a!r} -> {b!r}"
                          for k, (a, b) in sorted(report.factor_diffs.items()))
        lines.append(f"# factors changed between runs — {diffs}")
    lines.append(
        f"{'op':<14} {'msize':>7} {'ref[us]':>10} {'cand[us]':>10} "
        f"{'ratio':>7} {'CI(ratio)':>17} {'p_tost':>9} {'p_diff':>9} "
        f"{'verdict':>12}")
    for c in report.cells:
        ci = f"[{c.ci_lo:6.3f},{c.ci_hi:6.3f}]"
        lines.append(
            f"{c.op:<14} {c.msize:>7} {c.ref_us:>10.2f} {c.cand_us:>10.2f} "
            f"{c.ratio:>7.3f} {ci:>17} {c.p_tost_holm:>9.2e} "
            f"{c.p_diff_holm:>9.2e} {c.verdict:>12}")
    n = len(report.cells)
    n_eq = sum(1 for c in report.cells if c.verdict == EQUIVALENT)
    n_dr = len(report.drifted())
    lines.append(f"# {n_eq}/{n} EQUIVALENT, {n_dr} DRIFTED, "
                 f"{n - n_eq - n_dr} INCONCLUSIVE "
                 f"(family-wise alpha={report.alpha})")
    return "\n".join(lines)


def format_drift(report: AuditReport) -> str:
    """Compact drifted-cell list for CI logs — empty when nothing drifted."""
    bad = report.drifted()
    if not bad:
        return ""
    lines = [f"drift detected ({len(bad)} cell"
             f"{'s' if len(bad) != 1 else ''}):"]
    for c in bad:
        direction = "slower" if c.ratio > 1.0 else "faster"
        lines.append(
            f"  {c.op} @ msize={c.msize}: candidate {direction} x{c.ratio:.3f}"
            f" (CI [{c.ci_lo:.3f}, {c.ci_hi:.3f}], "
            f"p_holm={c.p_diff_holm:.2e}) vs reference {c.ref_us:.2f}us")
    return "\n".join(lines)
