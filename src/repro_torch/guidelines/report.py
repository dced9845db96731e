"""PGMPI-style verdict report formatting.

The verdict table mirrors the guideline-verification tables of
arXiv:1606.00215: one row per (guideline, message size) cell, the
measured averages of both sides, the violation p-value raw and
Holm-adjusted, and the verdict. ``holds(<)`` marks a guideline with
positive evidence (lhs significantly faster), ``holds(~)`` one that is
merely not refuted — the distinction PGMPI draws between a guideline the
data supports and one the data cannot decide.
"""

from __future__ import annotations

from ..core.stats import significance_stars

from .engine import GuidelineReport

__all__ = ["format_report", "format_violations"]


def format_report(report: GuidelineReport, title: str = "") -> str:
    """The full verdict table, PGMPI style."""
    lines = []
    if title:
        lines.append(f"# {title}")
    lines.append(
        f"# backend={report.backend_name} statistic={report.statistic} "
        f"alpha={report.alpha} cells={len(report.verdicts)} "
        f"measured={report.n_measured} resumed={report.n_resumed}"
        + (f" fingerprint={report.fingerprint}" if report.fingerprint else ""))
    lines.append(
        f"{'guideline':<30} {'msize':>7} {'lhs[us]':>10} {'rhs[us]':>10} "
        f"{'ratio':>7} {'p(viol)':>9} {'p(holm)':>9} {'sig':>4} {'verdict':>9}")
    for v in report.verdicts:
        stars = significance_stars(v.p_holm) if v.violated else \
            (significance_stars(v.p_confirmed) if v.confirmed else "")
        lines.append(
            f"{v.guideline.name:<30} {v.msize:>7} {v.lhs_us:>10.2f} "
            f"{v.rhs_us:>10.2f} {v.ratio:>7.3f} {v.p_violated:>9.2e} "
            f"{v.p_holm:>9.2e} {stars:>4} {v.verdict:>9}")
    bad = report.violations()
    if bad:
        lines.append(f"# {len(bad)}/{len(report.verdicts)} cells VIOLATED "
                     f"(family-wise alpha={report.alpha})")
    else:
        lines.append(f"# all {len(report.verdicts)} cells hold "
                     f"(family-wise alpha={report.alpha})")
    return "\n".join(lines)


def format_violations(report: GuidelineReport) -> str:
    """Compact violation list for CI logs — empty string when all hold."""
    bad = report.violations()
    if not bad:
        return ""
    lines = ["guideline violations:"]
    for v in bad:
        lines.append(
            f"  {v.guideline.name} @ msize={v.msize}: "
            f"{v.guideline.lhs} = {v.lhs_us:.2f}us  >  "
            f"{v.guideline.rhs} = {v.rhs_us:.2f}us "
            f"(x{v.ratio:.2f}, p_holm={v.p_holm:.2e}) — "
            f"{v.guideline.description or 'guideline broken'}")
    return "\n".join(lines)
