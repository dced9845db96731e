"""The guideline verifier: compile → campaign → per-cell verdicts.

:func:`verify_guidelines` is the first end-to-end consumer of the
campaign subsystem: it compiles every guideline side into campaign test
cases (shared sides are measured once), runs them through
:class:`~repro_torch.campaign.Campaign` against any
:class:`~repro_torch.campaign.MeasurementBackend` — resumable through a
:class:`~repro_torch.campaign.ResultStore`, adaptive-``nrep`` when the design
says so — and then answers, per (guideline, message size), the one-sided
Wilcoxon question "is the lhs slower than the rhs?" on the distribution
of per-epoch medians, with Holm's step-down correction across the whole
family so the false-violation rate of the *report* (not of each cell) is
bounded by ``alpha``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..campaign import Campaign, CampaignSpec, MeasurementBackend, ResultStore
from ..core.compare import ComparisonRow, compare_cases
from ..core.design import ExperimentDesign, TestCase
from ..core.stats import holm_bonferroni

from .rules import Guideline

__all__ = ["GuidelineVerdict", "GuidelineReport", "compile_cases",
           "verdicts_from_table", "verify_guidelines", "DEFAULT_MSIZES"]

DEFAULT_MSIZES: tuple[int, ...] = (1024, 8192)


@dataclass(frozen=True)
class GuidelineVerdict:
    """One verified cell: a guideline at one message size."""

    guideline: Guideline
    msize: int
    lhs_case: TestCase
    rhs_case: TestCase
    lhs_us: float              # mean of per-epoch averages, lhs [us]
    rhs_us: float
    ratio: float               # lhs / rhs
    p_violated: float          # raw one-sided p for H_a: lhs > rhs
    p_holm: float              # Holm-adjusted p_violated over the family
    p_confirmed: float         # raw one-sided p for H_a: lhs < rhs
    n_epochs: int
    alpha: float

    @property
    def violated(self) -> bool:
        """lhs significantly slower than rhs after Holm correction — the
        guideline is broken and the report must say so."""
        return self.p_holm <= self.alpha

    @property
    def confirmed(self) -> bool:
        """lhs significantly *faster* (raw test) — the guideline holds with
        positive evidence, not merely absence of evidence."""
        return not self.violated and self.p_confirmed <= self.alpha

    @property
    def verdict(self) -> str:
        if self.violated:
            return "VIOLATED"
        return "holds(<)" if self.confirmed else "holds(~)"


@dataclass
class GuidelineReport:
    """Everything a CI job or a tuning loop needs from one verification."""

    verdicts: list[GuidelineVerdict]
    backend_name: str
    alpha: float
    statistic: str
    n_measured: int = 0
    n_resumed: int = 0
    fingerprint: str | None = None
    meta: dict = field(default_factory=dict)

    def violations(self) -> list[GuidelineVerdict]:
        return [v for v in self.verdicts if v.violated]

    @property
    def ok(self) -> bool:
        return not self.violations()


def _guideline_msizes(g: Guideline, msizes) -> tuple[int, ...]:
    return tuple(g.msizes) if g.msizes else tuple(msizes)


def compile_cases(guidelines, msizes=DEFAULT_MSIZES) -> list[TestCase]:
    """Every distinct campaign case the guideline family needs, in first-
    use order. Sides shared between guidelines (or appearing at the same
    effective message size, e.g. a monotonicity rhs that coincides with
    another guideline's lhs) are measured once."""
    out: list[TestCase] = []
    seen = set()
    for g in guidelines:
        for m in _guideline_msizes(g, msizes):
            for case in g.cases(m):
                if case.key() not in seen:
                    seen.add(case.key())
                    out.append(case)
    return out


def verdicts_from_table(
    guidelines,
    table,
    msizes=DEFAULT_MSIZES,
    alpha: float = 0.05,
    statistic: str = "median",
) -> list[GuidelineVerdict]:
    """The statistical half of verification, separated from measurement:
    per-(guideline, msize) one-sided Wilcoxon on an already-measured
    result table, Holm-corrected across the family.

    Splitting this out is what makes the verdict procedure itself
    *testable*: the soundness tier feeds it thousands of synthetic
    null-hypothesis tables and pins the empirical false-violation rate —
    the same code path a real campaign's verdicts take, not a re-derivation.
    """
    guidelines = list(guidelines)
    if not guidelines:
        raise ValueError("verdicts_from_table: empty guideline family")
    cells: list[tuple[Guideline, int, ComparisonRow]] = []
    for g in guidelines:
        for m in _guideline_msizes(g, msizes):
            lhs_case, rhs_case = g.cases(m)
            cells.append((g, m, compare_cases(table, lhs_case, rhs_case,
                                              statistic)))
    p_holm = holm_bonferroni([row.p_a_greater for _, _, row in cells])
    return [
        GuidelineVerdict(
            guideline=g, msize=m,
            lhs_case=row.case, rhs_case=g.cases(m)[1],
            lhs_us=row.avg_a * 1e6, rhs_us=row.avg_b * 1e6,
            ratio=row.ratio,
            p_violated=row.p_a_greater, p_holm=float(adj),
            p_confirmed=row.p_a_less,
            n_epochs=row.n_a, alpha=alpha,
        )
        for (g, m, row), adj in zip(cells, p_holm)
    ]


def verify_guidelines(
    guidelines,
    backend: MeasurementBackend,
    design: ExperimentDesign | None = None,
    msizes=DEFAULT_MSIZES,
    store: ResultStore | None = None,
    alpha: float = 0.05,
    statistic: str = "median",
    name: str = "guidelines",
) -> GuidelineReport:
    """Verify a guideline family against a measurement backend.

    One campaign measures the union of all guideline sides (dedup'd); with
    a ``store`` the campaign resumes — a killed verification re-measures
    only the missing cells, and re-running a finished one measures
    nothing. The default design uses adaptive ``nrep`` so quiet cells stop
    early and heavy-tailed ones get the sample they need.
    """
    guidelines = list(guidelines)
    if not guidelines:
        raise ValueError("verify_guidelines: empty guideline family")
    if design is None:
        design = ExperimentDesign(n_launch_epochs=10, nrep_min=20,
                                  nrep_max=150, rel_ci_target=0.05, seed=0)
    cases = compile_cases(guidelines, msizes)
    spec = CampaignSpec(cases=cases, design=design, name=name)
    res = Campaign(spec, backend, store).run()
    verdicts = verdicts_from_table(guidelines, res.table, msizes=msizes,
                                   alpha=alpha, statistic=statistic)
    return GuidelineReport(
        verdicts=verdicts, backend_name=backend.name, alpha=alpha,
        statistic=statistic, n_measured=res.n_measured,
        n_resumed=res.n_resumed, fingerprint=res.fingerprint,
        meta=dict(n_cases=len(cases), design_seed=design.seed,
                  n_launch_epochs=design.n_launch_epochs),
    )
