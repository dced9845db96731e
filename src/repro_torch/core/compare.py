"""Fair comparison of two implementations via hypothesis testing (§6.2).

Copied from the JAX package's ``repro.core.compare`` (numpy only).

Given two :class:`~repro_torch.core.design.ResultTable`\\ s (library/config A vs B),
apply the WILCOXON TEST per test case on the distributions of per-epoch
averages, reporting two-sided significance (Fig. 28) and the one-sided
"is A faster than B?" question (Fig. 30). Comparing on single means —
common practice the paper argues against — is available as
``naive_comparison`` for the benchmarks that demonstrate its instability.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .design import ResultTable, TestCase
from .stats import significance_stars, wilcoxon_rank_sum

__all__ = ["ComparisonRow", "compare_tables", "compare_cases",
           "naive_comparison", "format_comparison"]


@dataclass
class ComparisonRow:
    case: TestCase
    avg_a: float
    avg_b: float
    ratio: float              # avg_a / avg_b
    p_two_sided: float
    p_a_less: float           # H_a: A < B   ("A is faster")
    p_a_greater: float        # H_a: A > B
    n_a: int
    n_b: int

    @property
    def stars(self) -> str:
        return significance_stars(self.p_two_sided)

    @property
    def verdict(self) -> str:
        """Human-readable conclusion at the 5% level."""
        if self.p_a_less <= 0.05:
            return "A<B"
        if self.p_a_greater <= 0.05:
            return "A>B"
        return "indistinguishable"


def compare_tables(
    table_a: ResultTable,
    table_b: ResultTable,
    statistic: str = "median",
) -> list[ComparisonRow]:
    """Per-case Wilcoxon comparison of the per-epoch ``median`` (default,
    as in Fig. 28) or ``mean`` distributions.

    Accepts anything exposing ``cases()``/``medians()``/``means()`` or a
    ``to_table()`` adapter — in particular a
    :class:`~repro_torch.campaign.ResultStore`, so persisted campaigns compare
    across stores and across runs without manual reloading.

    Raises :class:`ValueError` when the two tables share no ``(op, msize)``
    cell with data on both sides — an empty comparison almost always means
    the wrong stores (or the wrong fingerprints) were paired, and silently
    returning an empty table turns that mistake into a vacuous "no
    significant difference" downstream.
    """
    if hasattr(table_a, "to_table"):
        table_a = table_a.to_table()
    if hasattr(table_b, "to_table"):
        table_b = table_b.to_table()
    get = (lambda t, c: t.medians(c)) if statistic == "median" else (lambda t, c: t.means(c))
    keys_b = {c.key() for c in table_b.cases()}
    rows: list[ComparisonRow] = []
    for case in table_a.cases():
        if case.key() not in keys_b:
            continue
        a = get(table_a, case)
        b = get(table_b, case)
        if a.size == 0 or b.size == 0:
            continue
        rows.append(_compare_row(case, a, b))
    if not rows:
        ka = sorted(c.key() for c in table_a.cases())
        kb = sorted(c.key() for c in table_b.cases())
        raise ValueError(
            "compare_tables: no common (op, msize) cells with data on both "
            f"sides — A has {ka or 'no cases'}, B has {kb or 'no cases'}. "
            "Check that the right stores/fingerprints were paired.")
    return rows


def _compare_row(case: TestCase, a: np.ndarray, b: np.ndarray) -> ComparisonRow:
    return ComparisonRow(
        case=case,
        avg_a=float(np.mean(a)),
        avg_b=float(np.mean(b)),
        ratio=float(np.mean(a) / np.mean(b)) if np.mean(b) else float("nan"),
        p_two_sided=wilcoxon_rank_sum(a, b, "two-sided").p_value,
        p_a_less=wilcoxon_rank_sum(a, b, "less").p_value,
        p_a_greater=wilcoxon_rank_sum(a, b, "greater").p_value,
        n_a=int(a.size),
        n_b=int(b.size),
    )


def compare_cases(
    table: ResultTable,
    case_a: TestCase,
    case_b: TestCase,
    statistic: str = "median",
) -> ComparisonRow:
    """Wilcoxon comparison of two *cases inside one table* — the primitive
    of guideline verification (PGMPI): both sides of ``lhs <= rhs`` are
    measured in the same campaign (same launch epochs, same factor set),
    and their per-epoch ``median`` (default) or ``mean`` distributions are
    compared. The returned row's ``case`` is ``case_a`` (the lhs).
    """
    if hasattr(table, "to_table"):
        table = table.to_table()
    get = (lambda c: table.medians(c)) if statistic == "median" \
        else (lambda c: table.means(c))
    a, b = get(case_a), get(case_b)
    if a.size == 0 or b.size == 0:
        missing = [c.key() for c, x in ((case_a, a), (case_b, b))
                   if x.size == 0]
        raise ValueError(f"compare_cases: no data for {missing}; table has "
                         f"{sorted(c.key() for c in table.cases())}")
    return _compare_row(case_a, a, b)


def naive_comparison(table_a: ResultTable, table_b: ResultTable,
                     epoch: int = 0) -> list[tuple[TestCase, float, float]]:
    """The practice the paper warns about (Fig. 27): compare single-epoch
    means and call the smaller one the winner, no dispersion, no test."""
    out = []
    keys_b = {c.key() for c in table_b.cases()}
    for case in table_a.cases():
        if case.key() not in keys_b:
            continue
        a = [s.mean for s in table_a.summaries if s.case.key() == case.key() and s.epoch == epoch]
        b = [s.mean for s in table_b.summaries if s.case.key() == case.key() and s.epoch == epoch]
        if a and b:
            out.append((case, a[0], b[0]))
    return out


def format_comparison(rows: list[ComparisonRow], name_a: str = "A",
                      name_b: str = "B") -> str:
    lines = [
        f"{'op':<12} {'msize':>8} {name_a + ' [us]':>12} {name_b + ' [us]':>12} "
        f"{'ratio':>7} {'p(2s)':>9} {'sig':>4} {'verdict':>18}"
    ]
    for r in rows:
        lines.append(
            f"{r.case.op:<12} {r.case.msize:>8} {r.avg_a * 1e6:>12.2f} "
            f"{r.avg_b * 1e6:>12.2f} {r.ratio:>7.3f} {r.p_two_sided:>9.2e} "
            f"{r.stars:>4} {r.verdict:>18}"
        )
    return "\n".join(lines)
