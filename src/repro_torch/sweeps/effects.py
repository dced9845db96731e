"""Nonparametric factor-impact analysis of a completed sweep.

The analysis that turns a grid of measured cells back into the paper's
headline table — *which experimental factors have an impact on run-time*:

  * per-axis **main effects**: Kruskal-Wallis across the axis levels on
    *aligned* per-case-normalized per-epoch medians (the paper's unit of
    analysis, §6.2) — aligned meaning each observation is centered on the
    median of its complementary-factor stratum (the cells that agree on
    every *other* axis), the aligned-rank device for factorial designs
    that keeps a huge factor from drowning the contrast of a modest one —
    with Holm step-down across the axis family so the report's
    false-"factor matters" rate is bounded by alpha, pairwise one-sided
    Wilcoxon between levels, and Cliff's-delta effect sizes — the |delta|
    is the ranking key ("which factor matters *most*"), because unlike a
    p-value it does not inflate with sample size;
  * a pairwise **interaction screen**: for each axis pair, how much the
    conditional Cliff's delta of one axis moves across the levels of the
    other. A screen, not a test — it ranks candidate interactions for a
    follow-up sweep, it does not assign them p-values.

Normalization: every per-epoch median is divided by the grand median of
its own test case across all cells, so observations from different
message sizes pool on a common dimensionless scale and a factor's effect
is measured *relative* to typical run-time.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.stats import (cliffs_delta, holm_bonferroni, kruskal_wallis,
                          significance_stars, wilcoxon_rank_sum)

__all__ = [
    "CellData",
    "PairEffect",
    "AxisEffect",
    "AxisDecision",
    "InteractionEffect",
    "cells_from_result",
    "cells_from_store",
    "main_effects",
    "axis_decisions",
    "alpha_spending",
    "interaction_screen",
    "format_factor_report",
    "quantile_distance",
    "DEFAULT_QUANTILES",
]

#: Quantiles a distribution match is scored on: the body (median and
#: quartiles) plus the 10/90 shoulders where the simulator's bimodal-tail
#: and spike mixture actually shows. Deliberately not the extreme tail —
#: per-epoch medians of a short campaign estimate q=0.99 with pure noise.
DEFAULT_QUANTILES = (0.1, 0.25, 0.5, 0.75, 0.9)


def quantile_distance(ref: np.ndarray, cand: np.ndarray,
                      quantiles: tuple = DEFAULT_QUANTILES) -> float:
    """Distance between two samples of per-epoch medians (the paper's
    aligned unit of analysis, the same arrays :class:`CellData` carries):
    the mean absolute log-ratio of their quantiles.

    The log-ratio scale makes the distance symmetric, unit-free and
    additive across cells of very different magnitude — a 10% mismatch at
    q=0.9 costs the same for a 5 us bcast as for a 5 ms alltoall — which
    is what lets a calibration objective sum it over (op, msize) cells.
    """
    ref = np.asarray(ref, np.float64)
    cand = np.asarray(cand, np.float64)
    if ref.size == 0 or cand.size == 0:
        raise ValueError("quantile_distance: empty sample")
    if np.any(ref <= 0) or np.any(cand <= 0):
        raise ValueError("quantile_distance: run-times must be positive")
    qs = np.asarray(quantiles, np.float64)
    qr = np.quantile(ref, qs)
    qc = np.quantile(cand, qs)
    return float(np.mean(np.abs(np.log(qc / qr))))


@dataclass
class CellData:
    """The analysis view of one grid cell: its level labels and the
    per-epoch medians of every case it measured."""

    index: int
    levels: dict[str, str]
    medians: dict[tuple[str, int], np.ndarray]


def cells_from_result(result) -> list[CellData]:
    """Adapt a :class:`~repro_torch.campaign.SweepResult` for analysis."""
    out = []
    for c in result.cells:
        meds = {case.key(): c.table.medians(case) for case in c.table.cases()}
        out.append(CellData(index=c.cell.index, levels=c.levels(),
                            medians=meds))
    return out


def cells_from_store(store, sweep_id: str | None = None) -> list[CellData]:
    """Rebuild the analysis view from a persisted sweep (default: the last
    sweep declared in the store). Only *completed* cells — those with a
    ``sweep-cell`` marker — are included, so analyzing a killed sweep
    never mixes half-measured cells into the effect estimates. The store
    file is parsed once (one snapshot), not once per cell."""
    from ..core.design import analyze_records

    snap = store.snapshot()
    if sweep_id is None:
        if not snap.sweeps:
            raise KeyError(f"no sweep in {store.path}")
        sweep_id = snap.sweeps[-1]
    if sweep_id not in snap.manifests:
        raise KeyError(f"no sweep {sweep_id!r} in {store.path}")
    manifest = snap.manifests[sweep_id]
    done = snap.sweep_cells_by_id.get(sweep_id, {})
    out = []
    for index, fp, levels in manifest["cells"]:
        if int(index) not in done:
            continue
        table = analyze_records(snap.records.get(fp, []))
        meds = {case.key(): table.medians(case) for case in table.cases()}
        out.append(CellData(index=int(index), levels=dict(levels),
                            medians=meds))
    return out


@dataclass
class PairEffect:
    """One level pair of one axis: the one-sided Wilcoxon question
    "is `slower` really slower than `faster`?" plus the effect size."""

    slower: str
    faster: str
    p_wilcoxon: float              # one-sided, direction chosen by medians
    p_holm: float                  # Holm-adjusted within the axis' pairs
    delta: float                   # Cliff's delta of slower vs faster

    @property
    def stars(self) -> str:
        return significance_stars(self.p_holm)


@dataclass
class AxisEffect:
    """Main effect of one factor axis."""

    axis: str
    levels: tuple[str, ...]        # ordered slowest -> fastest
    level_medians: dict[str, float]   # normalized group medians
    h_stat: float
    p_kw: float                    # raw Kruskal-Wallis p
    p_holm: float = 1.0            # Holm-adjusted across the axis family
    pairs: list[PairEffect] = field(default_factory=list)
    effect_size: float = 0.0       # max |Cliff's delta| over level pairs
    n_obs: int = 0
    alpha: float = 0.05

    @property
    def significant(self) -> bool:
        return self.p_holm <= self.alpha

    @property
    def verdict(self) -> str:
        return "MATTERS" if self.significant else "-"

    def ordering(self) -> str:
        return " > ".join(self.levels)


@dataclass
class InteractionEffect:
    """One axis pair of the interaction screen: how much axis_a's
    conditional effect moves across axis_b's levels."""

    axis_a: str
    axis_b: str
    score: float                   # spread of conditional Cliff's deltas
    detail: str = ""


def _normalized_pools(cells: list[CellData]) -> list[tuple[CellData, np.ndarray]]:
    """Each cell's observations pooled across cases on the dimensionless
    per-case-normalized scale."""
    if not cells:
        raise ValueError("no cells to analyze")
    keys = sorted({k for c in cells for k in c.medians})
    grand: dict[tuple, float] = {}
    for k in keys:
        allv = np.concatenate([c.medians[k] for c in cells if k in c.medians
                               and c.medians[k].size])
        if allv.size == 0:
            continue
        grand[k] = float(np.median(allv)) or 1.0
    out = []
    for c in cells:
        parts = [c.medians[k] / grand[k] for k in keys
                 if k in c.medians and k in grand and c.medians[k].size]
        if not parts:
            raise ValueError(f"cell {c.index} ({c.levels}) has no "
                             "observations to analyze")
        out.append((c, np.concatenate(parts)))
    return out


def _axis_names(cells: list[CellData]) -> list[str]:
    names = list(cells[0].levels)
    for c in cells:
        if list(c.levels) != names:
            raise ValueError(f"cells disagree on the axis set: {names} vs "
                             f"{list(c.levels)}")
    return names


def _aligned_level_pools(pools, axis: str) -> dict[str, np.ndarray]:
    """Per-level pools *aligned on the complementary strata*: every
    observation is centered on the median of its stratum (the cells that
    share its levels on all other axes), so variance contributed by the
    other factors cancels out of this axis' contrast. Observations end up
    in units of "fraction of typical run-time, relative to the stratum"."""
    strata: dict[tuple, list[tuple[str, np.ndarray]]] = {}
    order: list[str] = []
    for c, x in pools:
        lab = c.levels[axis]
        if lab not in order:
            order.append(lab)
        key = tuple((k, v) for k, v in c.levels.items() if k != axis)
        strata.setdefault(key, []).append((lab, x))
    grouped: dict[str, list[np.ndarray]] = {lab: [] for lab in order}
    for entries in strata.values():
        center = float(np.median(np.concatenate([x for _, x in entries])))
        for lab, x in entries:
            grouped[lab].append(x - center)
    return {lab: np.concatenate(v) for lab, v in grouped.items() if v}


def _axis_effect(pools, axis: str, alpha: float) -> AxisEffect:
    """The raw (un-Holm'd) main effect of one axis on aligned pools —
    shared by the one-shot report (:func:`main_effects`) and the
    sequential looks (:func:`axis_decisions`), so a budgeted sweep's
    verdicts come from exactly the statistic the final table prints."""
    by_level = _aligned_level_pools(pools, axis)
    labels = list(by_level)
    if len(labels) < 2:
        # fractional sampling can starve an axis down to one level;
        # skipping it silently would misreport the swept space
        raise ValueError(f"axis {axis!r} has a single level in the "
                         "analyzed cells — grid fraction too small")
    h, p_kw = kruskal_wallis([by_level[lab] for lab in labels])
    medians = {lab: float(np.median(by_level[lab])) for lab in labels}
    pairs: list[PairEffect] = []
    for i in range(len(labels)):
        for j in range(i + 1, len(labels)):
            a, b = labels[i], labels[j]
            slower, faster = (a, b) if medians[a] >= medians[b] else (b, a)
            res = wilcoxon_rank_sum(by_level[slower], by_level[faster],
                                    alternative="greater")
            pairs.append(PairEffect(
                slower=slower, faster=faster, p_wilcoxon=res.p_value,
                p_holm=1.0,
                delta=cliffs_delta(by_level[slower], by_level[faster])))
    for pair, adj in zip(pairs, holm_bonferroni(
            [p.p_wilcoxon for p in pairs])):
        pair.p_holm = float(adj)
    return AxisEffect(
        axis=axis,
        levels=tuple(sorted(labels, key=lambda L: -medians[L])),
        level_medians=medians, h_stat=h, p_kw=p_kw, pairs=pairs,
        effect_size=max(abs(p.delta) for p in pairs),
        n_obs=sum(v.size for v in by_level.values()), alpha=alpha)


def main_effects(cells: list[CellData], alpha: float = 0.05) -> list[AxisEffect]:
    """Per-axis main effects on aligned observations, ranked
    most-impactful first.

    Ranking key: Holm-significant axes before non-significant ones, then
    descending |Cliff's delta|. The returned list is exactly the row order
    of :func:`format_factor_report`.
    """
    pools = _normalized_pools(cells)
    effects = [_axis_effect(pools, axis, alpha) for axis in _axis_names(cells)]
    for eff, adj in zip(effects, holm_bonferroni([e.p_kw for e in effects])):
        eff.p_holm = float(adj)
    effects.sort(key=lambda e: (not e.significant, -e.effect_size))
    return effects


@dataclass(frozen=True)
class AxisDecision:
    """The sequential verdict on one axis at one *look* of a budgeted
    sweep: ``MATTERS`` (Holm-corrected effect confirmed at this look's
    spent alpha), ``null`` (enough data, effect too small to chase), or
    ``undecided`` (keep allocating budget to this axis)."""

    axis: str
    verdict: str                   # "MATTERS" | "null" | "undecided"
    p_holm: float                  # Holm-adjusted within the tested family
    effect_size: float             # max |Cliff's delta| over level pairs
    n_obs: int
    look: int
    alpha_spent: float             # the threshold this look tested against
    forced: bool = False           # retired by a halving rule, not the test

    @property
    def resolved(self) -> bool:
        return self.verdict != "undecided"


def alpha_spending(alpha: float, look: int) -> float:
    """Geometric alpha-spending schedule: look *k* (0-based) may spend
    ``alpha * 2**-(k+1)``. The spends sum to at most ``alpha`` over any
    number of looks, so peeking at the data every round — the whole point
    of a racing sweep — cannot inflate the family-wise false-MATTERS
    rate above the one-shot analysis' bound. The price is conservatism,
    paid mostly at early looks where the savings are largest anyway."""
    return alpha * 0.5 ** (look + 1)


def axis_decisions(cells: list[CellData], axes: list[str] | None = None,
                   alpha: float = 0.05, look: int = 0,
                   n_min_null: int = 24,
                   delta_null: float = 0.3) -> dict[str, AxisDecision]:
    """Anytime-valid early-stop check: test the (still-undecided) axis
    family on the data available now, spending :func:`alpha_spending`
    of the alpha budget at this look.

      * ``MATTERS`` — the axis' Holm-adjusted Kruskal-Wallis p (adjusted
        within the *tested* family, i.e. the axes passed in) clears the
        spent alpha. Valid at any look; the spending schedule keeps the
        overall false-MATTERS rate <= alpha.
      * ``null`` — a futility rule, not a significance test: at least
        ``n_min_null`` aligned observations and a maximal |Cliff's
        delta| below ``delta_null`` means the effect, if any, is too
        small to change the factor ranking — stop spending budget on it.
      * ``undecided`` — neither; the axis keeps its budget.

    Decisions are a pure function of ``(cells, axes, parameters)`` — no
    RNG, no clock — which is what lets a killed sweep replay them from
    the store and land on the identical allocation sequence.
    """
    pools = _normalized_pools(cells)
    names = _axis_names(cells)
    if axes is not None:
        missing = sorted(set(axes) - set(names))
        if missing:
            raise ValueError(f"axes {missing} not present in the cells "
                             f"(have {names})")
        names = [n for n in names if n in set(axes)]
    a_k = alpha_spending(alpha, look)
    effects = [_axis_effect(pools, axis, alpha) for axis in names]
    adjusted = holm_bonferroni([e.p_kw for e in effects])
    out: dict[str, AxisDecision] = {}
    for eff, p_holm in zip(effects, adjusted):
        p_holm = float(p_holm)
        if p_holm <= a_k:
            verdict = "MATTERS"
        elif eff.n_obs >= n_min_null and eff.effect_size < delta_null:
            verdict = "null"
        else:
            verdict = "undecided"
        out[eff.axis] = AxisDecision(
            axis=eff.axis, verdict=verdict, p_holm=p_holm,
            effect_size=eff.effect_size, n_obs=eff.n_obs, look=look,
            alpha_spent=a_k)
    return out


def interaction_screen(cells: list[CellData]) -> list[InteractionEffect]:
    """Rank axis pairs by how non-additive their joint effect looks.

    For each ordered level pair of axis A, Cliff's delta is computed
    *within* each level of axis B; the pair's score is the largest spread
    of those conditional deltas (0 = perfectly additive on the ordinal
    scale). Pairs of levels that never co-occur (fractional grids) are
    skipped.
    """
    pools = _normalized_pools(cells)
    axes = _axis_names(cells)
    out: list[InteractionEffect] = []
    for ai in range(len(axes)):
        for aj in range(ai + 1, len(axes)):
            a, b = axes[ai], axes[aj]
            a_levels = list(dict.fromkeys(c.levels[a] for c, _ in pools))
            b_levels = list(dict.fromkeys(c.levels[b] for c, _ in pools))
            score, detail = 0.0, ""
            for x in range(len(a_levels)):
                for y in range(x + 1, len(a_levels)):
                    la, lb = a_levels[x], a_levels[y]
                    deltas = {}
                    for cond in b_levels:
                        pa = [v for c, v in pools
                              if c.levels[a] == la and c.levels[b] == cond]
                        pb = [v for c, v in pools
                              if c.levels[a] == lb and c.levels[b] == cond]
                        if pa and pb:
                            deltas[cond] = cliffs_delta(
                                np.concatenate(pa), np.concatenate(pb))
                    if len(deltas) < 2:
                        continue
                    spread = max(deltas.values()) - min(deltas.values())
                    if spread > score:
                        score = spread
                        detail = (f"delta({la} vs {lb}) spans "
                                  f"{min(deltas.values()):+.2f}.."
                                  f"{max(deltas.values()):+.2f} across {b}")
            out.append(InteractionEffect(axis_a=a, axis_b=b, score=score,
                                         detail=detail))
    out.sort(key=lambda e: -e.score)
    return out


def format_factor_report(effects: list[AxisEffect],
                         interactions: list[InteractionEffect] | None = None,
                         title: str = "factor impact") -> str:
    """The paper's "factors that matter" table from sweep data."""
    lines = [f"# {title} (Kruskal-Wallis + Holm on aligned normalized "
             "per-epoch medians; ranked by |Cliff's delta|)"]
    lines.append(
        f"{'factor':<16} {'levels (slow > fast)':<28} {'H':>8} {'p(KW)':>9} "
        f"{'p(holm)':>9} {'sig':>4} {'|delta|':>8} {'n':>6} {'verdict':>8}")
    for e in effects:
        stars = significance_stars(e.p_holm)
        lines.append(
            f"{e.axis:<16} {e.ordering():<28} {e.h_stat:>8.2f} "
            f"{e.p_kw:>9.2e} {e.p_holm:>9.2e} {stars:>4} "
            f"{e.effect_size:>8.3f} {e.n_obs:>6} {e.verdict:>8}")
    n_sig = sum(e.significant for e in effects)
    lines.append(f"# {n_sig}/{len(effects)} factors matter at family-wise "
                 f"alpha={effects[0].alpha if effects else 0.05}")
    if interactions:
        lines.append("# interaction screen (spread of conditional deltas; "
                     "ranking only, no p-values)")
        for it in interactions:
            if not it.detail:
                continue
            lines.append(f"  {it.axis_a} x {it.axis_b:<16} "
                         f"score={it.score:.2f}  {it.detail}")
    return "\n".join(lines)
