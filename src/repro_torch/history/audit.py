"""The reproducibility verdict engine: TOST equivalence across runs.

``compare_tables`` answers "are these two runs *different*?" — but the
paper's headline property is the opposite claim, and absence of a
significant difference is not evidence of sameness (it gets *easier* to
"pass" by measuring less). The audit therefore inverts the burden of
proof per (op, msize) cell, on the distributions of per-epoch medians:

  * **TOST equivalence** (:func:`~repro_torch.core.stats.tost_wilcoxon`): the
    null is non-equivalence; rejecting it certifies the candidate within
    ``±margin`` of the reference on the ratio scale — ``EQUIVALENT``;
  * **difference test** (two-sided Wilcoxon): rejecting *its* null without
    equivalence evidence is positive evidence of drift — ``DRIFTED``;
  * neither rejected: the data cannot decide — ``INCONCLUSIVE`` (small
    samples land here instead of silently "passing").

Both p-value families carry Holm step-down correction across the cell
family, so the *report's* false-``EQUIVALENT`` and false-``DRIFTED``
rates are each bounded by ``alpha`` (the soundness test tier pins the
empirical rates). Each cell also gets a percentile-bootstrap CI on the
median ratio — the effect-size the verdict is about, readable even when
the verdict is INCONCLUSIVE.

:func:`audit_runs` is the archive-level entry point: it resolves the
baseline through the :class:`~repro_torch.history.RunArchive` manifest, logs
every computed cell to an append-only ``audits.jsonl``, and *resumes* a
killed audit — already-logged cells are loaded, only missing cells are
recomputed, and the family-wise correction is re-applied over the
complete family at report time.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

import numpy as np

from ..core.design import ResultTable
from ..core.stats import (bootstrap_ci, holm_bonferroni, tost_wilcoxon,
                          wilcoxon_rank_sum)

from .archive import RunArchive, RunEntry

__all__ = ["CellVerdict", "AuditReport", "audit_tables", "audit_runs",
           "DEFAULT_MARGIN"]

#: Default relative equivalence margin: a re-run within ±10% of the
#: reference median is "the same experiment" for drift-gating purposes.
DEFAULT_MARGIN = 0.10

EQUIVALENT = "EQUIVALENT"
DRIFTED = "DRIFTED"
INCONCLUSIVE = "INCONCLUSIVE"


@dataclass(frozen=True)
class CellVerdict:
    """One audited (op, msize) cell: candidate vs reference."""

    op: str
    msize: int
    ref_us: float              # mean of per-epoch medians, reference [us]
    cand_us: float             # …candidate [us]
    ratio: float               # median(cand medians) / median(ref medians)
    ci_lo: float               # bootstrap percentile CI on that ratio
    ci_hi: float
    p_tost: float              # raw TOST equivalence p (margin-relative)
    p_tost_holm: float         # Holm-adjusted over the cell family
    p_diff: float              # raw two-sided difference p
    p_diff_holm: float
    n_ref: int                 # launch epochs per side
    n_cand: int
    margin: float
    alpha: float

    @property
    def equivalent(self) -> bool:
        return self.p_tost_holm <= self.alpha

    @property
    def drifted(self) -> bool:
        """Positive evidence of drift: the difference test rejects and
        equivalence was not demonstrated. When both reject (a tiny but
        real difference inside the margin), the margin wins by design —
        that is what "practically equivalent" means."""
        return not self.equivalent and self.p_diff_holm <= self.alpha

    @property
    def verdict(self) -> str:
        if self.equivalent:
            return EQUIVALENT
        if self.drifted:
            return DRIFTED
        return INCONCLUSIVE


@dataclass
class AuditReport:
    """Everything a drift gate needs from one candidate-vs-baseline audit."""

    cells: list[CellVerdict]
    margin: float
    alpha: float
    statistic: str = "median"
    candidate: RunEntry | None = None
    baseline: RunEntry | None = None
    factor_diffs: dict = field(default_factory=dict)
    n_computed: int = 0            # cells computed this run
    n_resumed: int = 0             # cells loaded from the audit log
    audit_id: str | None = None

    def drifted(self) -> list[CellVerdict]:
        return [c for c in self.cells if c.verdict == DRIFTED]

    def inconclusive(self) -> list[CellVerdict]:
        return [c for c in self.cells if c.verdict == INCONCLUSIVE]

    @property
    def ok(self) -> bool:
        """No cell with positive drift evidence (the gate's criterion —
        INCONCLUSIVE does not fail a gate, but is visibly reported)."""
        return not self.drifted()

    @property
    def all_equivalent(self) -> bool:
        return all(c.verdict == EQUIVALENT for c in self.cells)


def _cell_seed(seed: int, op: str, msize: int) -> int:
    """Deterministic per-cell bootstrap seed, stable across resume order."""
    h = hashlib.sha256(f"{seed}:{op}:{msize}".encode()).hexdigest()
    return int(h[:8], 16)


def _audit_cell(ref: np.ndarray, cand: np.ndarray, margin: float,
                n_boot: int, seed: int) -> dict:
    """Raw per-cell statistics (no family correction, no verdict) — the
    unit of audit work, logged one line per cell so a killed audit
    resumes at cell granularity."""
    tost = tost_wilcoxon(cand, ref, margin)
    diff = wilcoxon_rank_sum(cand, ref, "two-sided")
    ci_lo, ci_hi = bootstrap_ci(
        lambda c, r: float(np.median(c) / np.median(r)), (cand, ref),
        n_boot=n_boot, seed=seed)
    return dict(
        ref_us=float(np.mean(ref) * 1e6),
        cand_us=float(np.mean(cand) * 1e6),
        ratio=float(np.median(cand) / np.median(ref)),
        ci_lo=ci_lo, ci_hi=ci_hi,
        p_tost=tost.p_value, p_diff=diff.p_value,
        n_ref=int(ref.size), n_cand=int(cand.size),
    )


def _verdicts(raw: dict, margin: float, alpha: float) -> list[CellVerdict]:
    """Family-wise correction + verdict assembly over the *complete* cell
    family — re-run in full after a resume, so cached raw p-values feed
    the same Holm adjustment an uninterrupted audit would apply."""
    keys = sorted(raw)
    tost_holm = holm_bonferroni([raw[k]["p_tost"] for k in keys])
    diff_holm = holm_bonferroni([raw[k]["p_diff"] for k in keys])
    return [
        CellVerdict(op=op, msize=msize, margin=margin, alpha=alpha,
                    p_tost_holm=float(pt), p_diff_holm=float(pd),
                    **raw[(op, msize)])
        for (op, msize), pt, pd in zip(keys, tost_holm, diff_holm)
    ]


def _cell_samples(table: ResultTable, statistic: str):
    get = table.medians if statistic == "median" else table.means
    return {c.key(): get(c) for c in table.cases()}


def _common_cells(reference, candidate, statistic: str, what: str):
    """``(ref_cells, cand_cells, common keys)`` of two tables (or stores —
    anything with ``to_table``); raises when the runs share no populated
    (op, msize) cell, because an empty audit would read as a clean one."""
    if hasattr(reference, "to_table"):
        reference = reference.to_table()
    if hasattr(candidate, "to_table"):
        candidate = candidate.to_table()
    ref_cells = _cell_samples(reference, statistic)
    cand_cells = _cell_samples(candidate, statistic)
    common = sorted(k for k in ref_cells
                    if k in cand_cells
                    and ref_cells[k].size and cand_cells[k].size)
    if not common:
        raise ValueError(
            f"{what}: no common (op, msize) cells with data on both sides "
            f"— reference has {sorted(ref_cells) or 'no cases'}, candidate "
            f"has {sorted(cand_cells) or 'no cases'}. Check that the right "
            "runs were paired.")
    return ref_cells, cand_cells, common


def audit_tables(reference, candidate, margin: float = DEFAULT_MARGIN,
                 alpha: float = 0.05, statistic: str = "median",
                 n_boot: int = 1000, seed: int = 0) -> AuditReport:
    """Audit two result tables (or stores — anything with ``to_table``)
    in memory: the non-persistent core of :func:`audit_runs`, and the
    engine the soundness meta-tests drive directly."""
    ref_cells, cand_cells, common = _common_cells(reference, candidate,
                                                  statistic, "audit_tables")
    raw = {
        (op, msize): _audit_cell(ref_cells[(op, msize)],
                                 cand_cells[(op, msize)], margin, n_boot,
                                 _cell_seed(seed, op, msize))
        for op, msize in common
    }
    return AuditReport(cells=_verdicts(raw, margin, alpha), margin=margin,
                       alpha=alpha, statistic=statistic,
                       n_computed=len(common))


_CELL_FIELDS = ("ref_us", "cand_us", "ratio", "ci_lo", "ci_hi",
                "p_tost", "p_diff", "n_ref", "n_cand")


def _diff_factors(a: dict, b: dict) -> dict:
    """Factor-dict differences, with the ``extra`` key-value tuple diffed
    per entry so the report names ``extra.per_op_kw`` instead of dumping
    two whole tuples. ``host`` is not a factor (§5.9) and is skipped."""
    def pairs(v):
        return {p[0]: p[1] for p in (v or ())
                if isinstance(p, (list, tuple)) and len(p) == 2}

    out: dict = {}
    for k in set(a) | set(b):
        if k == "host" or a.get(k) == b.get(k):
            continue
        if k == "extra":
            da, db = pairs(a.get(k)), pairs(b.get(k))
            for ek in set(da) | set(db):
                if da.get(ek) != db.get(ek):
                    out[f"extra.{ek}"] = (da.get(ek), db.get(ek))
        else:
            out[k] = (a.get(k), b.get(k))
    return out


def audit_runs(archive: RunArchive, candidate, baseline=None,
               baseline_tag: str | None = None,
               margin: float = DEFAULT_MARGIN, alpha: float = 0.05,
               statistic: str = "median", n_boot: int = 1000,
               seed: int = 0, log: bool = True) -> AuditReport:
    """Audit an archived candidate run against its baseline, resumably.

    ``candidate``/``baseline`` are :class:`RunEntry`\\ s or run ids;
    ``baseline=None`` resolves through
    :meth:`~repro_torch.history.RunArchive.baseline_for` (optionally pinned by
    ``baseline_tag``). Raises when no baseline exists — the caller decides
    whether "first run ever" is fine.

    With ``log`` (default), every computed cell is appended to the
    archive's ``audits.jsonl`` keyed by a deterministic audit id (runs +
    parameters), so a killed audit re-reads its finished cells and
    recomputes only the missing ones; Holm correction is always re-applied
    over the complete family.
    """
    if isinstance(candidate, str):
        candidate = archive.entry(candidate)
    if isinstance(baseline, str):
        baseline = archive.entry(baseline)
    if baseline is None:
        baseline = archive.baseline_for(candidate, tag=baseline_tag)
        if baseline is None:
            raise LookupError(
                f"audit_runs: no baseline in {archive.manifest_path} for "
                f"candidate {candidate.run_id} — register a reference run "
                "first")

    audit_id = hashlib.sha256(json.dumps(
        [baseline.run_id, candidate.run_id, margin, alpha, statistic,
         n_boot, seed], sort_keys=True).encode()).hexdigest()[:16]

    factor_diffs = _diff_factors(baseline.factors, candidate.factors)

    ref_cells, cand_cells, common = _common_cells(
        archive.open_store(baseline), archive.open_store(candidate),
        statistic,
        f"audit_runs [{baseline.run_id} vs {candidate.run_id}]")

    log_path = archive.root / "audits.jsonl"
    raw: dict[tuple[str, int], dict] = {}
    if log and log_path.exists():
        with open(log_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    o = json.loads(line)
                except json.JSONDecodeError:    # torn tail: cell recomputes
                    continue
                if o.get("kind") == "audit-cell" and o.get("audit") == audit_id:
                    key = (o["op"], int(o["msize"]))
                    raw[key] = {k: o[k] for k in _CELL_FIELDS}
    raw = {k: v for k, v in raw.items() if k in common}
    n_resumed = len(raw)

    n_computed = 0
    for op, msize in common:
        if (op, msize) in raw:
            continue
        cell = _audit_cell(ref_cells[(op, msize)], cand_cells[(op, msize)],
                           margin, n_boot, _cell_seed(seed, op, msize))
        raw[(op, msize)] = cell
        n_computed += 1
        if log:
            archive.root.mkdir(parents=True, exist_ok=True)
            with open(log_path, "a") as f:
                f.write(json.dumps(dict(kind="audit-cell", audit=audit_id,
                                        op=op, msize=int(msize), **cell),
                                   sort_keys=True) + "\n")
                f.flush()

    return AuditReport(cells=_verdicts(raw, margin, alpha), margin=margin,
                       alpha=alpha, statistic=statistic,
                       candidate=candidate, baseline=baseline,
                       factor_diffs=factor_diffs, n_computed=n_computed,
                       n_resumed=n_resumed, audit_id=audit_id)
