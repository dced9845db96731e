"""Reproducible experimental design and analysis (§6.1, Algorithms 5-6).

Copied from the JAX package's ``repro.core.design`` (numpy only). The
paper's central methodological result: *the launcher invocation is an
experimental factor* (§5.2). A sound benchmark therefore

  1. runs ``n`` independent **launch epochs** — replication over the
     blocking factor,
  2. measures ``nrep`` observations per (function, message size) inside
     each epoch,
  3. **randomizes** the order of test cases within an epoch (Alg. 5 line 9),
  4. removes outliers per group with Tukey's filter (Alg. 6 line 5),
  5. summarizes each epoch by its mean *and* median, producing a
     *distribution of averages* over epochs for the hypothesis test.

Epochs run serially here; fan-out over worker processes is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

import numpy as np

from .stats import relative_ci_width, tukey_filter

__all__ = [
    "TestCase",
    "ExperimentDesign",
    "MeasurementRecord",
    "EpochSummary",
    "ResultTable",
    "case_orders",
    "measure_case",
    "measure_adaptive",
    "analyze_records",
    "NREP_SPENT",
]


class _NrepCounter:
    """Process-global measurement-cost meter: every repetition measured
    through :func:`measure_case` is counted, whatever layer asked for it.
    Wall-clock seconds depend on the machine; *repetitions spent* is the
    machine-independent cost a budgeted sweep actually saves — the
    benchmark harness snapshots this around each bench to report
    ``nrep_total`` next to seconds."""

    __slots__ = ("total",)

    def __init__(self) -> None:
        self.total = 0

    def add(self, n: int) -> None:
        self.total += int(n)

    def read(self) -> int:
        return self.total


#: The process-wide repetition counter (see :class:`_NrepCounter`).
NREP_SPENT = _NrepCounter()


@dataclass(frozen=True)
class TestCase:
    """One benchmark cell: an operation at a message size (Alg. 5's
    ``(func, msize)``; the process count is fixed per campaign)."""

    __test__ = False  # tell pytest this is not a test class

    op: str
    msize: int

    def key(self) -> tuple[str, int]:
        return (self.op, self.msize)


@dataclass
class ExperimentDesign:
    """Parameters of Algorithm 5, plus the adaptive-``nrep`` stopping rule.

    ``nrep`` is the *fixed* per-case sample size. Setting ``nrep_max``
    switches the design to sequential stopping (§3.4: "repeat until the
    result is stable"): each case starts with ``nrep_min`` observations and
    grows its sample until the relative CI half-width of the Tukey-filtered
    mean falls to ``rel_ci_target``, or ``nrep_max`` observations have been
    taken — whichever comes first. The rule is backend-agnostic: it only
    calls ``measure`` again for another chunk, so every backend shares it.
    """

    n_launch_epochs: int = 30     # paper default: 30 mpiruns (§6)
    nrep: int = 100               # measurements per case per epoch (fixed mode)
    shuffle: bool = True          # randomization (Alg. 5 line 9)
    outlier_filter: bool = True   # Tukey per group (Alg. 6 line 5)
    seed: int = 0
    # --- adaptive stopping (active iff nrep_max is not None) ---
    nrep_min: int = 10            # initial chunk / smallest defensible sample
    nrep_max: int | None = None   # hard cap; None = fixed-nrep mode
    rel_ci_target: float = 0.05   # stop when rel. CI half-width <= this
    ci_level: float = 0.95

    @property
    def adaptive(self) -> bool:
        return self.nrep_max is not None


@dataclass
class MeasurementRecord:
    case: TestCase
    epoch: int
    times: np.ndarray             # raw run-times [s]
    invalid_fraction: float = 0.0
    meta: dict = field(default_factory=dict)


@dataclass
class EpochSummary:
    """Per-epoch averages after outlier removal (one row of Alg. 6's v).

    ``host`` is where the epoch was *measured* (carried through record
    meta) — not a factor, but the audit trail a merged multi-host store
    needs to stay attributable."""

    case: TestCase
    epoch: int
    mean: float
    median: float
    n_kept: int
    n_raw: int
    host: str = ""


@dataclass
class ResultTable:
    """Distribution of per-epoch averages for every test case.

    Lookups by case go through a grouped index built once per table state
    (and rebuilt only if ``summaries`` grows), so repeated
    :meth:`means`/:meth:`medians` calls stay O(group) instead of rescanning
    every summary — this matters once campaigns reach hundreds of cells.
    """

    summaries: list[EpochSummary]
    _index: dict = field(default=None, init=False, repr=False, compare=False)
    _indexed_len: int = field(default=-1, init=False, repr=False, compare=False)

    def _grouped(self) -> dict:
        if self._index is None or self._indexed_len != len(self.summaries):
            groups: dict[tuple, list[EpochSummary]] = {}
            for s in self.summaries:
                groups.setdefault(s.case.key(), []).append(s)
            self._index = {
                k: (v[0].case,
                    np.array([s.mean for s in v]),
                    np.array([s.median for s in v]))
                for k, v in groups.items()
            }
            self._indexed_len = len(self.summaries)
        return self._index

    def cases(self) -> list[TestCase]:
        idx = self._grouped()
        return [idx[k][0] for k in sorted(idx)]

    def medians(self, case: TestCase) -> np.ndarray:
        entry = self._grouped().get(case.key())
        return entry[2].copy() if entry else np.empty(0)

    def means(self, case: TestCase) -> np.ndarray:
        entry = self._grouped().get(case.key())
        return entry[1].copy() if entry else np.empty(0)

    def to_rows(self) -> list[dict]:
        return [
            dict(op=s.case.op, msize=s.case.msize, epoch=s.epoch,
                 mean=s.mean, median=s.median, n_kept=s.n_kept,
                 n_raw=s.n_raw, host=s.host)
            for s in self.summaries
        ]


def measure_adaptive(
    measure: Callable[[Any, TestCase, int], np.ndarray],
    ctx: Any,
    case: TestCase,
    design: ExperimentDesign,
    initial: np.ndarray | None = None,
) -> tuple[np.ndarray, dict]:
    """Sequential stopping for one case: sample in growing chunks until the
    relative CI half-width of the (Tukey-filtered) mean reaches
    ``design.rel_ci_target``, bounded by ``nrep_min``/``nrep_max``.

    ``initial`` injects an already-measured first chunk (a fused backend's
    batched ``nrep_min`` dispatch) so only the top-up chunks go through
    ``measure``; the stopping rule is unchanged.

    Returns ``(times, meta)`` where ``meta`` records ``nrep_used``,
    ``converged`` and the final ``rel_ci`` — the provenance every stored
    result needs to interpret its own sample size.
    """
    if initial is not None:
        times = np.asarray(initial, dtype=np.float64)
    else:
        times = np.asarray(measure(ctx, case, design.nrep_min),
                           dtype=np.float64)
    while True:
        kept = tukey_filter(times) if design.outlier_filter else times
        rel = relative_ci_width(kept if kept.size else times, design.ci_level)
        if rel <= design.rel_ci_target:
            return times, dict(nrep_used=int(times.size), converged=True,
                               rel_ci=float(rel))
        remaining = design.nrep_max - times.size
        if remaining <= 0:
            return times, dict(nrep_used=int(times.size), converged=False,
                               rel_ci=float(rel))
        # grow geometrically (~1.5x) so convergence checks stay O(log n)
        chunk = int(min(remaining, max(design.nrep_min, times.size // 2)))
        more = np.asarray(measure(ctx, case, chunk), dtype=np.float64)
        if more.size == 0:
            return times, dict(nrep_used=int(times.size), converged=False,
                               rel_ci=float(rel))
        times = np.concatenate([times, more])


def measure_case(
    measure: Callable[[Any, TestCase, int], np.ndarray],
    ctx: Any,
    case: TestCase,
    design: ExperimentDesign,
) -> tuple[np.ndarray, dict]:
    """Measure one case under the design's nrep policy (fixed or adaptive)."""
    if design.adaptive:
        times, meta = measure_adaptive(measure, ctx, case, design)
    else:
        times = np.asarray(measure(ctx, case, design.nrep), dtype=np.float64)
        meta = dict(nrep_used=int(times.size), converged=True)
    NREP_SPENT.add(times.size)
    return times, meta


def case_orders(design: ExperimentDesign,
                cases: Iterable[TestCase]) -> list[list[TestCase]]:
    """Per-epoch case orders, drawn up front from the design seed (Alg. 5
    line 9), so a resumed campaign replays the exact order of the original
    run."""
    cases = list(cases)
    rng = np.random.default_rng(design.seed)
    orders: list[list[TestCase]] = []
    for _ in range(design.n_launch_epochs):
        order = list(cases)
        if design.shuffle:
            perm = rng.permutation(len(order))
            order = [order[i] for i in perm]
        orders.append(order)
    return orders


def analyze_records(
    records: Iterable[MeasurementRecord],
    outlier_filter: bool = True,
) -> ResultTable:
    """Algorithm 6: per (case, epoch) Tukey-filter then mean & median."""
    summaries: list[EpochSummary] = []
    for rec in records:
        raw = rec.times
        kept = tukey_filter(raw) if outlier_filter else raw
        if kept.size == 0:
            kept = raw
        summaries.append(
            EpochSummary(
                case=rec.case,
                epoch=rec.epoch,
                mean=float(np.mean(kept)),
                median=float(np.median(kept)),
                n_kept=int(kept.size),
                n_raw=int(raw.size),
                host=str(rec.meta.get("host", "")),
            )
        )
    return ResultTable(summaries=summaries)
