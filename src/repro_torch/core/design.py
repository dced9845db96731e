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

Launch epochs are independent by construction (§5.2: each is its own
process instantiation), so :func:`run_design` can execute them across a
``ProcessPoolExecutor`` (``n_workers > 1``) of *spawned* workers: a worker
that measures on ``"cuda"`` opens its own context on the same card.
Per-epoch case orders are drawn up front from the design seed in the
exact serial order, so the parallel run reproduces the serial records
bit for bit as long as the factory/measure pair derives all randomness
from the epoch index (which the simulation backend does).
"""

from __future__ import annotations

import dataclasses
import warnings
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
    "run_design",
    "map_parallel",
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

    def replace(self, **overrides) -> "ExperimentDesign":
        """A copy with the given fields overridden."""
        return dataclasses.replace(self, **overrides)


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


def _measure_epoch(
    epoch_factory: Callable[[int], Any],
    measure: Callable[[Any, TestCase, int], np.ndarray],
    epoch: int,
    order: list[TestCase],
    design: ExperimentDesign,
) -> list[tuple[TestCase, np.ndarray, dict]]:
    """One launch epoch: build a fresh context and measure every case in
    the given (already shuffled) order. Module-level so it can cross a
    process boundary."""
    ctx = epoch_factory(epoch)
    return [
        (case, *measure_case(measure, ctx, case, design))
        for case in order
    ]


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


def _as_backend_pair(backend_or_factory, measure):
    """Accept either a :class:`~repro_torch.campaign.MeasurementBackend`
    (has ``make_epoch`` + ``measure``) or the **deprecated** legacy
    ``(epoch_factory, measure)`` pair; return the pair.

    The backend protocol is the single entry point: it carries factor
    capture, default cases and provenance that the bare pair cannot, so
    results measured through a pair are second-class citizens in every
    layer above (stores, sweeps, audits). Wrap a pair in
    :class:`~repro_torch.campaign.FunctionBackend` instead.
    """
    if measure is None:
        if not (hasattr(backend_or_factory, "make_epoch")
                and hasattr(backend_or_factory, "measure")):
            raise TypeError(
                "run_design: pass a MeasurementBackend, or an epoch_factory "
                "together with a measure callable")
        return backend_or_factory.make_epoch, backend_or_factory.measure
    warnings.warn(
        "run_design(epoch_factory, measure) is deprecated; wrap the pair "
        "in repro_torch.campaign.FunctionBackend (the MeasurementBackend "
        "protocol is the single entry point)",
        DeprecationWarning, stacklevel=3)
    return backend_or_factory, measure


def run_design(
    design: ExperimentDesign,
    backend: Any,
    measure: Callable[[Any, TestCase, int], np.ndarray] | None = None,
    cases: Iterable[TestCase] | None = None,
    n_workers: int = 1,
) -> list[MeasurementRecord]:
    """Algorithm 5: ``n`` launch epochs, each measuring all cases in a
    freshly shuffled order.

    ``backend`` is either a :class:`~repro_torch.campaign.MeasurementBackend`
    (``measure`` omitted; ``cases`` defaults to ``backend.default_cases()``)
    or, legacy form, an ``epoch_factory`` callable paired with an explicit
    ``measure``.

    With ``n_workers > 1`` the epochs — independent by the paper's own
    design — run across a ``ProcessPoolExecutor``. Records come back in
    the serial order (epoch-major, then shuffled case order) and are
    bit-identical to a serial run whenever the factory/measure pair is
    deterministic per epoch index. Falls back to the serial loop, with a
    warning, when the callables cannot be pickled or no pool can be
    spawned; a backend on ``"cuda"`` still measures on the card there.
    """
    if cases is None:
        if hasattr(backend, "default_cases"):
            cases = backend.default_cases()
        else:
            raise TypeError("run_design: cases is required unless the "
                            "backend provides default_cases()")
    epoch_factory, measure = _as_backend_pair(backend, measure)
    cases = list(cases)
    orders = case_orders(design, cases)

    per_epoch: list[list[tuple[TestCase, np.ndarray, dict]]] | None = None
    if n_workers and n_workers > 1 and design.n_launch_epochs > 1:
        per_epoch = _run_epochs_parallel(
            design, epoch_factory, measure, orders, n_workers)
    if per_epoch is None:
        per_epoch = [
            _measure_epoch(epoch_factory, measure, epoch, orders[epoch],
                           design)
            for epoch in range(design.n_launch_epochs)
        ]

    records: list[MeasurementRecord] = []
    for epoch, results in enumerate(per_epoch):
        for case, times, meta in results:
            records.append(MeasurementRecord(case=case, epoch=epoch,
                                             times=times, meta=meta))
    return records


def map_parallel(
    fn: Callable,
    argtuples: list[tuple],
    n_workers: int,
    what: str = "tasks",
    on_result: Callable[[int, Any], None] | None = None,
    timeout: float | None = None,
    max_restarts: int = 1,
    retry: Any | None = None,
) -> list | None:
    """Run ``fn(*args)`` for every argtuple across a ``ProcessPoolExecutor``.

    The fan-out machinery of :func:`run_design` (launch epochs). Workers
    are *spawned*, never forked: a forked child cannot use a CUDA context
    its parent opened, while a spawned one opens its own. Results come
    back in submission order; ``on_result(index, result)`` fires in the
    *parent* as each task completes (completion order).

    Failure semantics distinguish *setup* from *execution*:

    * **Setup failure** — unpicklable callables/args, or the first pool
      refusing to spawn — returns ``None`` so the caller falls back to its
      serial loop: nothing has run yet, serial is a faithful substitute.
    * **Worker crash mid-run** (``BrokenProcessPool``) restarts the pool
      and resubmits only the unfinished tasks, backing off between
      restarts (``retry``, a :class:`~.retry.RetryPolicy`;
      default two quick jittered restarts). The warning names exactly
      which task indices were in flight. After ``max_restarts`` the
      exception is **re-raised** — a pool that keeps dying is a fault the
      caller must see, not silently absorb into a serial run whose
      completion would misattribute the crash to nothing.
    * **Stall** — no task completing within ``timeout`` seconds — raises
      ``TimeoutError`` naming the in-flight tasks after terminating the
      pool's workers: a hung worker must not wedge the campaign forever.
      ``None`` (default) waits indefinitely, the pre-existing behavior.
    """
    import concurrent.futures as cf
    import multiprocessing as mp
    import pickle

    from .retry import RetryPolicy

    if not argtuples:
        return []
    try:
        pickle.dumps((fn, argtuples))
    except Exception:
        warnings.warn(
            f"map_parallel: {what} not picklable; running serially",
            RuntimeWarning, stacklevel=3)
        return None
    mp_ctx = mp.get_context("spawn")
    if retry is None:
        retry = RetryPolicy(base=0.1, max_delay=1.0,
                            attempts=max_restarts + 1, seed=0)

    out: list = [None] * len(argtuples)
    done_idx: set[int] = set()
    restarts = 0
    while True:
        pending_idx = [i for i in range(len(argtuples)) if i not in done_idx]
        try:
            pool = cf.ProcessPoolExecutor(
                max_workers=min(n_workers, len(pending_idx)),
                mp_context=mp_ctx)
        except OSError as e:
            if restarts:        # a pool ran and died, and now none spawns:
                raise           # that is a fault, not a setup condition
            warnings.warn(
                f"map_parallel: no process pool available ({e!r}); running "
                f"{what} serially", RuntimeWarning, stacklevel=3)
            return None
        try:
            with pool:
                futures = {pool.submit(fn, *argtuples[i]): i
                           for i in pending_idx}
                not_done = set(futures)
                while not_done:
                    done, not_done = cf.wait(
                        not_done, timeout=timeout,
                        return_when=cf.FIRST_COMPLETED)
                    if not done:
                        in_flight = sorted(futures[f] for f in not_done)
                        # a hung worker would block pool.__exit__ forever;
                        # kill the workers so the TimeoutError actually
                        # returns control to the caller
                        for p in getattr(pool, "_processes", {}).values():
                            p.terminate()
                        pool.shutdown(wait=False, cancel_futures=True)
                        raise TimeoutError(
                            f"map_parallel: no {what} completed within "
                            f"{timeout}s; in flight: {in_flight}")
                    for fut in done:
                        i = futures[fut]
                        out[i] = fut.result()
                        done_idx.add(i)
                        if on_result is not None:
                            on_result(i, out[i])
            return out
        except cf.process.BrokenProcessPool as e:
            in_flight = sorted(i for i in pending_idx if i not in done_idx)
            if restarts >= max_restarts:
                raise cf.process.BrokenProcessPool(
                    f"map_parallel: pool died {restarts + 1}x running {what}; "
                    f"giving up with {len(in_flight)} tasks unfinished: "
                    f"{in_flight}") from e
            delay = retry.delay(restarts)
            warnings.warn(
                f"map_parallel: a worker process died ({e!r}); "
                f"{len(in_flight)}/{len(argtuples)} {what} in flight: "
                f"{in_flight}; restarting pool in {delay:.2f}s "
                f"({restarts + 1}/{max_restarts} restarts)",
                RuntimeWarning, stacklevel=3)
            import time as _time

            _time.sleep(delay)
            restarts += 1


def _run_epochs_parallel(design, epoch_factory, measure, orders, n_workers):
    """Fan the launch epochs out over processes; ``None`` on any setup
    failure so :func:`run_design` runs serially instead."""
    return map_parallel(
        _measure_epoch,
        [(epoch_factory, measure, epoch, orders[epoch], design)
         for epoch in range(design.n_launch_epochs)],
        n_workers, what="epoch_factory/measure")


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
