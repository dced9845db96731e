"""The sim↔real calibration loop: fit, then certify.

Cornebize & Legrand (arXiv:2102.07674) make the case that a simulator
predicts real MPI behavior only when its *variability* model is
calibrated against measurements — matching means is not enough. This
module is that loop, built entirely out of the package's own
experimental machinery:

  1. **measure** the target backend (any measurement backend; a
     simulated "truth" with other parameters and another seed in the
     tests and on the card) through an ordinary
     :class:`~repro_torch.campaign.Campaign` into a
     :class:`~repro_torch.campaign.ResultStore` — launch-epoch replication,
     adaptive nrep, store resume all inherited;
  2. **fit** a :class:`~repro_torch.calibrate.CalibrationSpace` of SimNet noise
     parameters by deterministic coordinate descent: every candidate is
     materialized as a :class:`~repro_torch.campaign.TorchSimBackend`, measured
     through its own (store-resumed, fingerprint-keyed) campaign over the
     *fit* launch epochs, and scored with the per-cell
     :func:`~repro_torch.sweeps.quantile_distance` between per-epoch-median
     distributions. The search is RNG-free, so a given (space, target,
     design, seed) always walks the same trajectory; each completed pass
     over the parameters persists a ``calib-round`` store line, and a
     killed fit replays those lines on resume — the ``sweep-alloc``
     pattern applied to search state;
  3. **certify** on *held-out* launch epochs the fit never saw:
     :func:`~repro_torch.history.audit_tables` (TOST ±margin, Holm-corrected)
     between the fitted simulator and the target, the same engine the
     drift gate uses. The store is registered into the
     :class:`~repro_torch.history.RunArchive` under the ``calibrated`` tag with
     the full fit report (fitted params, objective trace, per-cell
     verdicts) logged to the archive manifest.

A fit is only as trustworthy as its certification: ``CalibrationResult.ok``
is False exactly when a held-out cell shows positive drift evidence, and
a caller gates on that, and only that.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..campaign import Campaign, CampaignSpec, ResultStore
from ..core.design import (NREP_SPENT, ExperimentDesign,
                           MeasurementRecord, ResultTable, TestCase,
                           analyze_records)
from ..history import DEFAULT_MARGIN, AuditReport, audit_tables
from ..sweeps import DEFAULT_QUANTILES, quantile_distance

from .space import CalibrationSpace

__all__ = ["CalibrationResult", "calibrate", "certify_heldout",
           "CALIBRATED_TAG"]

#: Archive tag a certified calibration run is registered under.
CALIBRATED_TAG = "calibrated"

#: Objective improvements below this are noise, not progress.
_IMPROVE_EPS = 1e-12


@dataclass
class CalibrationResult:
    """Everything the calibration loop decided, measured and certified."""

    params: dict                     # fitted parameter vector
    objective: float                 # its fit-window objective
    rounds: list = field(default_factory=list)   # objective trace per round
    report: AuditReport | None = None            # held-out certification
    target_fingerprint: str | None = None
    fitted_fingerprint: str | None = None
    calib_id: str | None = None
    run_entry: object = None         # RunEntry when an archive was attached
    n_fit_epochs: int = 0
    n_heldout_epochs: int = 0
    spent_nrep: int = 0
    n_rounds_resumed: int = 0        # rounds replayed from calib-round lines

    @property
    def ok(self) -> bool:
        """The gate criterion: no held-out cell with positive drift
        evidence (INCONCLUSIVE cells report visibly but do not fail)."""
        return self.report is not None and self.report.ok

    @property
    def verdict(self) -> str:
        if self.report is None:
            return "UNCERTIFIED"
        if self.report.all_equivalent:
            return "EQUIVALENT"
        return "DRIFTED" if not self.report.ok else "INCONCLUSIVE"

    def report_dict(self) -> dict:
        """The fit report persisted to the archive manifest and the
        store's meta stamp: fitted params, objective trace, per-cell
        verdicts — the provenance a later reader needs to trust (or
        re-run) this calibration."""
        cells = []
        if self.report is not None:
            cells = [dict(op=c.op, msize=c.msize, verdict=c.verdict,
                          ratio=round(c.ratio, 6),
                          ci=[round(c.ci_lo, 6), round(c.ci_hi, 6)],
                          p_tost_holm=c.p_tost_holm,
                          p_diff_holm=c.p_diff_holm)
                     for c in self.report.cells]
        return dict(
            calib=self.calib_id, verdict=self.verdict,
            params={k: float(v) for k, v in self.params.items()},
            objective=float(self.objective),
            trace=[dict(round=r["round"], objective=r["objective"],
                        step=r["step"], n_evals=len(r.get("evals", ())))
                   for r in self.rounds],
            n_fit_epochs=self.n_fit_epochs,
            n_heldout_epochs=self.n_heldout_epochs,
            spent_nrep=int(self.spent_nrep),
            target_fingerprint=self.target_fingerprint,
            fitted_fingerprint=self.fitted_fingerprint,
            cells=cells,
        )


def _epoch_table(records: list[MeasurementRecord], lo: int, hi: int,
                 outlier_filter: bool) -> ResultTable:
    """Algorithm-6 reduction of the records inside epoch window
    ``[lo, hi)`` — how one full-design campaign yields separate fit and
    held-out views without re-measuring anything."""
    return analyze_records([r for r in records if lo <= r.epoch < hi],
                           outlier_filter)


def _objective(ref: ResultTable, cand: ResultTable, cases: list[TestCase],
               quantiles: tuple) -> float:
    """Sum of per-cell quantile distances between per-epoch-median
    distributions — the log-ratio scale makes cells of different
    magnitude commensurable (see :func:`~repro_torch.sweeps.quantile_distance`)."""
    total = 0.0
    for case in cases:
        r, c = ref.medians(case), cand.medians(case)
        if r.size == 0 or c.size == 0:
            raise ValueError(f"calibrate: no per-epoch medians for "
                             f"{case.key()} on one side — target and "
                             "candidate campaigns must share the case list")
        total += quantile_distance(r, c, quantiles)
    return total


def _merge_into_snapshot(snap, fingerprint: str, records) -> None:
    """Keep the one up-front snapshot coherent with what this process
    appended, so a later campaign on the *same* fingerprint (the fitted
    backend's full-epoch run after its fit-window evals) resumes instead
    of re-measuring — the same bookkeeping the sweep scheduler does."""
    if snap is None:
        return
    have = {(r.case.op, r.case.msize, r.epoch)
            for r in snap.records.get(fingerprint, [])}
    for r in records:
        key = (r.case.op, r.case.msize, r.epoch)
        if key not in have:
            snap.records.setdefault(fingerprint, []).append(r)
            have.add(key)


def certify_heldout(target_records, fitted_records, n_fit_epochs: int,
                    design: ExperimentDesign,
                    margin: float = DEFAULT_MARGIN, alpha: float = 0.05,
                    seed: int = 0) -> AuditReport:
    """TOST-certify a fitted simulator against the target on the held-out
    launch epochs only (``epoch >= n_fit_epochs``) — the fit never saw
    them, so equivalence here is out-of-sample evidence, not an echo of
    the objective. Exposed separately so a *frozen* candidate (the
    positive-control mis-fit in the soundness tests) can be certified
    without running a fit."""
    n = design.n_launch_epochs
    ref = _epoch_table(target_records, n_fit_epochs, n,
                       design.outlier_filter)
    cand = _epoch_table(fitted_records, n_fit_epochs, n,
                        design.outlier_filter)
    return audit_tables(ref, cand, margin=margin, alpha=alpha, seed=seed)


def calibrate(space: CalibrationSpace, target, cases=None,
              design: ExperimentDesign | None = None,
              store: ResultStore | None = None, archive=None,
              seed: int = 0, n_fit_epochs: int | None = None,
              budget: int | None = None, max_rounds: int = 8,
              step0: float = 0.25, step_tol: float = 0.02,
              margin: float = DEFAULT_MARGIN, alpha: float = 0.05,
              quantiles: tuple = DEFAULT_QUANTILES,
              name: str = "calib") -> CalibrationResult:
    """Fit ``space`` so the simulator reproduces ``target``, then certify.

    ``target`` is any :class:`~repro_torch.campaign.MeasurementBackend`; its
    campaign runs the full ``design``, of which the first
    ``n_fit_epochs`` launch epochs (default: two thirds) feed the
    objective and the rest are held out for certification. ``budget``
    caps total repetitions spent (a stop criterion, checked at round
    boundaries); ``max_rounds``/``step_tol`` bound the coordinate
    descent. All campaigns — target, every candidate, the fitted final —
    share ``store``, so a killed fit resumes: measurements at record
    granularity, search state by replaying ``calib-round`` lines.

    With ``archive``, the store is registered under
    :data:`CALIBRATED_TAG` and the fit report is logged to the archive
    manifest regardless of verdict — a DRIFTED calibration is a result
    to keep, not to hide; the caller gates on ``result.ok``.
    """
    if store is None:
        raise ValueError("calibrate: a store is required — candidate "
                         "campaigns and calib-round search state persist "
                         "there (pass store=)")
    design = design or ExperimentDesign(n_launch_epochs=18, nrep=30,
                                        seed=seed)
    cases = list(cases) if cases else list(target.default_cases())
    n = design.n_launch_epochs
    n_fit = n_fit_epochs if n_fit_epochs is not None else max(1, (2 * n) // 3)
    if not 1 <= n_fit <= n - 2:
        raise ValueError(
            f"calibrate: need 1 <= n_fit_epochs <= n_launch_epochs-2 "
            f"(got n_fit={n_fit}, n={n}) — certification needs at least "
            "two held-out epochs")
    if isinstance(getattr(target, "seed0", None), int) \
            and target.seed0 == space.base.seed0 \
            and type(target) is type(space.base):
        raise ValueError(
            "calibrate: target and candidate simulators share seed0 — the "
            "fit would match one noise realization instead of the "
            "distribution; give the target a different seed0")

    snap = store.snapshot()

    # -- 1. the target campaign (full design, all epochs) ------------------
    nrep_mark = NREP_SPENT.read()
    spent = 0
    target_spec = CampaignSpec(cases, design, name=f"{name}/target")
    target_res = Campaign(target_spec, target, store).run(snapshot=snap)
    _merge_into_snapshot(snap, target_res.fingerprint, target_res.records)
    ref_fit = _epoch_table(target_res.records, 0, n_fit,
                           design.outlier_filter)

    # -- 2. the fit --------------------------------------------------------
    manifest = dict(
        name=name, space=space.manifest(),
        target_fingerprint=target_res.fingerprint,
        cases=[[c.op, int(c.msize)] for c in cases],
        design=target_spec.meta(), n_fit_epochs=int(n_fit), seed=int(seed),
        objective="quantile_distance", quantiles=list(quantiles),
        max_rounds=int(max_rounds), step0=float(step0),
        step_tol=float(step_tol), budget=budget,
    )
    calib_id = store.append_calib(manifest, snapshot=snap)
    persisted = {int(r["round"]): r
                 for r in snap.calib_rounds_by_id.get(calib_id, [])}

    cache: dict[tuple, float] = {}

    def key_of(values: dict) -> tuple:
        return tuple((p.name, values[p.name]) for p in space.params)

    def evaluate(values: dict) -> float:
        k = key_of(values)
        if k in cache:
            return cache[k]
        backend = space.materialize(values)
        res = Campaign(CampaignSpec(cases, design, name=f"{name}/eval"),
                       backend, store).run(snapshot=snap,
                                           epochs=range(n_fit))
        _merge_into_snapshot(snap, res.fingerprint, res.records)
        obj = _objective(ref_fit, res.table, cases, quantiles)
        cache[k] = obj
        return obj

    x = space.start()
    best = evaluate(x)
    step = float(step0)
    rounds: list[dict] = []
    n_resumed = 0
    for r in range(max_rounds):
        line = persisted.get(r)
        if line is not None:
            # replay: the persisted decision is authoritative — re-deciding
            # on what might now be a larger record set would fork the
            # trajectory (same rule as sweep-alloc replay)
            x = space.clip({k: float(v) for k, v in line["params"].items()})
            best = float(line["objective"])
            step = float(line["step"])
            spent = int(line["spent_nrep"])
            for vals, obj in line.get("evals", ()):
                cache.setdefault(
                    key_of(space.clip(
                        {k: float(v) for k, v in vals.items()})),
                    float(obj))
            cache[key_of(x)] = best
            rounds.append(dict(line))
            n_resumed += 1
            if step < step_tol or (budget is not None and spent >= budget):
                break
            continue
        evals: list = []
        improved = False
        for p in space.params:
            for direction in (1.0, -1.0):
                cand = dict(x)
                cand[p.name] = p.clip(x[p.name]
                                      + direction * step * (p.hi - p.lo))
                cand = space.clip(cand)
                if cand == x:
                    continue
                obj = evaluate(cand)
                evals.append([dict(cand), float(obj)])
                if obj < best - _IMPROVE_EPS:
                    x, best = cand, obj
                    improved = True
        if not improved:
            step *= 0.5
        spent += NREP_SPENT.read() - nrep_mark
        nrep_mark = NREP_SPENT.read()
        store.append_calib_round(calib_id, r, x, best, step, evals, spent)
        rounds.append(dict(kind="calib-round", calib=calib_id, round=r,
                           params=dict(x), objective=float(best),
                           step=float(step), evals=evals,
                           spent_nrep=int(spent)))
        if step < step_tol or (budget is not None and spent >= budget):
            break

    # -- 3. certification on the held-out epochs ---------------------------
    fitted_backend = space.materialize(x)
    fitted_res = Campaign(CampaignSpec(cases, design, name=f"{name}/fitted"),
                          fitted_backend, store).run(snapshot=snap)
    _merge_into_snapshot(snap, fitted_res.fingerprint, fitted_res.records)
    report = certify_heldout(target_res.records, fitted_res.records, n_fit,
                             design, margin=margin, alpha=alpha, seed=seed)

    result = CalibrationResult(
        params=dict(x), objective=float(best), rounds=rounds, report=report,
        target_fingerprint=target_res.fingerprint,
        fitted_fingerprint=fitted_res.fingerprint, calib_id=calib_id,
        n_fit_epochs=n_fit, n_heldout_epochs=n - n_fit,
        spent_nrep=int(spent), n_rounds_resumed=n_resumed)

    if archive is not None:
        store.append_meta(calibration=result.report_dict())
        entry = archive.register(store.path, tag=CALIBRATED_TAG)
        archive.log_calibration(entry, result.report_dict())
        result.run_entry = entry
    return result
