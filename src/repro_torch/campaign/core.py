"""The Campaign orchestrator: the paper's method end-to-end, resumable.

A :class:`CampaignSpec` (cases + :class:`~repro_torch.core.design.ExperimentDesign`)
run by :class:`Campaign` against a
:class:`~repro_torch.campaign.backends.MeasurementBackend` executes the
pipeline — factor capture → launch-epoch replication → randomized case
order → (adaptive-nrep) measurement → persistent store → Tukey + per-epoch
averages (Alg. 6) — and returns a :class:`CampaignResult`. With a
:class:`~repro_torch.campaign.store.ResultStore` attached, every measured
cell is appended the moment it exists, and re-running the identical spec
*resumes*: cells already in the store are loaded instead of re-measured.
Case orders are drawn up front from the design seed, so a campaign resumed
at an epoch boundary yields records identical to an uninterrupted one, and
a run restricted to a window of launch epochs (``epochs=``, what a
budgeted sweep and a calibration fit run under) appends exactly the
records those epochs get in a full run.
"""

from __future__ import annotations

import platform
from dataclasses import dataclass, field

from ..core.design import (NREP_SPENT, ExperimentDesign,
                           MeasurementRecord, ResultTable, TestCase,
                           analyze_records, case_orders, measure_case)
from ..core.factors import FactorSet
from ..simengine import engine_stats
from .backends import MeasurementBackend
from .store import ResultStore, StoreSnapshot

__all__ = ["CampaignSpec", "CampaignResult", "Campaign"]


def _dispatch_delta(before: dict, after: dict) -> dict | None:
    """This campaign's share of the engine's dispatch telemetry; None when
    the campaign never dispatched to the torch engine."""
    nd = after["n_dispatches"] - before["n_dispatches"]
    if nd <= 0:
        return None
    return dict(n_dispatches=nd,
                n_new_shapes=after["n_shapes"] - before["n_shapes"])


@dataclass
class CampaignSpec:
    """What to measure, independent of how: the backend supplies the how."""

    cases: list[TestCase]
    design: ExperimentDesign
    name: str = "campaign"

    def meta(self) -> dict:
        d = self.design
        return dict(
            name=self.name,
            cases=[[c.op, int(c.msize)] for c in self.cases],
            n_launch_epochs=d.n_launch_epochs,
            nrep=d.nrep, nrep_min=d.nrep_min, nrep_max=d.nrep_max,
            rel_ci_target=d.rel_ci_target, shuffle=d.shuffle, seed=d.seed,
        )


@dataclass
class CampaignResult:
    records: list[MeasurementRecord]
    table: ResultTable
    factors: FactorSet
    fingerprint: str | None = None
    n_measured: int = 0               # cells executed this run
    n_resumed: int = 0                # cells loaded from the store
    meta: dict = field(default_factory=dict)


class Campaign:
    """Run a :class:`CampaignSpec` on a backend, optionally through a store."""

    def __init__(self, spec: CampaignSpec, backend: MeasurementBackend,
                 store: ResultStore | None = None):
        self.spec = spec
        self.backend = backend
        self.store = store

    def run(self, snapshot: StoreSnapshot | None = None,
            on_record=None, epochs=None) -> CampaignResult:
        """Execute (or resume) the campaign. ``snapshot`` — a
        :meth:`~repro_torch.campaign.ResultStore.snapshot` of the attached
        store — replaces the per-run full-file resume scan; a sweep runs
        many campaigns against one growing file and passes the one
        snapshot it took up front. ``on_record(record)`` fires after every
        *freshly measured* cell is (if a store is attached) appended.

        ``epochs`` — an iterable of launch-epoch indices — restricts the
        run to a *window* of the design's epochs. The window must stay
        inside ``design.n_launch_epochs``: the epoch count is part of the
        factor fingerprint. Case orders for *all* epochs are still drawn
        up front from the design seed, and a backend's fused
        ``measure_epochs`` receives only the window's work, so measuring
        epochs ``[0, 1)`` now and ``[1, 3)`` later appends exactly the
        records an uninterrupted full run would have."""
        spec, backend, store = self.spec, self.backend, self.store
        design = spec.design
        cases = list(spec.cases) or backend.default_cases()
        factors = backend.factors(design)

        if epochs is None:
            epoch_window = None
        else:
            epoch_window = sorted({int(e) for e in epochs})
            bad = [e for e in epoch_window
                   if not 0 <= e < design.n_launch_epochs]
            if bad:
                raise ValueError(
                    f"Campaign: epochs {bad} outside the design's "
                    f"0..{design.n_launch_epochs - 1} range — the epoch "
                    "count is fingerprinted, so a wider window needs a "
                    "new design, not a bigger window")

        fingerprint = None
        done: dict[tuple[str, int, int], MeasurementRecord] = {}
        if store is not None:
            fingerprint = store.append_campaign(factors, spec.meta(),
                                                snapshot=snapshot)
            stored = (snapshot.records.get(fingerprint, [])
                      if snapshot is not None else store.records(fingerprint))
            done = {(r.case.op, r.case.msize, r.epoch): r for r in stored}

        records: list[MeasurementRecord] = []
        n_measured = n_resumed = 0
        orders = list(enumerate(case_orders(design, cases)))
        stats0 = engine_stats()

        # Fused execution: a backend advertising `measure_epochs` gets the
        # window's pending work in one call and may batch epochs into shared
        # device launches. `None` (capability gated off for this
        # configuration) means per-epoch measurement below.
        fused: dict = {}
        measure_epochs = getattr(backend, "measure_epochs", None)
        if measure_epochs is not None:
            work = {}
            for epoch, order in orders:
                if epoch_window is not None and epoch not in epoch_window:
                    continue
                pending = [c for c in order
                           if (c.op, c.msize, epoch) not in done]
                if pending:
                    work[epoch] = pending
            if work:
                fused = measure_epochs(work, design) or {}

        for epoch, order in orders:
            if epoch_window is not None and epoch not in epoch_window:
                continue
            missing = [c for c in order
                       if (c.op, c.msize, epoch) not in done
                       and (c.op, c.msize, epoch) not in fused]
            ctx = backend.make_epoch(epoch) if missing else None
            for case in order:
                key = (case.op, case.msize, epoch)
                if key in done:
                    records.append(done[key])
                    n_resumed += 1
                    continue
                if key in fused:
                    times, meta = fused.pop(key)
                    NREP_SPENT.add(times.size)
                else:
                    times, meta = measure_case(backend.measure, ctx, case,
                                               design)
                # `host` is deliberately NOT part of the fingerprint
                # (FactorSet excludes it), so a merged multi-host store
                # needs it stamped on every record to stay auditable.
                meta.setdefault("host", platform.node())
                # Backend-provided provenance (engine, device). Fused
                # records carry theirs already — their epoch context lives
                # inside the backend's fused call, not here.
                record_meta = getattr(backend, "record_meta", None)
                if record_meta is not None and ctx is not None:
                    for k, v in record_meta(ctx, case).items():
                        meta.setdefault(k, v)
                rec = MeasurementRecord(case=case, epoch=epoch, times=times,
                                        meta=meta)
                if store is not None:
                    store.append_record(fingerprint, rec)
                if on_record is not None:
                    on_record(rec)
                records.append(rec)
                n_measured += 1

        table = analyze_records(records, design.outlier_filter)
        meta = spec.meta()
        dispatch = _dispatch_delta(stats0, engine_stats())
        if dispatch is not None:
            meta["dispatch"] = dispatch
        return CampaignResult(records=records, table=table, factors=factors,
                              fingerprint=fingerprint, n_measured=n_measured,
                              n_resumed=n_resumed, meta=meta)
