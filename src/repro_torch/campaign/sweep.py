"""Sharded, resumable factor-sweep campaigns.

The paper's headline result is *which experimental factors matter*; to
answer that for a new system the factor space has to be executable, not
just recorded. A :class:`SweepSpec` pairs a
:class:`~repro_torch.core.factors.FactorGrid` (enumerable factor axes) with a
case list and a base :class:`~repro_torch.core.design.ExperimentDesign`; the
:class:`SweepScheduler` compiles every grid cell into an ordinary
:class:`~repro_torch.campaign.Campaign` (cell levels applied by dataclass
replacement, so each cell's :class:`~repro_torch.core.factors.FactorSet` comes
from the backend's own ``factors()`` plumbing) and runs them all —
serially, or sharded over a process pool through the same
:func:`~repro_torch.core.design.map_parallel` machinery that fans out launch
epochs.

Persistence lives in one JSONL :class:`~repro_torch.campaign.ResultStore` for
the whole sweep: a ``sweep`` manifest line declares the grid (axes, per-
cell levels and fingerprints), the cells' campaign/record lines carry the
measurements, and a ``sweep-cell`` marker is appended only after a cell's
last record — so a killed sweep resumes at *cell* granularity (marked
cells load instead of re-measuring), and in the serial path a cell that
was itself killed mid-campaign additionally resumes at *record*
granularity through the normal campaign resume. Sharded workers measure
whole cells and the parent persists each cell the moment it completes.

With an :class:`~repro_torch.sweeps.alloc.AllocationPolicy` attached
(``policy=``), the scheduler runs *budgeted*: the policy plans rounds —
a launch-epoch window over the currently surviving cells — and after
each round decides, on the accumulated data, which factor axes are
resolved (MATTERS or null) and can stop receiving budget. Rounds execute
through the same ``_execute_pending`` hook as everything else (serial,
or sharded over spawned workers), each round's
verdicts are persisted as a ``sweep-alloc`` line, and a cell's
``sweep-cell`` marker is written only when the *allocation* finishes —
for a budgeted sweep the marker means "the policy is done with this
cell", which may be well short of the design's full epoch count.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.design import (ExperimentDesign, ResultTable, TestCase,
                           analyze_records, map_parallel)
from ..core.factors import FactorGrid, FactorSet, GridCell

from .core import Campaign, CampaignResult, CampaignSpec
from .store import ResultStore

__all__ = ["SweepSpec", "CellResult", "SweepResult", "SweepScheduler"]


@dataclass
class SweepSpec:
    """What to sweep: the factor grid, the cases measured in every cell,
    and the base design each cell derives its own design from."""

    grid: FactorGrid
    cases: list[TestCase]
    design: ExperimentDesign
    name: str = "sweep"

    def cell_spec(self, cell: GridCell, design: ExperimentDesign) -> CampaignSpec:
        return CampaignSpec(cases=list(self.cases), design=design,
                            name=f"{self.name}/cell{cell.index:03d}")


@dataclass
class CellResult:
    """One measured (or resumed) grid cell."""

    cell: GridCell
    factors: FactorSet
    fingerprint: str
    table: ResultTable
    n_measured: int = 0            # record cells executed this run
    n_resumed: int = 0             # record cells loaded from the store

    def levels(self) -> dict[str, str]:
        return self.cell.levels()


@dataclass
class SweepResult:
    cells: list[CellResult]
    sweep_id: str | None = None
    n_cells_measured: int = 0      # grid cells with fresh measurements
    n_cells_resumed: int = 0       # grid cells loaded entirely from store
    meta: dict = field(default_factory=dict)


def _run_cell(backend, cases, design, name, epochs=None) -> CampaignResult:
    """Measure one grid cell in a worker process. No store attached — the
    parent persists each finished cell (one writer per JSONL file)."""
    return Campaign(CampaignSpec(list(cases), design, name=name),
                    backend).run(epochs=epochs)


class SweepScheduler:
    """Compile a grid x case list into per-cell campaigns and run them.

    ``n_workers > 1`` shards whole cells over a pool of spawned processes
    (each worker opens its own CUDA context when the backend is on the
    card, and runs its cell's launch epochs serially); the parent appends
    finished cells to the store as they complete, so even a killed
    sharded sweep keeps every completed cell.

    ``policy`` — an :class:`~repro_torch.sweeps.alloc.AllocationPolicy`
    instance or registry name (``"uniform"``, ``"racing"``,
    ``"successive_halving"``) — switches :meth:`run` to the budgeted
    round loop. A store is then required: the round decisions must
    persist for kill/resume to replay them.
    """

    def __init__(self, spec: SweepSpec, backend,
                 store: ResultStore | None = None, n_workers: int = 1,
                 policy=None):
        if isinstance(policy, str):
            from ..sweeps.alloc import make_policy
            policy = make_policy(policy)
        self.spec = spec
        self.backend = backend
        self.store = store
        self.n_workers = max(1, int(n_workers))
        self.policy = policy
        #: the launch-epoch window ``(lo, hi)`` of the budgeted round being
        #: executed, or ``None`` outside one. Execution paths consult it to
        #: window their campaigns and to *suppress* ``sweep-cell`` markers
        #: (a cell is not complete just because one round touched it).
        self._round_epochs: tuple[int, int] | None = None

    # -- compilation -------------------------------------------------------

    def compile(self) -> list[tuple[GridCell, object, ExperimentDesign,
                                    FactorSet, str]]:
        """Materialize every grid cell and verify fingerprint uniqueness.

        A collision means an axis varies something the backend does not
        surface in its ``factors()`` — running it would silently merge two
        different experiments under one store key, so it is an error here,
        before anything is measured.
        """
        out = []
        seen: dict[str, GridCell] = {}
        for cell in self.spec.grid.cells():
            backend, design = cell.materialize(self.backend, self.spec.design)
            factors = backend.factors(design)
            fp = factors.fingerprint()
            if fp in seen:
                raise ValueError(
                    f"factor grid cells {seen[fp].levels()} and "
                    f"{cell.levels()} share fingerprint {fp} — an axis "
                    "level is not reflected in the backend's FactorSet")
            seen[fp] = cell
            out.append((cell, backend, design, factors, fp))
        return out

    # -- execution ---------------------------------------------------------

    def run(self) -> SweepResult:
        if self.policy is not None:
            return self._run_adaptive()
        return self._run_uniform()

    def _run_uniform(self) -> SweepResult:
        spec, store = self.spec, self.store
        compiled = self.compile()

        sweep_id = None
        done: dict[int, str] = {}
        # one full-file scan for the whole sweep: every per-cell store
        # consultation below (campaign dedup, resume lookup, completed-set)
        # goes through this snapshot instead of re-parsing the JSONL
        snapshot = store.snapshot() if store is not None else None
        if store is not None:
            manifest = dict(
                spec.grid.manifest(), name=spec.name,
                cases=[[c.op, int(c.msize)] for c in spec.cases],
                cells=[[cell.index, fp, cell.levels()]
                       for cell, _, _, _, fp in compiled],
            )
            sweep_id = store.append_sweep(manifest, snapshot=snapshot)
            done = snapshot.sweep_cells_by_id.get(sweep_id, {})

        results: dict[int, CellResult] = {}
        pending = []
        for entry in compiled:
            cell, backend, design, factors, fp = entry
            if store is not None and self._cell_complete(cell, design, fp,
                                                         sweep_id, done,
                                                         snapshot):
                records = snapshot.records.get(fp, [])
                results[cell.index] = CellResult(
                    cell=cell, factors=factors, fingerprint=fp,
                    table=analyze_records(records, design.outlier_filter),
                    n_resumed=len(records))
            else:
                pending.append(entry)

        results.update(self._execute_pending(pending, sweep_id, snapshot))

        cells = [results[i] for i in sorted(results)]
        return SweepResult(
            cells=cells, sweep_id=sweep_id,
            n_cells_measured=sum(1 for c in cells if c.n_measured),
            n_cells_resumed=sum(1 for c in cells if not c.n_measured),
            meta=dict(name=spec.name, n_cells=len(cells),
                      axes=[ax.name for ax in spec.grid.axes],
                      n_workers=self.n_workers),
        )

    def _run_adaptive(self) -> SweepResult:
        """The budgeted round loop: plan → execute → look → persist.

        Every round executes through :meth:`_execute_pending` (the one
        execution hook), restricted to the plan's cells and epoch window;
        measurement resume is *record*-granular, so a round interrupted
        anywhere picks up exactly where it died. After each
        round the policy looks at a fresh store snapshot and its verdicts
        are appended as a ``sweep-alloc`` line — unless that round's line
        already exists (a killed run being resumed), in which case the
        persisted verdicts are replayed instead of re-deciding on what
        might by now be a larger record set. Since policies are pure
        functions of the observed records, both paths produce the same
        allocation sequence — which is what keeps sharded == serial
        bit-identity and the kill/resume property intact under racing.
        """
        from dataclasses import asdict

        from ..sweeps.alloc import build_state

        spec, store, policy = self.spec, self.store, self.policy
        if store is None:
            raise ValueError(
                "budgeted sweeps need a store: allocation rounds persist "
                "their decisions as sweep-alloc lines (pass store=)")
        if not spec.cases:
            raise ValueError(
                "budgeted sweeps need an explicit case list — round "
                "completeness is undecidable without it")
        compiled = self.compile()
        by_index = {entry[0].index: entry for entry in compiled}
        n_epochs_max = spec.design.n_launch_epochs

        snapshot = store.snapshot()
        manifest = dict(
            spec.grid.manifest(), name=spec.name,
            cases=[[c.op, int(c.msize)] for c in spec.cases],
            cells=[[cell.index, fp, cell.levels()]
                   for cell, _, _, _, fp in compiled],
            policy=policy.manifest(),
        )
        sweep_id = store.append_sweep(manifest, snapshot=snapshot)

        fresh: set[int] = set()        # cells with new records this run
        rounds: list[dict] = []
        while True:
            state = build_state(manifest, snapshot, sweep_id, n_epochs_max,
                                spec.design.outlier_filter)
            plan = policy.plan_round(state)
            if plan is None:
                break
            lo, hi = plan.epochs
            quarantined = snapshot.sweep_failed_by_id.get(sweep_id, {})
            window = {(c.op, int(c.msize), e)
                      for c in spec.cases for e in range(lo, hi)}
            pending = [by_index[i] for i in plan.cells
                       if i in by_index and i not in quarantined
                       and not window <= snapshot.completed(by_index[i][4])]
            if pending:
                self._round_epochs = (lo, hi)
                try:
                    measured = self._execute_pending(pending, sweep_id,
                                                     snapshot)
                finally:
                    self._round_epochs = None
                fresh.update(i for i, r in measured.items() if r.n_measured)
            # decide on a *fresh* snapshot: round execution (serial
            # campaigns, sharded merges) appends records the in-memory
            # snapshot does not fully track
            snapshot = store.snapshot()
            persisted = snapshot.sweep_alloc_by_id.get(sweep_id, [])
            if plan.round >= len(persisted):
                state = build_state(manifest, snapshot, sweep_id,
                                    n_epochs_max,
                                    spec.design.outlier_filter)
                decisions = policy.decide(state)
                store.append_sweep_alloc(
                    sweep_id, plan.round, list(plan.cells), (lo, hi),
                    {a: asdict(d) for a, d in decisions.items()},
                    state.spent_nrep, policy.name)
                snapshot.sweep_alloc_by_id.setdefault(sweep_id, []).append(
                    dict(kind="sweep-alloc", sweep=sweep_id,
                         round=plan.round, cells=list(plan.cells),
                         epochs=[lo, hi],
                         decisions={a: asdict(d)
                                    for a, d in decisions.items()},
                         spent_nrep=state.spent_nrep, policy=policy.name))
            rounds.append(dict(round=plan.round, epochs=[lo, hi],
                               n_cells=len(plan.cells)))

        # `state` is the snapshot-fresh view the loop broke on
        failed = snapshot.sweep_failed_by_id.get(sweep_id, {})
        marked = snapshot.sweep_cells_by_id.get(sweep_id, {})
        cells_out: list[CellResult] = []
        for cell, backend, design, factors, fp in compiled:
            records = snapshot.records.get(fp, [])
            if not records or cell.index in failed:
                continue               # quarantined (or never measured)
            if cell.index not in marked:
                # allocation finished with this cell — marker written now,
                # not per round, so a killed budgeted sweep never claims a
                # cell the policy might still have extended
                store.append_sweep_cell(sweep_id, cell.index, fp)
                marked[cell.index] = fp
            cells_out.append(CellResult(
                cell=cell, factors=factors, fingerprint=fp,
                table=analyze_records(records, design.outlier_filter),
                n_measured=len(records) if cell.index in fresh else 0,
                n_resumed=0 if cell.index in fresh else len(records)))

        design = spec.design
        uniform_nrep = None
        if not design.adaptive:
            uniform_nrep = (len(compiled) * len(spec.cases)
                            * n_epochs_max * design.nrep)
        savings = (uniform_nrep / state.spent_nrep
                   if uniform_nrep and state.spent_nrep else None)
        alloc = dict(
            policy=policy.name, policy_params=policy.manifest(),
            n_rounds=state.round, rounds=rounds,
            spent_nrep=state.spent_nrep, uniform_nrep=uniform_nrep,
            savings=savings, decisions=dict(state.decided),
            undecided=state.undecided())
        return SweepResult(
            cells=cells_out, sweep_id=sweep_id,
            n_cells_measured=sum(1 for c in cells_out if c.n_measured),
            n_cells_resumed=sum(1 for c in cells_out if not c.n_measured),
            meta=dict(name=spec.name, n_cells=len(cells_out),
                      axes=[ax.name for ax in spec.grid.axes],
                      n_workers=self.n_workers, alloc=alloc),
        )

    def _epoch_window(self):
        """The epoch iterable campaigns should run under — the budgeted
        round's window, or ``None`` (all epochs) outside one."""
        if self._round_epochs is None:
            return None
        return range(self._round_epochs[0], self._round_epochs[1])

    def _execute_pending(self, pending, sweep_id,
                         snapshot) -> dict[int, CellResult]:
        """How the not-yet-complete cells actually get measured — the one
        hook a different execution strategy overrides (a fault-tolerant
        lease queue of workers would replace exactly this).
        Everything around it — compilation, manifests, cell-granular
        resume, result assembly — is shared."""
        measured = self._run_parallel(pending, sweep_id, snapshot) \
            if self.n_workers > 1 and len(pending) > 1 else None
        if measured is None:
            measured = self._run_serial(pending, sweep_id, snapshot)
        return measured

    def _cell_complete(self, cell, design, fp, sweep_id, done,
                       snapshot) -> bool:
        """A cell resumes without running when its ``sweep-cell`` marker is
        in the store — or when the store already holds its full
        case x epoch record set under another sweep id (a fractional grid
        whose ``fraction`` was raised re-declares a new manifest, but the
        nested cells' measurements are the same experiment and must not be
        re-measured). In the latter case the marker is added under the new
        sweep id so the next resume is a plain lookup."""
        if cell.index in done:
            return True
        if not self.spec.cases:       # completeness undecidable without the
            return False              # explicit case list
        expected = {(c.op, int(c.msize), e) for c in self.spec.cases
                    for e in range(design.n_launch_epochs)}
        if not expected <= snapshot.completed(fp):
            return False
        self.store.append_sweep_cell(sweep_id, cell.index, fp)
        snapshot.sweep_cells_by_id.setdefault(sweep_id, {})[cell.index] = fp
        return True

    def _run_serial(self, pending, sweep_id, snapshot) -> dict[int, CellResult]:
        """One cell after another, each through the ordinary (record-
        granular, store-resuming) campaign path."""
        out: dict[int, CellResult] = {}
        for cell, backend, design, factors, fp in pending:
            # a partially-successful parallel attempt (pool died mid-sweep)
            # already persisted some of these cells and recorded them in
            # the snapshot — load, don't re-measure
            marked = (snapshot.sweep_cells_by_id.get(sweep_id, {})
                      if snapshot is not None else {})
            if cell.index in marked:
                records = snapshot.records.get(fp, [])
                out[cell.index] = CellResult(
                    cell=cell, factors=factors, fingerprint=fp,
                    table=analyze_records(records, design.outlier_filter),
                    n_resumed=len(records))
                continue
            res = Campaign(self.spec.cell_spec(cell, design), backend,
                           self.store).run(snapshot=snapshot,
                                           epochs=self._epoch_window())
            if self.store is not None and self._round_epochs is None:
                self.store.append_sweep_cell(sweep_id, cell.index, fp)
            out[cell.index] = CellResult(
                cell=cell, factors=factors, fingerprint=fp, table=res.table,
                n_measured=res.n_measured, n_resumed=res.n_resumed)
        return out

    def _run_parallel(self, pending, sweep_id,
                      snapshot) -> dict[int, CellResult] | None:
        """Shard whole cells over a process pool; the parent persists each
        cell as it completes. ``None`` falls back to the serial path."""
        spec, store = self.spec, self.store

        def persist(i: int, res: CampaignResult) -> None:
            if store is None:
                return
            cell, _, design, factors, fp = pending[i]
            # a previous (killed) serial run may have left partial records
            # for this fingerprint — the worker re-measured the whole cell,
            # so only append what the store does not already hold
            have = snapshot.completed(fp)
            store.append_campaign(factors, spec.cell_spec(cell, design).meta(),
                                  snapshot=snapshot)
            for rec in res.records:
                if (rec.case.op, rec.case.msize, rec.epoch) not in have:
                    store.append_record(fp, rec)
                    # keep the snapshot coherent: if the pool dies later,
                    # the serial fallback must see these cells as done
                    # rather than re-measure and duplicate their records
                    snapshot.records.setdefault(fp, []).append(rec)
            if self._round_epochs is None:
                store.append_sweep_cell(sweep_id, cell.index, fp)
                snapshot.sweep_cells_by_id.setdefault(sweep_id,
                                                      {})[cell.index] = fp

        window = self._epoch_window()
        rets = map_parallel(
            _run_cell,
            [(backend, spec.cases, design,
              spec.cell_spec(cell, design).name, window)
             for cell, backend, design, _, _ in pending],
            self.n_workers, what="sweep cells", on_result=persist)
        if rets is None:
            return None
        out: dict[int, CellResult] = {}
        for (cell, _, _, factors, fp), res in zip(pending, rets):
            out[cell.index] = CellResult(
                cell=cell, factors=factors, fingerprint=fp, table=res.table,
                n_measured=res.n_measured, n_resumed=res.n_resumed)
        return out
