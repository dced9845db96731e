"""The fleet scheduler: lease-queue sweep execution over real processes
(the JAX package's ``repro.fleet.scheduler``, with workers that may open
a CUDA context).

:class:`FleetScheduler` replaces
:class:`~repro_torch.campaign.SweepScheduler`'s static process-pool
sharding (where a dead worker takes its cells with it) with the
:class:`~repro_torch.fleet.queue.LeaseQueue`: workers *claim* cells, hold
them under a heartbeat lease, and lose them — to another worker, after
backoff — when they die or stall. Cells that fail their whole retry
budget are quarantined into a ``sweep-cell-failed`` store record instead
of wedging the campaign.

The durability scheme is all-or-nothing per *attempt*: each claimed cell
runs in its own ``multiprocessing.Process`` (a pool cannot survive a
SIGKILLed member) writing to a private shard store; the parent merges a
shard into the authoritative store only after verifying the full
case x epoch record set landed, and discards the shard of any failed
attempt. A retried cell therefore re-measures from scratch against a
fresh epoch context — which is what makes the merged fleet store
*record-identical* to a serial no-fault run of the same spec: no cell is
ever resumed mid-epoch with an advanced generator, and injected faults
(:mod:`repro_torch.fleet.faults`) decide only whether an attempt lands,
never what it measures.

Workers start from a *fork server*, never by forking the scheduler: the
scheduler may hold a CUDA context (a factor set on ``"cuda"`` reads the
card's name), and a forked child cannot use its parent's. The server is a
fresh interpreter that imports torch and this module once and never
touches CUDA; each attempt is forked from it cheaply and opens its own
context. The server is started, and the ``sim_scan`` kernel built, before
the first lease is granted, so neither counts against a worker's lease.

Attempts are not daemonic, so that an attempt over real collectives
(:class:`~repro_torch.campaign.TorchCollectiveBackend`) can start its rank
groups. The scheduler ends them itself: every attempt still running when
:meth:`FleetScheduler.run` leaves, for whatever reason, is killed, and so,
through an ``atexit`` hook held while it runs, is every attempt still
running when the interpreter exits (what the daemon flag would otherwise
have done). The ranks are children of the
attempt's own fork server, not of the attempt, so an attempt logs each
rank's process id beside its heartbeat
(:func:`~repro_torch.campaign.ranks.log_ranks`), and once the attempt
has ended, by success, crash or lease, the scheduler kills any of them
that still runs and waits until none does.

The heartbeat is progress, not liveness: a worker touches its ``.hb``
file after every durably appended record, so an alive-but-stalled worker
(straggler) goes quiet exactly like a dead one and loses its lease. The
scheduler reads the heartbeats' times, and reports the longest time from
a worker's start to its first heartbeat and the longest gap between two
heartbeats: the numbers a ``lease_ttl`` must exceed.
"""

from __future__ import annotations

import atexit
import multiprocessing as mp
import os
import signal
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

from ..campaign import ranks
from ..campaign.core import Campaign, CampaignSpec
from ..campaign.store import ResultStore
from ..campaign.sweep import CellResult, SweepResult, SweepScheduler, SweepSpec
from ..core.design import analyze_records
from ..core.retry import RetryPolicy
from .faults import CRASH_EXIT_CODE, FaultPlan, FaultyBackend
from .federation import merge_stores
from .queue import QUARANTINED, LeaseQueue

__all__ = ["FleetConfig", "FleetSweepResult", "FleetScheduler",
           "stop_worker_server"]

#: What the fork server imports once, so each per-attempt worker forks
#: with torch and the port loaded (neither initialises CUDA on import).
_PRELOAD = ["torch", "repro_torch.fleet.scheduler"]


@dataclass(frozen=True)
class FleetConfig:
    """Knobs of one fleet run.

    ``lease_ttl`` must exceed the worst-case gap between two record
    appends of a healthy worker (the heartbeat period), and the time from
    a worker's start to its first record, or healthy leases expire;
    ``retry_budget`` counts *attempts*, so 3 means one try plus two
    retries before quarantine. ``clock``/``sleep`` exist so tests can
    drive the scheduler on a fake clock; they stay in the scheduler's
    process.
    """

    n_workers: int = 3
    lease_ttl: float = 5.0
    retry_budget: int = 3
    retry: RetryPolicy = RetryPolicy(base=0.05, max_delay=1.0, seed=0)
    poll_s: float = 0.05
    shard_dir: str | None = None   # default: <store>-shards/ next to it
    faults: FaultPlan | None = None
    keep_shards: bool = False      # leave merged/failed shards for forensics
    clock: Callable[[], float] = field(default=time.time, repr=False)
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)


@dataclass
class FleetSweepResult(SweepResult):
    """A :class:`~repro_torch.campaign.SweepResult` that is honest about
    holes: ``quarantined`` maps cell index -> ``{fingerprint, attempts,
    error}`` for every cell the fleet gave up on."""

    quarantined: dict = field(default_factory=dict)
    fleet: dict = field(default_factory=dict)   # scheduler stats

    def degraded(self) -> bool:
        return bool(self.quarantined)


def _fleet_worker(backend, cases, design, name, shard_path, hb_path,
                  plan, cell_index, attempt, epochs=None, ranks_path=None):
    """One claimed cell, one process, one private shard store.

    Runs the cell as an ordinary campaign against the shard (``epochs``
    windows it to a budgeted round's slice); touches the heartbeat file
    after every durable record append. On any failure the error lands in
    ``<shard>.err`` and the process exits nonzero — the parent discards
    the shard either way, so a worker never has to clean up after itself
    (and an injected hard crash *cannot*). Rank groups the backend starts
    log their ranks to ``ranks_path``; a backend with ``close`` is closed
    after a clean run.
    """
    ranks.log_ranks(ranks_path)
    try:
        inner = backend
        if plan is not None and plan.any_faults():
            backend = FaultyBackend(backend, plan, cell_index,
                                    attempt=attempt, hard=True,
                                    shard_path=str(shard_path))
        store = ResultStore(shard_path)
        hb = Path(hb_path)

        def beat(_rec):
            hb.touch()

        Campaign(CampaignSpec(list(cases), design, name=name),
                 backend, store).run(on_record=beat, epochs=epochs)
        if hasattr(inner, "close"):
            inner.close()
        os._exit(0)
    except BaseException as e:   # noqa: BLE001 — the report IS the handling
        try:
            Path(str(shard_path) + ".err").write_text(
                f"{type(e).__name__}: {e}")
        except OSError:
            pass
        os._exit(1)


def _noop() -> None:
    """The first process a fleet forks: it returns once the fork server
    has imported :data:`_PRELOAD`, so no lease pays for that import."""


def worker_context():
    """The start method of fleet workers: a fork server preloading
    :data:`_PRELOAD`. The server is a fresh interpreter (started with the
    caller's ``sys.path``), so a worker never inherits a CUDA context."""
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(_PRELOAD)
    return ctx


def stop_worker_server() -> None:
    """Stop the fork server and wait for it to exit. It otherwise outlives
    the last fleet until this process ends; a later fleet starts a new
    one. (The standard library offers no public call for this.)"""
    from multiprocessing import forkserver
    forkserver._forkserver._stop()


def _end_ranks(logged, grace_s: float = 10.0) -> int:
    """Every rank an ended attempt logged, as ``(pid, start time)``:
    SIGKILL those still running, then wait at most ``grace_s`` until none
    runs. Returns how many had to be killed; raises ``RuntimeError`` if
    one outlives the wait."""
    killed = 0
    for pid, start in logged:
        if ranks.rank_alive(pid, start):
            try:
                os.kill(pid, signal.SIGKILL)
                killed += 1
            except ProcessLookupError:
                pass
    deadline = time.monotonic() + grace_s
    while any(ranks.rank_alive(pid, start) for pid, start in logged):
        if time.monotonic() > deadline:
            left = [pid for pid, start in logged if ranks.rank_alive(pid, start)]
            raise RuntimeError(f"fleet: rank processes {left} outlived their "
                               f"attempt by {grace_s:g} s after SIGKILL")
        time.sleep(0.02)
    return killed


def _prepare_kernels(pending) -> None:
    """Build and load ``sim_scan`` before any worker on the card starts: a
    worker that had to run ``nvcc`` itself would lose its lease."""
    if any(str(getattr(entry[1], "device", "cpu")).startswith("cuda")
           for entry in pending):
        from ..kernels.sim_scan.kernel import load_kernel
        load_kernel()


class FleetScheduler(SweepScheduler):
    """Run a :class:`~repro_torch.campaign.SweepSpec` fault-tolerantly.

    Inherits compilation, the sweep manifest, and cell-granular resume
    from :class:`~repro_torch.campaign.SweepScheduler` — a fleet store is a
    sweep store, loadable and resumable by either scheduler (and by the
    JAX package's) — and replaces only how pending cells execute.
    Quarantined cells are *not* marked complete, so a resumed fleet run
    re-attempts them (with a fresh retry budget); success then supersedes
    the quarantine record.

    ``n_workers == 1`` schedules in-process: same queue, same retry and
    quarantine semantics, soft (exception-based) crash faults — the mode
    tests drive deterministically. ``n_workers > 1`` runs each attempt in
    a process forked from the fork server (:func:`worker_context`); it
    never falls back to in-process execution.
    """

    def __init__(self, spec: SweepSpec, backend, store: ResultStore,
                 config: FleetConfig | None = None, policy=None):
        if store is None:
            raise ValueError("FleetScheduler: a store is required — lease "
                             "recovery and shard federation are meaningless "
                             "without durable results")
        self.config = config or FleetConfig()
        super().__init__(spec, backend, store,
                         n_workers=self.config.n_workers, policy=policy)
        self._quarantined: dict[int, dict] = {}
        self._queue_stats: dict = {}
        self._timing: dict = {}
        self._ranks: dict = {}
        self._n_corrupt_shard_lines = 0

    # -- public ------------------------------------------------------------

    def run(self) -> FleetSweepResult:
        self._quarantined = {}
        self._queue_stats = {}
        self._timing = dict(first_heartbeat_s=None, heartbeat_gap_s=None,
                            server_start_s=None, n_heartbeats=0)
        self._ranks = dict(rank_pids=[], n_rank_pids_killed=0,
                           group_start_s=[])
        self._n_corrupt_shard_lines = 0
        base = super().run()
        cfg = self.config
        fleet = dict(
            **self._queue_stats,
            **self._timing,
            **self._ranks,
            n_workers=cfg.n_workers,
            lease_ttl=cfg.lease_ttl,
            retry_budget=cfg.retry_budget,
            n_corrupt_shard_lines=self._n_corrupt_shard_lines,
            start_method="forkserver" if cfg.n_workers > 1 else "in-process",
            faults=(None if cfg.faults is None or not cfg.faults.any_faults()
                    else repr(cfg.faults)),
        )
        return FleetSweepResult(
            cells=base.cells, sweep_id=base.sweep_id,
            n_cells_measured=base.n_cells_measured,
            n_cells_resumed=base.n_cells_resumed,
            meta=dict(base.meta, fleet=fleet),
            quarantined=dict(self._quarantined), fleet=fleet)

    # -- SweepScheduler execution hook -------------------------------------

    def _execute_pending(self, pending, sweep_id, snapshot):
        if not pending:
            return {}
        queue = LeaseQueue(
            [(cell.index, fp) for cell, _, _, _, fp in pending],
            lease_ttl=self.config.lease_ttl, policy=self.config.retry,
            retry_budget=self.config.retry_budget)
        if self.config.n_workers <= 1:
            out = self._drive_inprocess(queue, pending, sweep_id, snapshot)
        else:
            out = self._drive_fleet(queue, pending, sweep_id, snapshot)
        # a budgeted sweep calls this hook once per allocation round —
        # accumulate, so the final stats cover every leased work item
        # (the same cell leased in two rounds counts as two items)
        for k, v in queue.stats().items():
            self._queue_stats[k] = self._queue_stats.get(k, 0) + v
        return out

    # -- in-process mode ----------------------------------------------------

    def _drive_inprocess(self, queue, pending, sweep_id, snapshot):
        cfg = self.config
        by_index = {entry[0].index: entry for entry in pending}
        out: dict[int, CellResult] = {}
        while not queue.finished():
            now = cfg.clock()
            task = queue.claim("w0", now)
            if task is None:
                wake = queue.next_wake(now)
                cfg.sleep(max(0.0, (wake - now) if wake is not None
                              else cfg.poll_s))
                continue
            entry = by_index[task.index]
            cell, backend, design, _, _ = entry
            plan = cfg.faults
            if plan is not None and plan.any_faults():
                backend = FaultyBackend(backend, plan, cell.index,
                                        attempt=task.attempts, hard=False)
            try:
                # no store attached: an attempt is all-or-nothing, so a
                # crash mid-cell leaves nothing to mis-resume from
                res = Campaign(self.spec.cell_spec(cell, design),
                               backend).run(epochs=self._epoch_window())
            except Exception as e:   # injected or genuine — same contract
                self._fail(queue, task, sweep_id, snapshot,
                           f"{type(e).__name__}: {e}")
                continue
            out[cell.index] = self._persist_cell(entry, res.records,
                                                 sweep_id, snapshot)
            queue.complete(task.index)
        return out

    def _persist_cell(self, entry, new_records, sweep_id, snapshot):
        """Append a successful attempt's records (deduplicated against
        whatever the store already holds for this fingerprint), then the
        completion marker — the same parent-persists idiom as the pool
        path, so a kill between records costs at most this one cell."""
        cell, _, design, factors, fp = entry
        store = self.store
        have = snapshot.completed(fp)
        store.append_campaign(factors, self.spec.cell_spec(cell, design).meta(),
                              snapshot=snapshot)
        n_new = 0
        for rec in new_records:
            if (rec.case.op, rec.case.msize, rec.epoch) not in have:
                store.append_record(fp, rec)
                snapshot.records.setdefault(fp, []).append(rec)
                n_new += 1
        if self._round_epochs is None:
            store.append_sweep_cell(sweep_id, cell.index, fp)
            snapshot.sweep_cells_by_id.setdefault(sweep_id,
                                                  {})[cell.index] = fp
        records = snapshot.records.get(fp, [])
        return CellResult(cell=cell, factors=factors, fingerprint=fp,
                          table=analyze_records(records,
                                                design.outlier_filter),
                          n_measured=n_new, n_resumed=len(records) - n_new)

    # -- multi-process mode --------------------------------------------------

    def _start_server(self, ctx) -> None:
        """Start the fork server (and let it import :data:`_PRELOAD`)
        before the first lease; a no-op once it runs."""
        t0 = time.perf_counter()
        proc = ctx.Process(target=_noop, daemon=True)
        proc.start()
        proc.join()
        if proc.exitcode != 0:
            raise RuntimeError(f"fleet: the fork server's first worker exited "
                               f"with code {proc.exitcode}")
        if self._timing.get("server_start_s") is None:
            self._timing["server_start_s"] = time.perf_counter() - t0

    def _observe(self, w, mtime: float) -> None:
        """Fold one new heartbeat time into the start-up and gap maxima."""
        t = self._timing
        if w["first_hb"] is None:
            w["first_hb"] = mtime - w["started"]
            t["first_heartbeat_s"] = max(t["first_heartbeat_s"] or 0.0,
                                         w["first_hb"])
        else:
            t["heartbeat_gap_s"] = max(t["heartbeat_gap_s"] or 0.0,
                                       mtime - w["last_hb"])
        t["n_heartbeats"] += 1

    def _drive_fleet(self, queue, pending, sweep_id, snapshot):
        cfg = self.config
        shard_dir = (Path(cfg.shard_dir) if cfg.shard_dir else
                     self.store.path.parent /
                     (self.store.path.stem + "-shards"))
        shard_dir.mkdir(parents=True, exist_ok=True)
        ctx = worker_context()
        _prepare_kernels(pending)
        self._start_server(ctx)
        by_index = {entry[0].index: entry for entry in pending}
        active: dict[int, dict] = {}     # cell index -> live worker state
        out: dict[int, CellResult] = {}
        n_spawned = 0

        def kill_active() -> None:
            # at interpreter exit the standard library would wait for the
            # attempts (they are not daemonic); end them instead
            for w in active.values():
                _kill(w["proc"])

        atexit.register(kill_active)
        try:
            while True:
                now = cfg.clock()
                # 1) reap exited workers (heartbeats first, so a worker
                #    that just finished is not simultaneously "expired")
                for idx in list(active):
                    w = active[idx]
                    try:
                        m = w["hb"].stat().st_mtime
                    except OSError:
                        m = w["last_hb"]
                    if m > w["last_hb"]:
                        self._observe(w, m)
                        w["last_hb"] = m
                        queue.heartbeat(idx, now)
                    if w["proc"].is_alive():
                        continue
                    w["proc"].join()
                    res, err = self._reap(by_index[idx], w,
                                          w["proc"].exitcode,
                                          sweep_id, snapshot)
                    if err is None:
                        queue.complete(idx)
                        out[idx] = res
                    else:
                        self._fail(queue, queue.tasks[idx], sweep_id,
                                   snapshot, err, now=cfg.clock())
                    self._cleanup(w, failed=err is not None)
                    del active[idx]
                # 2) revoke leases whose heartbeat went quiet
                for task in queue.expired(cfg.clock()):
                    w = active.pop(task.index, None)
                    if w is not None:
                        _kill(w["proc"])
                        self._cleanup(w, failed=True)
                    self._fail(queue, task, sweep_id, snapshot,
                               f"lease expired after {cfg.lease_ttl:.1f}s "
                               "without a heartbeat (worker stalled or "
                               "unreachable)", now=cfg.clock())
                # 3) hand free workers the next eligible cells
                now = cfg.clock()
                while len(active) < cfg.n_workers:
                    task = queue.claim(f"w{n_spawned}", now)
                    if task is None:
                        break
                    active[task.index] = self._spawn(
                        ctx, by_index[task.index], task, shard_dir)
                    n_spawned += 1
                if queue.finished():
                    break
                cfg.sleep(cfg.poll_s)
        finally:
            atexit.unregister(kill_active)
            for w in active.values():    # interrupted: leave no orphans
                _kill(w["proc"])
                self._cleanup(w, failed=True)
            if not cfg.keep_shards:
                try:
                    shard_dir.rmdir()    # only if empty — best effort
                except OSError:
                    pass
        return out

    def _spawn(self, ctx, entry, task, shard_dir):
        cell, backend, design, _, _ = entry
        stem = f"cell{cell.index:03d}-a{task.attempts:02d}"
        shard = shard_dir / f"{stem}.jsonl"
        hb = shard_dir / f"{stem}.hb"
        err = shard_dir / f"{stem}.jsonl.err"
        ranks_log = shard_dir / f"{stem}.ranks"
        for p in (shard, hb, err, ranks_log):   # stale residue of a killed run
            p.unlink(missing_ok=True)
        hb.touch()
        started = hb.stat().st_mtime
        proc = ctx.Process(
            target=_fleet_worker,
            args=(backend, self.spec.cases, design,
                  self.spec.cell_spec(cell, design).name, str(shard),
                  str(hb), self.config.faults, cell.index, task.attempts,
                  self._epoch_window(), str(ranks_log)),
            daemon=False)
        proc.start()
        return dict(proc=proc, shard=shard, hb=hb, err=err, ranks=ranks_log,
                    started=started, last_hb=started, first_hb=None)

    def _reap(self, entry, w, exitcode, sweep_id, snapshot):
        """Judge one exited worker: merge its shard on verified success,
        or return the failure message that releases its lease."""
        cell, _, design, factors, fp = entry
        if exitcode != 0:
            if w["err"].exists():
                return None, w["err"].read_text().strip()
            if exitcode == CRASH_EXIT_CODE:
                return None, (f"worker killed mid-cell (exit {exitcode}, "
                              "injected crash)")
            return None, f"worker died with exit code {exitcode}"
        shard = ResultStore(w["shard"])
        with warnings.catch_warnings():
            warnings.simplefilter("always")   # shard corruption is counted,
            ssnap = shard.snapshot()          # not raised, below
        if self.spec.cases:
            window = self._epoch_window() or range(design.n_launch_epochs)
            expected = {(c.op, int(c.msize), e) for c in self.spec.cases
                        for e in window}
            if not expected <= ssnap.completed(fp):
                return None, ("worker exited cleanly but its shard is "
                              f"missing {len(expected - ssnap.completed(fp))} "
                              "of the cell's records")
        stats = merge_stores(self.store, [shard], snapshot=snapshot)
        self._n_corrupt_shard_lines += ssnap.n_corrupt
        if self._round_epochs is None:
            self.store.append_sweep_cell(sweep_id, cell.index, fp)
            snapshot.sweep_cells_by_id.setdefault(sweep_id,
                                                  {})[cell.index] = fp
        records = snapshot.records.get(fp, [])
        res = CellResult(cell=cell, factors=factors, fingerprint=fp,
                         table=analyze_records(records,
                                               design.outlier_filter),
                         n_measured=stats.n_records,
                         n_resumed=len(records) - stats.n_records)
        return res, None

    def _cleanup(self, w, failed: bool):
        """After an attempt has ended: end the ranks it left, then remove
        its files (unless ``keep_shards``)."""
        logged, startups = ranks.read_rank_log(w["ranks"])
        self._ranks["n_rank_pids_killed"] += _end_ranks(logged)
        self._ranks["rank_pids"] += [pid for pid, _ in logged]
        self._ranks["group_start_s"] += startups
        if self.config.keep_shards:
            return
        for key in ("shard", "hb", "err", "ranks"):
            w[key].unlink(missing_ok=True)

    # -- shared failure path -------------------------------------------------

    def _fail(self, queue, task, sweep_id, snapshot, error: str,
              now: float | None = None):
        state = queue.release(task.index, self.config.clock()
                              if now is None else now, error)
        if state != QUARANTINED:
            return
        info = dict(fingerprint=task.fingerprint, attempts=task.attempts,
                    error=str(error)[:500])
        self.store.append_sweep_cell_failed(
            sweep_id, task.index, task.fingerprint, task.attempts, error)
        snapshot.sweep_failed_by_id.setdefault(sweep_id, {})[task.index] = info
        self._quarantined[task.index] = info
        warnings.warn(
            f"fleet: quarantining sweep cell {task.index} "
            f"(fingerprint {task.fingerprint[:12]}…) after "
            f"{task.attempts} failed attempts; last error: {error}",
            RuntimeWarning, stacklevel=4)


def _kill(proc) -> None:
    """Stop a worker that lost its lease: polite, then SIGKILL."""
    if not proc.is_alive():
        proc.join()
        return
    proc.terminate()
    proc.join(0.5)
    if proc.is_alive():
        proc.kill()
        proc.join(1.0)
