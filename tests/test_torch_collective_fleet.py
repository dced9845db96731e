"""``TorchCollectiveBackend`` inside a fleet's attempts and a sweep's pool
workers, on gloo ranks on the CPU.

Each fleet attempt and each pool worker starts its own rank groups (a
fresh group per launch epoch) from a fork server of its own. The fleet,
with one cell's first attempt crashed mid-epoch, and the 2-worker sweep
write the same cells, fingerprints and case sets as the serial run of
the same spec; the times are measurements and differ between runs. Every
case's outputs are held exactly against ``expected_collective`` on every
rank when it is built, and a case that differs fails its attempt: so a
cell that lands held them. After the fleet no rank process runs, those
of the crashed attempt included. A pickled backend carries no group.
"""

import contextlib
import multiprocessing as mp
import pickle
import signal
import subprocess
import sys
import warnings

import pytest

from repro_torch.campaign import (ResultStore, SweepScheduler, SweepSpec,
                                  TorchCollectiveBackend)
from repro_torch.campaign import ranks
from repro_torch.campaign.ranks import rank_alive
from repro_torch.core import ExperimentDesign, FactorAxis, FactorGrid, TestCase
from repro_torch.core.runtime_meter import MeterConfig
from repro_torch.fleet import FaultPlan, FleetConfig, FleetScheduler
from repro_torch.fleet.scheduler import _end_ranks, stop_worker_server

CASES = (TestCase("psum", 1 << 10), TestCase("all_gather", 1 << 12))
EPOCHS, NREP = 2, 5
#: seed 1 crashes cell 1's (bfloat16's) first attempt at its first
#: measure call, with its first epoch's ranks running, and no other
CRASH = FaultPlan(seed=1, p_crash=0.5, within_calls=2)


@contextlib.contextmanager
def _limit(seconds: int):
    """Fail with ``TimeoutError`` past ``seconds`` of wall (``SIGALRM``,
    in the test's main thread): the group start-ups dominate each test."""
    def expire(signum, frame):
        raise TimeoutError(f"past the test's limit of {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _sweep():
    grid = FactorGrid((FactorAxis("dtype", ("float32", "bfloat16")),),
                      design_seed=0)
    spec = SweepSpec(grid=grid, cases=list(CASES),
                     design=ExperimentDesign(n_launch_epochs=EPOCHS, nrep=NREP,
                                             seed=0),
                     name="collective-fleet")
    return spec, TorchCollectiveBackend(n_ranks=2, device="cpu")


def _cells(store, sweep_id):
    """Per grid cell: its fingerprint, and each record's (op, msize,
    epoch, number of times)."""
    return {idx: (fp, sorted((r.case.op, r.case.msize, r.epoch, len(r.times))
                             for r in store.records(fp)))
            for idx, fp in store.sweep_cells(sweep_id).items()}


@pytest.fixture(scope="module")
def serial(tmp_path_factory):
    spec, backend = _sweep()
    store = ResultStore(tmp_path_factory.mktemp("serial") / "serial.jsonl")
    with _limit(60):
        res = SweepScheduler(spec, backend, store, n_workers=1).run()
    cells = _cells(store, res.sweep_id)
    assert len(cells) == 2
    want = sorted((c.op, c.msize, e, NREP) for c in CASES for e in range(EPOCHS))
    assert all(records == want for _, records in cells.values())
    return cells


def _no_rank_alive(pids) -> bool:
    return pids and not any(rank_alive(pid) for pid in pids)


def test_fleet_of_two_workers_over_real_collectives(serial, tmp_path):
    """Two attempts at a time, cell 1's first crashed mid-epoch: every
    cell lands once, with the serial run's fingerprints and case sets;
    each epoch of each attempt ran on a fresh group; no rank of any
    attempt is left, and the crashed attempt's were found and ended."""
    spec, backend = _sweep()
    store = ResultStore(tmp_path / "fleet.jsonl")
    before = set(mp.active_children())
    try:
        with _limit(90):
            res = FleetScheduler(spec, backend, store, FleetConfig(
                n_workers=2, lease_ttl=60.0, poll_s=0.02, faults=CRASH)).run()
    finally:
        stop_worker_server()
    assert not res.quarantined and res.n_cells_measured == 2
    assert res.fleet["start_method"] == "forkserver"
    assert res.fleet["n_failed_attempts"] == 1           # the crash, retried
    assert _cells(store, res.sweep_id) == serial
    # 3 attempts: the clean cell's 2 epochs, the crashed one's first epoch,
    # then its retry's 2; each group's 2 ranks logged as they started, all
    # of them new processes (the records carry no rank ids here: the fault
    # wrapper forwards measure alone, as the reference's does)
    pids = res.fleet["rank_pids"]
    assert len(pids) == len(set(pids)) == 2 * (EPOCHS + 1 + EPOCHS)
    assert _no_rank_alive(pids)
    assert len(res.fleet["group_start_s"]) == EPOCHS + 1 + EPOCHS
    assert all(0 < s < 60 for s in res.fleet["group_start_s"])
    assert set(mp.active_children()) <= before


def test_sweep_on_two_pool_workers_over_real_collectives(serial, tmp_path):
    """The sweep's spawned pool workers are not daemonic: each starts its
    cell's rank groups. The same cells, fingerprints and case sets as the
    serial run, and no silent serial fallback."""
    spec, backend = _sweep()
    store = ResultStore(tmp_path / "sweep.jsonl")
    with _limit(90), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = SweepScheduler(spec, backend, store, n_workers=2).run()
    assert not [w for w in caught if "running serially" in str(w.message)]
    assert res.n_cells_measured == 2
    assert _cells(store, res.sweep_id) == serial
    pids = {pid for fp, _ in serial.values() for rec in store.records(fp)
            for pid in rec.meta["rank_pids"]}
    assert len(pids) == 2 * 2 * EPOCHS and _no_rank_alive(pids)


def test_a_pickled_backend_carries_no_group():
    """A backend with an open group pickles without it (its pipes and
    process handles stay here); the copy starts a group of its own, and
    the original's keeps running."""
    backend = TorchCollectiveBackend(
        n_ranks=2, device="cpu", meter=MeterConfig(epoch_isolation="none"))
    with _limit(60):
        try:
            ctx = backend.make_epoch(0)
            assert backend._group is not None and backend._group.alive
            copy = pickle.loads(pickle.dumps(backend))
            assert copy._group is None and copy == backend
            assert copy.measure(copy.make_epoch(0), TestCase("psum", 64), 2).size == 2
            assert not set(copy._group.pids) & set(backend._group.pids)
            copy.close()
            assert backend.measure(ctx, TestCase("psum", 64), 2).size == 2
        finally:
            backend.close()


def test_ranks_an_attempt_left_are_killed(tmp_path):
    """What the scheduler does once an attempt has ended: every logged
    rank still running is killed and waited for; a logged id whose start
    time differs (a later process that reuses it) is not a rank."""
    path = tmp_path / "a.ranks"
    stray = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
    try:
        start = ranks._proc_stat(stray.pid)[1]
        path.write_text(f"rank {stray.pid} {start}\ngroup 0.25\n")
        logged = [(stray.pid, start)]
        assert ranks.read_rank_log(path) == (logged, [0.25])
        assert ranks.read_rank_log(tmp_path / "none.ranks") == ([], [])
        assert rank_alive(stray.pid) and not rank_alive(stray.pid, "0")
        with _limit(30):
            assert _end_ranks(logged) == 1
        assert stray.wait(10) == -signal.SIGKILL and not rank_alive(stray.pid)
        assert _end_ranks(logged) == 0
    finally:
        stray.kill()
        stray.wait()
