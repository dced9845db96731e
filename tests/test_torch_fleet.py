"""The port's fault-tolerant fleet (``repro_torch.fleet``) on the CPU: the
counterpart of each fleet test of the JAX package (``tests/test_fleet.py``)
on ``TorchSimBackend(device="cpu")``, and the two packages held against
each other on the same inputs — the same fault decisions for every
``(seed, cell, attempt)``, the same lease-queue states under one
fake-clock script, and a port fleet store that the reference's store
reads with the same records and quarantine lines.

The headline invariant is the reference's: a fleet store under injected
faults (hard crashes in real worker processes, torn shard lines,
transient raises, stragglers) is record-identical to a serial no-fault
run, with quarantined cells excluded *and reported*. Workers fork from a
fork server, so each one pays no torch import; the leases here are still
seconds long, so no test depends on a worker starting within one.
"""

import os
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

import repro.fleet as ref_fleet
import repro_torch.fleet
from repro.campaign import ResultStore as RefStore
from repro.core import RetryPolicy as RefRetryPolicy
from repro_torch import simengine
from repro_torch.campaign import (Campaign, CampaignSpec, ResultStore,
                                  SweepScheduler, TorchSimBackend)
from repro_torch.core import (ExperimentDesign, MeasurementRecord, RetryPolicy,
                              TestCase)
from repro_torch.fleet import (CrashFault, FaultPlan, FaultyBackend,
                               FleetConfig, FleetScheduler, LeaseQueue,
                               TransientFault, merge_stores)
from repro_torch.fleet.faults import TORN_LINE
from repro_torch.fleet.queue import LEASED, PENDING, QUARANTINED
from repro_torch.fleet.scheduler import stop_worker_server, worker_context
from repro_torch.history import RunArchive
from repro_torch.sweeps import default_sim_sweep

FAST_SYNC = dict(n_fitpts=60, n_exchanges=20)


def _tiny_sweep(seed=0, axes=("tuning",), n_launch_epochs=2, nrep=8):
    return default_sim_sweep(seed=seed, axes=axes, msizes=(512,),
                             n_launch_epochs=n_launch_epochs, nrep=nrep,
                             device="cpu")


def _dump(store):
    """Every record of every campaign, exact times included — the
    bit-identity yardstick."""
    out = {}
    for fp in store.fingerprints():
        out[fp] = sorted(
            (r.case.op, r.case.msize, r.epoch,
             tuple(np.asarray(r.times, np.float64).tolist()))
            for r in store.records(fp))
    return out


class _FakeClock:
    """Deterministic clock for driving schedulers without real sleeps."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += max(float(s), 1e-4)


def _fast_fleet(**kw):
    clk = _FakeClock()
    kw.setdefault("n_workers", 1)
    kw.setdefault("clock", clk)
    kw.setdefault("sleep", clk.sleep)
    return FleetConfig(**kw)


def _sim(**kw):
    kw.setdefault("sync_kw", dict(FAST_SYNC))
    return TorchSimBackend(p=4, seed0=1, device="cpu", **kw)


# ---------------------------------------------------------------------------
# LeaseQueue: exact claim/heartbeat/expiry/backoff/quarantine schedules
# ---------------------------------------------------------------------------

def _queue(n=3, ttl=10.0, budget=3, seed=0, package="port"):
    cls, pol = ((LeaseQueue, RetryPolicy) if package == "port" else
                (ref_fleet.LeaseQueue, RefRetryPolicy))
    policy = pol(base=1.0, factor=2.0, max_delay=8.0, seed=seed)
    return cls([(i, f"fp{i}") for i in range(n)], lease_ttl=ttl,
               policy=policy, retry_budget=budget), policy


def test_queue_validation():
    with pytest.raises(ValueError, match="lease_ttl"):
        LeaseQueue([(0, "a")], lease_ttl=0)
    with pytest.raises(ValueError, match="retry_budget"):
        LeaseQueue([(0, "a")], lease_ttl=1, retry_budget=0)


def test_queue_claims_lowest_index_first_and_exhausts():
    q, _ = _queue(n=2)
    a = q.claim("w0", now=0.0)
    b = q.claim("w1", now=0.0)
    assert (a.index, b.index) == (0, 1)
    assert a.state == LEASED and a.worker == "w0"
    assert q.claim("w2", now=0.0) is None
    assert not q.finished()


def test_queue_heartbeat_extends_lease_and_expiry_fires_without_it():
    q, _ = _queue(ttl=10.0)
    t = q.claim("w0", now=0.0)
    assert q.expired(now=9.9) == []
    q.heartbeat(t.index, now=8.0)          # lease now runs to 18.0
    assert q.expired(now=15.0) == []
    assert [x.index for x in q.expired(now=18.0)] == [t.index]


def test_queue_release_requeues_behind_exact_backoff_gate():
    q, policy = _queue(n=1)
    t = q.claim("w0", now=0.0)
    assert q.release(t.index, now=100.0, error="crash") == PENDING
    gate = 100.0 + policy.delay(0, key=t.index)   # seeded, reproducible
    assert t.not_before == gate and t.attempts == 1
    assert q.claim("w1", now=gate - 1e-6) is None or gate == 100.0
    assert q.next_wake(now=100.0) == gate
    got = q.claim("w1", now=gate)
    assert got is t and t.worker == "w1"


def test_queue_stale_heartbeat_after_revocation_is_ignored():
    q, _ = _queue()
    t = q.claim("w0", now=0.0)
    q.release(t.index, now=5.0, error="lease expired")
    q.heartbeat(t.index, now=6.0)          # zombie worker phones home
    assert t.state == PENDING and t.lease_expires <= 10.0


def test_queue_quarantines_after_retry_budget():
    q, _ = _queue(n=1, budget=2)
    for k in range(2):
        t = q.claim("w0", now=float(k * 100))
        state = q.release(t.index, now=float(k * 100 + 1), error=f"e{k}")
    assert state == QUARANTINED and t.errors == ["e0", "e1"]
    assert q.finished() and q.claim("w1", now=1e9) is None
    assert [x.index for x in q.quarantined()] == [0]
    s = q.stats()
    assert s["n_quarantined"] == 1 and s["n_failed_attempts"] == 2


def test_queue_finished_and_next_wake():
    q, _ = _queue(n=2, ttl=5.0)
    a = q.claim("w0", now=0.0)
    q.complete(a.index)
    b = q.claim("w0", now=1.0)
    assert q.next_wake(now=1.0) == 6.0     # only the live lease's expiry
    q.complete(b.index)
    assert q.finished() and q.next_wake(now=1.0) is None


def _queue_view(q, now):
    tasks = [(t.index, t.fingerprint, t.state, t.attempts, t.not_before,
              t.worker, t.lease_expires, list(t.errors))
             for t in sorted(q.tasks.values(), key=lambda t: t.index)]
    return (tasks, q.stats(), q.next_wake(now), q.finished(),
            [t.index for t in q.expired(now)])


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_queue_script_equals_reference(seed):
    """One fake-clock script — claims, heartbeats, expiries, releases with
    seeded backoff, completions, quarantine — through both packages'
    queues: equal task states, ``stats()``, wake times and expiries after
    every step."""
    port, _ = _queue(n=4, ttl=3.0, budget=3, seed=seed)
    ref, _ = _queue(n=4, ttl=3.0, budget=3, seed=seed, package="ref")
    rng = np.random.default_rng(seed)
    now = 0.0
    for step in range(60):
        now += float(rng.uniform(0.0, 2.0))
        action = int(rng.integers(4))
        for q in (port, ref):
            if action == 0:
                q.claim(f"w{step}", now)
            elif action == 1:
                for t in q.by_state(LEASED)[:1]:
                    q.heartbeat(t.index, now)
            elif action == 2:
                for t in q.expired(now):
                    q.release(t.index, now, f"expired at step {step}")
            else:
                leased = q.by_state(LEASED)
                if leased and step % 3:
                    q.complete(leased[-1].index)
                elif leased:
                    q.release(leased[0].index, now, f"crash at step {step}")
        assert _queue_view(port, now) == _queue_view(ref, now), step
    assert port.stats()["n_failed_attempts"] > 0


# ---------------------------------------------------------------------------
# Fault injection: seeded, deterministic, fingerprint-transparent
# ---------------------------------------------------------------------------

def test_fault_plan_decides_deterministically_per_cell_attempt():
    plan = FaultPlan(seed=3, p_crash=0.5, p_raise=0.5)
    for cell in range(6):
        assert plan.decide(cell, 0) == plan.decide(cell, 0)
    assert any(plan.decide(c, 0) != FaultPlan(seed=4, p_crash=0.5,
                                              p_raise=0.5).decide(c, 0)
               for c in range(6))


def test_fault_plan_spares_attempts_past_the_faulty_budget():
    plan = FaultPlan(seed=0, p_crash=1.0, max_faulty_attempts=2)
    assert plan.decide(0, 0) and plan.decide(0, 1)
    assert plan.decide(0, 2) == [] and plan.decide(0, 99) == []


def test_fault_plan_validation_and_parse():
    with pytest.raises(ValueError, match="p_crash"):
        FaultPlan(p_crash=1.5)
    plan = FaultPlan.parse("crash=0.4,straggle=0.2,seed=7,within_calls=3,"
                           "torn_on_crash=false")
    assert plan == FaultPlan(seed=7, p_crash=0.4, p_straggle=0.2,
                             within_calls=3, torn_on_crash=False)
    with pytest.raises(ValueError, match="unknown key"):
        FaultPlan.parse("explode=1.0")
    with pytest.raises(ValueError, match="key=value"):
        FaultPlan.parse("crash")
    assert not FaultPlan().any_faults() and plan.any_faults()


@pytest.mark.parametrize("spec", [
    "crash=0.5,raise=0.3,seed=7",                                # CI chaos
    "crash=0.5,within_calls=1,max_faulty_attempts=99,seed=26",   # quarantine
    "crash=0.2,straggle=0.3,raise=0.4,torn=0.5,seed=3,within_calls=9,"
    "max_faulty_attempts=3",
])
def test_fault_plan_decisions_equal_reference(spec):
    """The CLI form parses to the same plan in both packages, and the plan
    decides the same faults for every (seed, cell, attempt)."""
    port, ref = FaultPlan.parse(spec), ref_fleet.FaultPlan.parse(spec)
    assert repr(port) == repr(ref)
    for seed in range(8):
        p = FaultPlan(**{**port.__dict__, "seed": seed})
        r = ref_fleet.FaultPlan(**{**ref.__dict__, "seed": seed})
        for cell in range(12):
            for attempt in range(4):
                assert [(f.kind, f.at_call) for f in p.decide(cell, attempt)] \
                    == [(f.kind, f.at_call) for f in r.decide(cell, attempt)]


def test_faulty_backend_is_fingerprint_transparent():
    design = ExperimentDesign(n_launch_epochs=2, nrep=5, seed=0)
    inner = _sim()
    fb = FaultyBackend(inner, FaultPlan(seed=0, p_crash=1.0), cell_index=0)
    assert fb.factors(design).fingerprint() == \
        inner.factors(design).fingerprint()
    assert fb.name == inner.name
    # the reference's surface: no fused capability, no record provenance
    assert not hasattr(fb, "measure_epochs") and not hasattr(fb, "record_meta")


def test_faulty_backend_injects_at_the_decided_call(tmp_path):
    case = TestCase("allreduce", 512)

    def fresh(plan, attempt=0, shard=None):
        fb = FaultyBackend(_sim(), plan, cell_index=0, attempt=attempt,
                           hard=False, shard_path=shard)
        return fb, fb.make_epoch(0)

    fb, ctx = fresh(FaultPlan(seed=0, p_crash=1.0, within_calls=1))
    with pytest.raises(CrashFault, match="cell 0, attempt 0, call 1"):
        fb.measure(ctx, case, 4)
    fb, ctx = fresh(FaultPlan(seed=0, p_raise=1.0, within_calls=1))
    with pytest.raises(TransientFault):
        fb.measure(ctx, case, 4)
    # past the faulty-attempt budget the same plan is a no-op, and the
    # measured values are the inner backend's exactly
    fb, ctx = fresh(FaultPlan(seed=0, p_crash=1.0, within_calls=1),
                    attempt=1)
    ref, rctx = fresh(FaultPlan(seed=0))
    np.testing.assert_array_equal(fb.measure(ctx, case, 4),
                                  ref.measure(rctx, case, 4))
    # torn writes land newline-terminated garbage in the shard
    shard = tmp_path / "shard.jsonl"
    fb, ctx = fresh(FaultPlan(seed=0, p_torn=1.0, within_calls=1),
                    shard=str(shard))
    fb.measure(ctx, case, 4)
    assert shard.read_text().startswith(TORN_LINE)
    assert shard.read_text().endswith("\n")


# ---------------------------------------------------------------------------
# Store federation
# ---------------------------------------------------------------------------

def _store_with_records(path, n=3, fp="fp-test"):
    store = ResultStore(path)
    store._append(dict(kind="campaign", fingerprint=fp, factors={}, spec={}))
    for e in range(n):
        store.append_record(fp, MeasurementRecord(
            case=TestCase("allreduce", 512), epoch=e,
            times=np.array([1.0 + e, 2.0 + e])))
    return store, fp


def _campaign_into(path, backend, design, cases, name):
    store = ResultStore(path)
    res = Campaign(CampaignSpec(list(cases), design, name=name),
                   backend, store).run()
    return store, res


def test_merge_stores_is_idempotent_and_complete(tmp_path):
    spec, backend = _tiny_sweep()
    compiled = SweepScheduler(spec, backend).compile()
    shards = []
    for cell, b, design, _, fp in compiled:
        store, _ = _campaign_into(tmp_path / f"shard{cell.index}.jsonl",
                                  b, design, spec.cases, f"cell{cell.index}")
        shards.append((store, fp))

    dest = ResultStore(tmp_path / "fed.jsonl")
    stats = merge_stores(dest, [s for s, _ in shards])
    assert stats.n_campaigns == len(shards)
    assert stats.n_records == sum(len(s.records(fp)) for s, fp in shards)
    assert stats.n_duplicates == 0
    for s, fp in shards:
        assert _dump(dest)[fp] == _dump(s)[fp]
    # replaying the merge (a crashed-compaction recovery) is a no-op
    again = merge_stores(dest, [s for s, _ in shards])
    assert again.merged_nothing()
    assert again.n_duplicates == stats.n_records
    # the reference's merge of the same shards writes the same records
    ref_dest = RefStore(tmp_path / "fed-ref.jsonl")
    ref_fleet.merge_stores(ref_dest, [RefStore(s.path) for s, _ in shards])
    assert _dump(ref_dest) == _dump(dest)


def test_merge_stores_rejects_self_merge_and_counts_corruption(tmp_path):
    store, fp = _store_with_records(tmp_path / "a.jsonl")
    with pytest.raises(ValueError, match="among its own shards"):
        merge_stores(store, [store])
    raw = (tmp_path / "a.jsonl").read_bytes()
    (tmp_path / "a.jsonl").write_bytes(raw[:-15])       # torn shard tail
    dest = ResultStore(tmp_path / "b.jsonl")
    with pytest.warns(RuntimeWarning, match="undecodable"):
        stats = merge_stores(dest, [store])
    assert stats.n_corrupt == 1
    assert len(dest.records(fp)) == 2                   # intact lines merged


def test_archive_records_corruption_and_resolves_merged_baselines(tmp_path):
    """RunEntry carries n_corrupt, and baseline_for resolves a federated
    (merged-shard) candidate against a plain single-campaign baseline via
    their shared factor fingerprint."""
    spec, backend = _tiny_sweep()
    (c0, b0, d0, _, fp0), (c1, b1, d1, _, fp1) = \
        SweepScheduler(spec, backend).compile()
    arch = RunArchive(tmp_path / "arch")
    arch.root.mkdir(parents=True)

    base_store, _ = _campaign_into(arch.root / "base.jsonl", b0, d0,
                                   spec.cases, "cellA")
    base = arch.register(base_store.path, tag="reference")
    assert base.n_corrupt == 0

    s0, _ = _campaign_into(tmp_path / "h0.jsonl", b0, d0, spec.cases, "cellA")
    s1, _ = _campaign_into(tmp_path / "h1.jsonl", b1, d1, spec.cases, "cellB")
    fed = ResultStore(arch.root / "fed.jsonl")
    merge_stores(fed, [s0, s1])
    # tear the federated store's tail: registration must record the damage
    raw = fed.path.read_bytes()
    fed.path.write_bytes(raw + b'{"kind": "record", "fin')
    with pytest.warns(RuntimeWarning, match="n_corrupt"):
        cand = arch.register(fed.path)
    assert cand.n_corrupt == 1
    assert arch.entry(cand.run_id).n_corrupt == 1       # manifest round-trip
    assert set(cand.fingerprints) == {fp0, fp1}
    resolved = arch.baseline_for(cand)
    assert resolved is not None and resolved.run_id == base.run_id


# ---------------------------------------------------------------------------
# FleetScheduler, in-process mode: equivalence, quarantine, recovery
# ---------------------------------------------------------------------------

def _serial_reference(tmp, spec, backend):
    store = ResultStore(tmp / "serial.jsonl")
    SweepScheduler(spec, backend, store, n_workers=1).run()
    return _dump(store)


def test_inprocess_fleet_matches_serial_without_faults(tmp_path):
    spec, backend = _tiny_sweep(axes=("tuning", "dtype"))
    ref = _serial_reference(tmp_path, spec, backend)
    store = ResultStore(tmp_path / "fleet.jsonl")
    res = FleetScheduler(spec, backend, store, _fast_fleet()).run()
    assert res.n_cells_measured == 4 and not res.quarantined
    assert res.fleet["start_method"] == "in-process"
    assert _dump(store) == ref
    # and a re-run is a pure resume
    res2 = FleetScheduler(spec, backend, store, _fast_fleet()).run()
    assert res2.n_cells_measured == 0 and res2.n_cells_resumed == 4


def test_inprocess_fleet_matches_serial_under_soft_faults(tmp_path):
    """Every cell's first attempt crashes (soft) — the retries converge to
    records bit-identical to the serial no-fault run. The serial run is
    fused and the faulted one per epoch (the fault wrapper forwards
    ``measure`` only), so this also holds the two engines equal."""
    spec, backend = _tiny_sweep(axes=("tuning", "dtype"))
    ref = _serial_reference(tmp_path, spec, backend)
    store = ResultStore(tmp_path / "fleet.jsonl")
    plan = FaultPlan(seed=0, p_crash=1.0, within_calls=1)
    res = FleetScheduler(spec, backend, store,
                         _fast_fleet(faults=plan)).run()
    assert not res.quarantined
    assert res.fleet["n_failed_attempts"] == 4    # one crash per cell
    assert _dump(store) == ref
    assert {r.meta.get("fused") for fp in store.fingerprints()
            for r in store.records(fp)} == {None}


def _quarantine_run(tmp_path):
    spec, backend = _tiny_sweep(axes=("tuning", "dtype"))
    ref = _serial_reference(tmp_path, spec, backend)
    compiled = SweepScheduler(spec, backend).compile()
    fps = {cell.index: fp for cell, *_, fp in compiled}
    store = ResultStore(tmp_path / "fleet.jsonl")
    plan = FaultPlan.parse(
        "crash=0.5,within_calls=1,max_faulty_attempts=99,seed=26")
    with pytest.warns(RuntimeWarning, match="quarantining sweep cell"):
        res = FleetScheduler(spec, backend, store,
                             _fast_fleet(faults=plan)).run()
    return spec, backend, ref, fps, store, res


def test_inprocess_fleet_quarantines_and_reports_poisoned_cells(tmp_path):
    """Seed 26 crashes cells 0 and 2 on *every* attempt: they quarantine
    (durably, with attempts and error), the others complete, and the
    surviving records still match the serial run — partial but honest."""
    spec, backend, ref, fps, store, res = _quarantine_run(tmp_path)
    assert set(res.quarantined) == {0, 2} and res.degraded()
    for idx, info in res.quarantined.items():
        assert info["fingerprint"] == fps[idx]
        assert info["attempts"] == 3 and "CrashFault" in info["error"]
    assert sorted(c.cell.index for c in res.cells) == [1, 3]
    # the quarantine is durable and survives a fresh parse
    assert set(store.sweep_cells_failed(res.sweep_id)) == {0, 2}
    # all-or-nothing attempts: a quarantined cell leaves NO partial records
    got = _dump(store)
    for idx in (0, 2):
        assert fps[idx] not in got
    for idx in (1, 3):
        assert got[fps[idx]] == ref[fps[idx]]

    # recovery: resume without faults — quarantined cells are re-attempted,
    # success supersedes the quarantine, and the store now matches serial
    res2 = FleetScheduler(spec, backend, store, _fast_fleet()).run()
    assert res2.n_cells_measured == 2 and res2.n_cells_resumed == 2
    assert not res2.quarantined
    assert store.sweep_cells_failed(res2.sweep_id) == {}
    assert _dump(store) == ref


def test_port_fleet_store_loads_in_the_reference(tmp_path):
    """A port fleet store is a reference store: the reference's loader
    reads the same records, sweep markers and quarantine lines."""
    *_, store, res = _quarantine_run(tmp_path)
    ref = RefStore(store.path)
    assert _dump(ref) == _dump(store)
    assert ref.sweeps() == store.sweeps() == [res.sweep_id]
    assert ref.sweep_cells_failed(res.sweep_id) \
        == store.sweep_cells_failed(res.sweep_id)
    assert set(ref.sweep_cells_failed(res.sweep_id)) == {0, 2}
    assert ref.sweep_cells(res.sweep_id) == store.sweep_cells(res.sweep_id)
    assert ref.snapshot().n_corrupt == store.snapshot().n_corrupt == 0


def test_fleet_requires_a_store():
    spec, backend = _tiny_sweep()
    with pytest.raises(ValueError, match="store is required"):
        FleetScheduler(spec, backend, None, _fast_fleet())


# ---------------------------------------------------------------------------
# FleetScheduler, multi-process chaos mode: the headline invariant
# ---------------------------------------------------------------------------

def test_fleet_exports_the_reference_names():
    assert repro_torch.fleet.__all__ == ref_fleet.__all__


def test_workers_fork_from_a_fork_server_that_preloads_torch():
    """A worker never forks the scheduler (which may hold a CUDA context):
    it forks from a fresh interpreter that imported torch and the port,
    and the server can be stopped (a later fleet starts another)."""
    from multiprocessing import forkserver
    ctx = worker_context()
    assert ctx.get_start_method() == "forkserver"
    assert {"torch", "repro_torch.fleet.scheduler"} \
        <= set(forkserver._forkserver._preload_modules)
    proc = ctx.Process(target=os.getppid)
    proc.start()
    proc.join(60)
    assert proc.exitcode == 0
    server = forkserver._forkserver._forkserver_pid
    assert server is not None and server != os.getpid()
    stop_worker_server()
    assert forkserver._forkserver._forkserver_pid is None


def test_chaos_fleet_store_is_record_identical_to_serial(tmp_path):
    """Three workers under the CI chaos spec — real SIGKILL-equivalent
    ``os._exit`` mid-cell, torn shard tails included, and transient
    raises: the merged fleet store must be record-identical to the serial
    no-fault run, with zero quarantines and no silent serial fallback
    (nothing is measured in this process)."""
    spec, backend = _tiny_sweep(axes=("tuning", "dtype"), n_launch_epochs=2,
                                nrep=8)
    ref = _serial_reference(tmp_path, spec, backend)
    store = ResultStore(tmp_path / "chaos.jsonl")
    plan = FaultPlan.parse("crash=0.5,raise=0.3,seed=7,within_calls=2")
    cfg = FleetConfig(n_workers=3, lease_ttl=5.0, poll_s=0.02, faults=plan)
    before = simengine.engine_stats()["n_dispatches"]
    res = FleetScheduler(spec, backend, store, cfg).run()
    assert simengine.engine_stats()["n_dispatches"] == before
    assert not res.quarantined
    assert res.n_cells_measured == 4
    assert res.fleet["n_failed_attempts"] >= 1    # chaos actually struck
    assert res.fleet["start_method"] == "forkserver"
    assert 0 < res.fleet["first_heartbeat_s"] < cfg.lease_ttl
    # heartbeats are file times the scheduler polls: touches between two
    # polls read as one
    assert res.fleet["n_heartbeats"] >= 1
    assert _dump(store) == ref
    shard_dir = store.path.parent / (store.path.stem + "-shards")
    assert not shard_dir.exists()                 # shards were compacted


def test_fleet_survivable_torn_shard_lines_are_counted(tmp_path):
    """A torn line written *into* a successful worker's shard is skipped
    (with a warning) at merge time and surfaces in the fleet stats, not in
    the merged data."""
    spec, backend = _tiny_sweep(axes=("tuning",), n_launch_epochs=2, nrep=8)
    ref = _serial_reference(tmp_path, spec, backend)
    store = ResultStore(tmp_path / "torn.jsonl")
    plan = FaultPlan(seed=1, p_torn=1.0, within_calls=2)
    cfg = FleetConfig(n_workers=2, lease_ttl=5.0, poll_s=0.02, faults=plan)
    with pytest.warns(RuntimeWarning, match="undecodable"):
        res = FleetScheduler(spec, backend, store, cfg).run()
    assert res.fleet["n_corrupt_shard_lines"] == 2   # one per cell
    assert _dump(store) == ref                       # data unharmed


def test_fleet_straggler_loses_lease_and_cell_is_rerun(tmp_path):
    """A worker stalled past the lease TTL is killed and its cell re-run:
    the sweep completes correctly without waiting out the stall. The TTL
    is 3 s (the reference's test uses 0.8 s) so that a worker slowed by a
    loaded host still reaches its first record inside its lease."""
    spec, backend = _tiny_sweep(axes=("tuning",), n_launch_epochs=2, nrep=8)
    ref = _serial_reference(tmp_path, spec, backend)
    store = ResultStore(tmp_path / "straggle.jsonl")
    plan = FaultPlan(seed=3, p_straggle=1.0, straggle_s=60.0,
                     within_calls=2)
    cfg = FleetConfig(n_workers=2, lease_ttl=3.0, poll_s=0.05, faults=plan)
    t0 = time.time()
    res = FleetScheduler(spec, backend, store, cfg).run()
    assert time.time() - t0 < 40                  # did not wait out 60 s
    assert not res.quarantined
    assert res.fleet["n_failed_attempts"] >= 1    # a lease actually expired
    assert _dump(store) == ref


# ---------------------------------------------------------------------------
# Property: any byte prefix of the sweep store resumes identically,
# even with an active fault plan
# ---------------------------------------------------------------------------

_PREFIX_REF: dict = {}


def _prefix_reference():
    if not _PREFIX_REF:
        d = Path(tempfile.mkdtemp())
        spec, backend = _tiny_sweep()
        store = ResultStore(d / "ref.jsonl")
        SweepScheduler(spec, backend, store, n_workers=1).run()
        _PREFIX_REF["raw"] = store.path.read_bytes()
        _PREFIX_REF["dump"] = _dump(store)
    return _PREFIX_REF["raw"], _PREFIX_REF["dump"]


def _check_prefix_resume(cut: int):
    raw, ref = _prefix_reference()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "cut.jsonl"
        path.write_bytes(raw[:cut])
        spec, backend = _tiny_sweep()
        plan = FaultPlan(seed=5, p_crash=1.0, within_calls=1)
        store = ResultStore(path)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # torn-tail warnings expected
            res = FleetScheduler(spec, backend, store,
                                 _fast_fleet(faults=plan)).run()
        assert not res.quarantined
        assert _dump(ResultStore(path)) == ref


def test_sampled_byte_prefixes_resume_identically_under_faults():
    """Cut the sweep's JSONL at 0, mid-file bytes (mid-line included), one
    byte shy of the end, and the full length — every prefix, resumed
    through the fleet scheduler with crash faults active, converges to the
    identical serial store."""
    raw, _ = _prefix_reference()
    rng = np.random.default_rng(0)
    cuts = {0, len(raw), len(raw) - 1,
            *(int(c) for c in rng.integers(1, len(raw), size=5))}
    for cut in sorted(cuts):
        _check_prefix_resume(cut)


@settings(max_examples=6, deadline=None)
@given(st.integers(min_value=0, max_value=10 ** 6))
def test_any_byte_prefix_resumes_identically_under_faults(nonce):
    """Property form (hypothesis, when installed): an *arbitrary* byte
    prefix of the sweep store resumes identically under an active fault
    plan."""
    raw, _ = _prefix_reference()
    _check_prefix_resume(nonce % (len(raw) + 1))


def test_sim_scan_is_built_before_workers_on_the_card(monkeypatch):
    """A cell on "cuda" makes the scheduler build and load ``sim_scan``
    itself, before any worker starts (a worker running nvcc would lose
    its lease); cells on the CPU build nothing."""
    from types import SimpleNamespace

    from repro_torch.fleet import scheduler
    from repro_torch.kernels.sim_scan import kernel

    loads = []
    monkeypatch.setattr(kernel, "load_kernel", lambda: loads.append(1))
    scheduler._prepare_kernels([(None, SimpleNamespace(device="cpu"))])
    assert loads == []
    scheduler._prepare_kernels([(None, SimpleNamespace(device="cpu")),
                                (None, SimpleNamespace(device="cuda:0"))])
    assert loads == [1]
