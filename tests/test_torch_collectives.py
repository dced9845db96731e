"""``TorchCollectiveBackend`` (the port of ``JaxBackend``) on gloo ranks on
the CPU, held against the reference.

Outputs are compared exactly (integer-valued float32, so any difference
is a fault): the stacked per-rank outputs of four port ranks against
``JaxBackend(n_devices=4)._build_collective(op, msize)()``. Element counts
and shapes against the reference's at two mesh sizes. Composites, ``@half``
and the reference's parse errors. A two-epoch campaign on a fresh rank
group each epoch, whose store loads in both packages. Faults (a killed, a
raising and a hung rank) raise ``RuntimeError`` within the group's timeout
and leave no child process. No fallback: CUDA asked for and absent, NCCL
past one rank per device, cold buffers and a daemonic parent all raise
before any process starts. A calibration fit against the backend, and its
replay from the store, which starts no rank group."""

import multiprocessing as mp
import os
import signal
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.campaign import JaxBackend
from repro.campaign import ResultStore as RefResultStore
from repro_torch.calibrate import calibrate, default_space
from repro_torch.campaign import (Campaign, CampaignSpec, RankGroup, ResultStore,
                                  TorchCollectiveBackend, TorchSimBackend,
                                  ensure_ranks)
from repro_torch.campaign import ranks as ranks_mod
from repro_torch.campaign.backends import collective_count
from repro_torch.campaign.ranks import expected_collective
from repro_torch.core import ExperimentDesign, TestCase
from repro_torch.core.runtime_meter import MeterConfig

OPS = ("psum", "all_gather", "all_to_all")


def _no_new_children(before, deadline_s: float = 5.0) -> bool:
    """No child process is running but those in ``before`` (the module's
    shared group may be alive)."""
    t = time.monotonic()
    while set(mp.active_children()) - set(before):
        if time.monotonic() - t > deadline_s:
            return False
        time.sleep(0.05)
    return True


@pytest.fixture(scope="module")
def four():
    """One group of four gloo ranks for the per-op checks."""
    backend = TorchCollectiveBackend(
        n_ranks=4, device="cpu",
        meter=MeterConfig(epoch_isolation="none", warmup=1))
    ctx = backend.make_epoch(0)
    yield backend, ctx
    backend.close()


@pytest.mark.jaxdevices(4)
@pytest.mark.parametrize("msize", [1000, 4096])
@pytest.mark.parametrize("op", OPS)
def test_outputs_equal_the_reference_exactly(four, op, msize):
    backend, ctx = four
    ref = np.asarray(JaxBackend(n_devices=4)._build_collective(op, msize)())
    got = backend.outputs(ctx, TestCase(op, msize))
    port = np.stack([terms[0] for terms in got])
    assert port.shape == ref.shape and port.dtype == ref.dtype
    np.testing.assert_array_equal(port, ref)        # exact


@pytest.mark.jaxdevices(4)
@pytest.mark.parametrize("n", [2, 4])
def test_counts_and_shapes_equal_the_reference(n):
    backend = TorchCollectiveBackend(n_ranks=n, device="cpu")
    for msize in (1, 3, 512, 1000, 4096):
        for op in OPS:
            ref = JaxBackend(n_devices=n)._build_collective(op, msize)()
            [(name, count, tn)] = backend._build_case(op, msize)
            assert (name, tn) == (op, n)
            assert count == collective_count(msize, n, 4)
            assert count == max(n, int(np.ceil(np.ceil(msize / 4) / n)) * n)
            want = expected_collective(op, 0, n, count, torch.float32)
            assert tuple(want.shape) == ref.shape[1:], (op, msize)


@pytest.mark.jaxdevices(4)
def test_composites_and_half_mesh(four):
    backend, ctx = four
    both = backend.outputs(ctx, TestCase("psum+all_gather", 1024))
    count = collective_count(1024, 4, 4)
    for terms in both:
        np.testing.assert_array_equal(terms[0], np.full(count, 6.0, np.float32))
        np.testing.assert_array_equal(terms[1], np.repeat(
            np.arange(4, dtype=np.float32)[:, None], count, axis=1))
    # @half: ranks 0-1 as the reference's two-device psum, ranks 2-3 idle
    half = backend.outputs(ctx, TestCase("psum@half", 1024))
    ref = np.asarray(JaxBackend(n_devices=4)._build_collective("psum", 1024, n=2)())
    np.testing.assert_array_equal(np.stack([half[0][0], half[1][0]]), ref)
    assert half[2] == [None] and half[3] == [None]
    times = backend.measure(ctx, TestCase("psum@half", 1024), 3)
    local = ctx.local["psum@half@1024"][-1]
    assert times.dtype == np.float64 and times.shape == (3,) and np.all(times > 0)
    assert np.all(local[:2] > 0) and np.all(local[2:] == 0)
    np.testing.assert_array_equal(times, local.max(axis=0))
    meta = backend.record_meta(ctx, TestCase("psum@half", 1024))
    assert meta["dist_backend"] == "gloo" and len(meta["rank_pids"]) == 4
    assert meta["rank_skew_s"] >= 0 and meta["group_start_s"] > 0


@pytest.mark.jaxdevices(4)
def test_parse_errors_are_the_reference_s_and_send_nothing(four):
    backend, ctx = four
    ref = JaxBackend(n_devices=4)
    for case, match in (("psum#x", "implementation tags are not supported"),
                        ("bogus", "unknown collective 'bogus'")):
        with pytest.raises(ValueError, match=match) as ref_err:
            ref._build_case(case, 1024)
        with pytest.raises(ValueError, match=match) as port_err:
            backend.measure(ctx, TestCase(case, 1024), 1)
        assert str(port_err.value).split(": ", 1)[1] \
            == str(ref_err.value).split(": ", 1)[1]
    assert ctx.group.alive         # nothing reached a rank
    assert backend.measure(ctx, TestCase("psum", 64), 2).size == 2


def test_campaign_runs_each_epoch_on_a_fresh_group(tmp_path):
    spec = CampaignSpec(
        cases=[TestCase("psum", 1024), TestCase("all_to_all", 1024)],
        design=ExperimentDesign(n_launch_epochs=2, nrep_min=3, nrep_max=6,
                                rel_ci_target=0.5, seed=19),
        name="torch-collectives")
    store = ResultStore(tmp_path / "coll.jsonl")
    before = mp.active_children()
    with TorchCollectiveBackend(n_ranks=4, device="cpu") as backend:
        res = Campaign(spec, backend, store).run()
        assert backend._group is not None and backend._group.alive
    assert backend._group is None and _no_new_children(before)
    assert res.factors.mesh_shape == (4,) and res.factors.mesh_axes == ("i",)
    assert res.factors.sync_method == "barrier+max"
    pids = {}
    for rec in res.records:
        pids.setdefault(rec.epoch, set()).add(tuple(rec.meta["rank_pids"]))
    assert all(len(v) == 1 for v in pids.values())
    assert not set(pids[0].pop()) & set(pids[1].pop())    # fresh processes
    for loader in (ResultStore, RefResultStore):
        table = loader(tmp_path / "coll.jsonl").to_table(res.fingerprint)
        for case in spec.cases:
            med = table.medians(case)
            assert med.size == 2 and np.all(med > 0)


@pytest.mark.parametrize("fault", ["kill", "raise", "hang"])
def test_a_rank_fault_raises_within_the_timeout_and_leaves_no_child(fault):
    timeout = 4.0
    before = mp.active_children()
    group = RankGroup(2, device="cpu", timeout_s=timeout)
    group.build("psum", [("psum", 8, 2)], "float32")
    assert group.measure("psum", 2).shape == (2, 2)
    t = time.monotonic()
    if fault == "kill":
        os.kill(group.pids[1], signal.SIGKILL)      # between two measure calls
        group._procs[1].join(timeout)
        with pytest.raises(RuntimeError, match=r"rank 1 died \(exit code -9\) "
                                               "before 'measure'"):
            group.measure("psum", 2)
    elif fault == "raise":
        with pytest.raises(RuntimeError, match="rank [01] raised during 'build'") as err:
            group.build("bogus", [("bogus", 8, 2)], "float32")
        assert "Traceback" in str(err.value)
        assert "ValueError: unknown collective 'bogus'" in str(err.value)
    else:
        os.kill(group.pids[1], signal.SIGSTOP)
        with pytest.raises(RuntimeError, match=r"rank\(s\) \[0, 1\] past the "
                                               "deadline of 4 s on 'measure'"):
            group.measure("psum", 2)
    assert time.monotonic() - t < timeout + 5.0
    assert not group.alive
    assert _no_new_children(before)
    with pytest.raises(RuntimeError, match="closed group"):
        group.measure("psum", 1)


def test_no_fallback_and_nothing_started(monkeypatch):
    before = mp.active_children()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchCollectiveBackend(n_ranks=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RankGroup(2)
    with pytest.raises(ValueError, match="NCCL runs on CUDA tensors only"):
        TorchCollectiveBackend(n_ranks=2, device="cpu", dist_backend="nccl")
    with pytest.raises(ValueError, match="n_ranks must be given on the CPU"):
        TorchCollectiveBackend(device="cpu")
    with pytest.raises(ValueError, match="cold_buffers"):
        TorchCollectiveBackend(n_ranks=2, device="cpu",
                               meter=MeterConfig(cold_buffers=True))
    with pytest.raises(ValueError, match="dist_backend must be"):
        ensure_ranks(2, "cpu", "mpi")
    assert ensure_ranks(3, "cpu") == 3
    # one card: NCCL refuses a second rank, before anything starts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one device"):
        TorchCollectiveBackend(n_ranks=2, dist_backend="nccl")
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one device"):
        TorchCollectiveBackend(n_ranks=2)
    monkeypatch.undo()
    # a daemonic parent (a pool worker, a fleet attempt) cannot start ranks
    monkeypatch.setattr(ranks_mod.mp, "current_process",
                        lambda: SimpleNamespace(daemon=True))
    with pytest.raises(RuntimeError, match="daemonic process"):
        RankGroup(2, device="cpu")
    assert set(mp.active_children()) <= set(before)


def test_calibration_against_real_collectives_and_its_replay(tmp_path):
    space = default_space(
        base=TorchSimBackend(p=4, seed0=0, device="cpu",
                             sync_kw=dict(n_fitpts=60, n_exchanges=20)),
        names=["op.alpha"], latency_scale=100.0)
    cases = [TestCase(op, m) for op in ("psum", "all_gather") for m in (512, 4096)]
    kw = dict(cases=cases, design=ExperimentDesign(n_launch_epochs=6, nrep=10, seed=0),
              store=ResultStore(tmp_path / "calib.jsonl"), seed=0, max_rounds=2)

    def target():
        return TorchCollectiveBackend(n_ranks=4, device="cpu",
                                      meter=MeterConfig(epoch_isolation="none"))

    before = mp.active_children()
    with target() as real:
        result = calibrate(space, real, **kw)
    assert 1 <= len(result.rounds) <= 2 and np.isfinite(result.objective)
    lo, hi = space.params[0].lo, space.params[0].hi
    assert lo <= result.params["op.alpha"] <= hi
    assert result.verdict in ("EQUIVALENT", "INCONCLUSIVE", "DRIFTED")
    assert result.n_heldout_epochs == 2 and _no_new_children(before)

    with target() as again_target:
        again = calibrate(space, again_target, **kw)
        assert again_target._group is None          # no rank group started
    assert again.n_rounds_resumed == len(again.rounds) == len(result.rounds)
    assert again.params == result.params and again.objective == result.objective


def test_calibrate_example_fits_against_collectives(tmp_path):
    """``examples/calibrate_sim_torch.py --target collective`` on the CPU, cut
    to 2 ranks, 4 epochs, nrep 5 and one round: the fit completes and its
    target's records reload from the store."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "calibrate_sim_torch.py"
    spec = importlib.util.spec_from_file_location("calibrate_sim_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    fit = example.fit_collective("cpu", tmp_path, ranks=2, params=("op.alpha",),
                                 epochs=4, nrep=5, rounds=1)
    result = fit["result"]
    assert len(result.rounds) == 1 and np.isfinite(result.objective) and fit["wall"] > 0
    records = ResultStore(fit["store"]).records(result.target_fingerprint)
    assert sorted({(r.case.op, r.case.msize) for r in records}) == [
        ("all_gather", 512), ("all_gather", 4096), ("psum", 512), ("psum", 4096)]
    assert len(records) == 16
