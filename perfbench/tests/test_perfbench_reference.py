"""The frozen plain reference against the program at a tiny size on the
CPU, its float32 control, and the faults the check has to catch: each
planted in the program under a whole run, which must come out not
correct."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench import control
from perfbench.check import verdict
from perfbench.reference.cluster import Cluster, hca
from perfbench.reference.engine import Epoch
from perfbench.systems.sim_campaign import System
from perfbench.tests.tiny import run_tiny, tiny

CLOCKS = [0.0, 1e-7]


@pytest.mark.parametrize("p", [8, 12])
@pytest.mark.parametrize("rw", CLOCKS)
def test_reference_hca_equals_the_programs_bit_for_bit(p, rw):
    from repro_torch.core.simnet import ClockParams, SimNet
    from repro_torch.core.sync import make_sync

    cfg = tiny("hca512-long")[1]
    clocks = dict(cfg["clocks"], rw_sigma=rw)
    net = SimNet(p, clocks=ClockParams(**clocks), seed=2**31 + 3)
    got = make_sync("hca", n_fitpts=20, n_exchanges=5).synchronize(net)
    cl = Cluster(p, cfg["net"], clocks, seed=2**31 + 3)
    ref = hca(cl, 20, 5)
    assert [m.slope for m in got.models] == ref.slope.tolist()
    assert [m.intercept for m in got.models] == ref.intercept.tolist()
    assert got.initial_times == ref.init.tolist()
    assert net.t.tolist() == cl.t.tolist()


@pytest.mark.parametrize("rw", CLOCKS)
@pytest.mark.parametrize("nrep", [300, 1100])
def test_reference_record_matches_the_programs(rw, nrep):
    from repro_torch.core import TestCase

    w, cfg, traffic, _ = tiny("hca512-long")
    cfg["clocks"]["rw_sigma"] = rw
    system = System(cfg, traffic, 0, "cpu", None)
    backend = system.backend(seed0=12345)
    ctx = backend.make_epoch(1)
    ref = Epoch(cfg, 12345, 1, "cpu")
    for op in ("alltoall", "allreduce"):
        times = backend.measure(ctx, TestCase(op, 4096), nrep)
        _, rec = ref.measure(op, 4096, nrep)
        assert times.shape == rec.shape
        np.testing.assert_allclose(times, rec, rtol=1e-12, atol=0)
    np.testing.assert_allclose(ctx.net.t, ref.cl.t, rtol=1e-14, atol=0)


@pytest.mark.parametrize("name", ["hca512-long", "drift512-paper", "hca512-paper"])
def test_float32_control_fails_the_check(name):
    _, cfg, traffic, _ = tiny(name)
    nums = control.readings(cfg, traffic, seed=3, campaigns=1, device="cpu")
    assert nums["epochs_checked"] == 2
    assert not verdict(nums, cfg["limits"])
    # at this size float32 keeps every flag; the fit and the times show it
    assert nums["sync_gap"] > cfg["limits"]["sync_gap"], nums
    assert nums["time_gap"] > cfg["limits"]["time_gap"], nums


def _scaled_times(orig):
    def window(*args, **kw):
        times, *rest = orig(*args, **kw)
        return (times * (1.0 + 1e-3), *rest)
    return window


def _half_the_ranks(orig):
    def window(*args, **kw):
        times, errors, sg, eg, st, et = orig(*args, **kw)
        h = sg.shape[1] // 2
        return (eg[:, :h].amax(dim=1) - sg[:, :h].amin(dim=1), errors, sg, eg, st, et)
    return window


def _clock_left_unchanged(orig):
    def engine(*args, **kw):
        nets = args[0] if isinstance(args[0], list) else [args[0]]
        before = [net.t.copy() for net in nets]
        out = orig(*args, **kw)
        for net, t in zip(nets, before):
            net.t[:] = t
        return out
    return engine


def _no_top_up(orig):
    def top_up(self, ctx, op, msize, nrep, runs):
        return runs[0].valid_times
    return top_up


FAULTS = {
    "answer altered where produced": [("simengine", "_window", _scaled_times)],
    "half of the ranks left out": [("simengine", "_window", _half_the_ranks)],
    "state returned unchanged": [("backends", "run_windowed_torch", _clock_left_unchanged),
                                 ("backends", "run_windowed_epochs_torch", _clock_left_unchanged)],
    "top-ups left out": [("TorchSimBackend", "_top_up", _no_top_up)],
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["hca512-long", "drift512-paper"])
def test_a_planted_fault_makes_the_run_not_correct(monkeypatch, fault, name):
    from repro_torch import simengine
    from repro_torch.campaign import TorchSimBackend, backends

    where = {"simengine": simengine, "backends": backends, "TorchSimBackend": TorchSimBackend}
    for obj, attr, make in FAULTS[fault]:
        monkeypatch.setattr(where[obj], attr, make(getattr(where[obj], attr)))
    res = run_tiny(name, seed=11, seconds=0.1)
    assert not res["correct"], (fault, res["checks"])

