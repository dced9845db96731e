"""The program's spans and counters (``repro_torch.core.telemetry``) on the
CPU: the span tree of a fused HCA campaign and of a walking-clock campaign
(p 8, HCA 20 x 5), the counters against counts made apart from them,
recording off, records unchanged by recording, the ranges in a
``torch.profiler`` trace, a fresh store for each recording, and a
per-epoch window's grids read back only on a caller's first read."""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import simengine
from repro_torch.campaign import Campaign, CampaignSpec, TorchSimBackend
from repro_torch.core import (ClockParams, ExperimentDesign, SimNet, TestCase, make_op,
                              make_sync, telemetry)

CASES = [TestCase("allreduce", 512), TestCase("bcast", 4096)]
NREP = 300

#: Where each span may open: the names its parent may have.
PARENTS = {
    "campaign": {None},
    "campaign.fused": {"campaign"},
    "campaign.epoch": {"campaign"},
    "campaign.analyze": {"campaign"},
    "sync": {"campaign.fused", "campaign.epoch"},
    "sync.net": {"sync"},
    "sync.hca.tree": {"sync"},
    "sync.hca.intercepts": {"sync"},
    "record": {"campaign.fused", "campaign.epoch"},
    "topup": {"record"},
    "engine.fused": {"campaign.fused"},
    "engine.window": {"record", "topup"},
    "engine.draw": {"engine.window", "engine.fused"},
    "engine.cumsum": {"engine.window", "engine.fused"},
    "engine.wait": {"engine.window", "engine.fused"},
    "engine.copy_out": {"engine.window", "engine.fused"},
    "drift.deadlines": {"engine.window"},
    "drift.reads": {"engine.window"},
    "drift.upload": {"engine.window"},
}


def _backend(walking=False, **kw):
    return TorchSimBackend(p=8, seed0=3, sync_kw=dict(n_fitpts=20, n_exchanges=5),
                           clock_kw=dict(rw_sigma=1e-7) if walking else {},
                           device="cpu", **kw)


def _campaign(walking=False, epochs=3, **kw):
    spec = CampaignSpec(CASES, ExperimentDesign(n_launch_epochs=epochs, nrep=NREP, seed=1),
                        name="telemetry")
    return Campaign(spec, _backend(walking, **kw)).run()


@pytest.fixture(scope="module", params=[False, True], ids=["fused-hca", "walking"])
def recorded(request):
    """A campaign run inside ``recording()``, and what it recorded."""
    with telemetry.recording():
        res = _campaign(walking=request.param)
    return request.param, res, telemetry.snapshot()


def test_span_tree_parents_ids_and_nesting(recorded):
    walking, res, snap = recorded
    spans = snap["spans"]
    names = {s["name"] for s in spans}
    want = {"campaign", "campaign.analyze", "sync", "sync.net", "sync.hca.tree",
            "sync.hca.intercepts", "record", "topup", "engine.draw", "engine.cumsum",
            "engine.wait", "engine.copy_out"}
    want |= ({"campaign.epoch", "engine.window", "drift.deadlines", "drift.reads",
              "drift.upload"} if walking else {"campaign.fused", "engine.fused"})
    assert names == want
    for i, s in enumerate(spans):
        parent = None if s["parent"] is None else spans[s["parent"]]
        assert (parent and parent["name"]) in PARENTS[s["name"]], s["name"]
        assert s["end_ns"] >= s["start_ns"] and s["self_ns"] >= 0
        assert s["ids"]["campaign"] == "telemetry"
        if parent is not None:
            assert s["parent"] < i
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]
            # a span carries its parent's identifiers
            assert parent["ids"].items() <= s["ids"].items()
    records = [s for s in spans if s["name"] == "record"]
    assert len(records) == len(res.records) == len(CASES) * 3
    got = sorted((s["ids"]["epoch"], s["ids"]["op"], s["ids"]["msize"]) for s in records)
    assert got == sorted((r.epoch, r.case.op, r.case.msize) for r in res.records)
    assert all(s["ids"]["fused"] is (not walking) for s in records)
    # a first window per record, outside the top-up, on the per-epoch path
    if walking:
        first = [s for s in spans if s["name"] == "engine.window"
                 and spans[s["parent"]]["name"] == "record"]
        assert len(first) == len(res.records)


def test_totals_are_the_spans_summed(recorded):
    _, _, snap = recorded
    for name, t in snap["totals"].items():
        mine = [s for s in snap["spans"] if s["name"] == name]
        assert t["count"] == len(mine)
        assert t["total_s"] == pytest.approx(sum(s["end_ns"] - s["start_ns"] for s in mine) / 1e9)
        assert t["self_s"] == pytest.approx(sum(s["self_ns"] for s in mine) / 1e9)
        assert 0.0 <= t["self_s"] <= t["total_s"] + 1e-12


def test_counters_match_the_records(recorded):
    walking, res, snap = recorded
    c = snap["counters"]
    assert c["records"] == len(res.records)
    assert c["records.empty"] == 0
    # every record holds its valid times, and no record is empty here
    assert c["records.valid_calls"] == sum(r.times.size for r in res.records)
    spans = snap["spans"]
    # each window, a fused epoch too, copies its outputs out once
    assert c["engine.windows"] == snap["totals"]["engine.copy_out"]["count"]
    assert c.get("engine.windows.topup", 0) == sum(
        s["name"] == "engine.window" and spans[s["parent"]]["name"] == "topup" for s in spans)
    assert c["engine.dispatches"] == res.meta["dispatch"]["n_dispatches"]


def test_an_empty_record_counts_no_valid_call():
    """A window far too small for the calls discards every call: each
    record is empty and adds nothing to ``records.valid_calls``."""
    with telemetry.recording():
        res = _campaign(epochs=2, win_size=1e-7)
    c = telemetry.snapshot()["counters"]
    assert c["records"] == c["records.empty"] == len(res.records) == 4
    assert c["records.valid_calls"] == 0
    # each record tried a first window and two top-ups
    assert c["engine.windows.topup"] == 2 * len(res.records)


def _fresh(walking):
    net = SimNet(8, clocks=ClockParams(rw_sigma=1e-7 if walking else 0.0), seed=11)
    sync = make_sync("hca", n_fitpts=20, n_exchanges=5).synchronize(net)
    return net, sync, make_op("allreduce")


@pytest.mark.parametrize("walking", [False, True], ids=["affine", "walking"])
def test_read_back_bytes_are_what_the_engine_returned(walking):
    """A window whose grids no one touches reads back its times, its flags
    and one ``(p,)`` row for ``net.t``, plus its carry, its prefix sum's
    trip and, on walking clocks, the per-rank peaks; ``engine.readbacks``
    counts each read once, and no grid is read."""
    net, sync, op = _fresh(walking)
    nrep, p, n = NREP, 8, simengine._bucket(NREP)
    with telemetry.recording():
        run = simengine.run_windowed_torch(net, sync, op, 512, nrep, 400e-6, device="cpu")
    c = telemetry.snapshot()["counters"]
    returned = run.times.nbytes + run.errors.nbytes + p * 8
    inner = 8 + 8 * (n - 1) + (2 * p * 8 if walking else 0)
    assert c["engine.d2h_bytes"] == returned + inner
    assert c["engine.readbacks"] == 3 + 2 + walking
    assert c.get("engine.grids.read", 0) == 0
    assert c["engine.windows"] == 1 and c["engine.dispatches"] == 2


@pytest.mark.parametrize("walking", [False, True], ids=["affine", "walking"])
def test_a_grid_is_read_back_once_on_first_access(walking, monkeypatch):
    """Each of the four grids is copied on its first read, one read-back of
    ``nrep * p * 8`` bytes and one ``engine.grids.read`` apiece, to the
    values an eager copy of the same ``_window`` outputs holds, bit for
    bit; a second read copies nothing."""
    window, outs = simengine._window, []

    def keep(*args, **kw):
        outs.append(window(*args, **kw))
        return outs[-1]

    monkeypatch.setattr(simengine, "_window", keep)
    net, sync, op = _fresh(walking)
    nrep, p = NREP, 8
    run = simengine.run_windowed_torch(net, sync, op, 512, nrep, 400e-6, device="cpu")
    eager = [simengine._to_host(x[:nrep]).copy() for x in outs[0][2:]]
    with telemetry.recording():
        for name, want in zip(simengine._GRIDS, eager):
            before = dict(telemetry.snapshot()["counters"])
            got = getattr(run, name)
            c = telemetry.snapshot()["counters"]
            assert c["engine.readbacks"] - before.get("engine.readbacks", 0) == 1
            assert c["engine.d2h_bytes"] - before.get("engine.d2h_bytes", 0) == nrep * p * 8
            assert c["engine.grids.read"] - before.get("engine.grids.read", 0) == 1
            assert got.shape == (nrep, p) and got.dtype == want.dtype
            assert np.array_equal(got, want)
            assert getattr(run, name) is got
            assert telemetry.snapshot()["counters"] == c
    assert telemetry.snapshot()["counters"]["engine.grids.read"] == 4
    assert run.__dict__["_on_device"] == {}      # every device tensor let go


@pytest.mark.parametrize("walking", [False, True], ids=["fused-hca", "walking"])
def test_a_campaign_reads_no_grid(walking, monkeypatch):
    """A campaign whose 30 us window discards calls, so that every record
    tops up, reads no grid back; reading every grid of every window as it
    returns, as the engine once did, changes none of its records."""
    with telemetry.recording():
        lazy = _campaign(walking, epochs=2, win_size=30e-6)
    c = telemetry.snapshot()["counters"]
    assert c["engine.windows.topup"] == 8 and c.get("engine.grids.read", 0) == 0
    assert 0 < c["records.valid_calls"] < 4 * NREP

    from repro_torch.campaign import backends
    rwt = backends.run_windowed_torch

    def eager_rwt(*args, **kw):
        run = rwt(*args, **kw)
        for name in simengine._GRIDS:
            getattr(run, name)
        return run

    monkeypatch.setattr(backends, "run_windowed_torch", eager_rwt)
    with telemetry.recording():
        eager = _campaign(walking, epochs=2, win_size=30e-6)
    c = telemetry.snapshot()["counters"]
    fused = 0 if walking else len(eager.records)     # a fused first window a record
    assert c["engine.grids.read"] == 4 * (c["engine.windows"] - fused) > 0
    assert len(lazy.records) == len(eager.records)
    for a, b in zip(lazy.records, eager.records):
        assert (a.case, a.epoch) == (b.case, b.epoch)
        assert a.times.dtype == b.times.dtype and np.array_equal(a.times, b.times)
        assert a.meta == b.meta


def test_fused_read_back_bytes_are_what_the_engine_returned():
    states = [_fresh(False) for _ in range(3)]
    nets, syncs, ops = ([s[k] for s in states] for k in range(3))
    n = simengine._bucket(NREP)
    with telemetry.recording():
        runs = simengine.run_windowed_epochs_torch(nets, syncs, ops, 512, NREP, 400e-6,
                                                   device="cpu")
    c = telemetry.snapshot()["counters"]
    returned = sum(r.times.nbytes + r.errors.nbytes for r in runs)
    inner = 3 * 8 + 3 * (8 * 8 + 8 * (n - 1))     # carries; end rows and prefix sums
    assert c["engine.d2h_bytes"] == returned + inner
    assert c["engine.readbacks"] == 1 + 3 * 4
    assert c["engine.windows"] == 3 and c["engine.dispatches"] == 4


def test_nothing_is_recorded_with_recording_off():
    telemetry.reset()
    before = telemetry.dispatches()
    res = _campaign(epochs=2)
    snap = telemetry.snapshot()
    assert snap == {"spans": [], "totals": {}, "counters": {}}
    # dispatches count regardless, and the campaign reports its share
    assert telemetry.dispatches() - before == res.meta["dispatch"]["n_dispatches"] > 0
    assert simengine.engine_stats() == {"n_dispatches": telemetry.dispatches()}


@pytest.mark.parametrize("walking", [False, True], ids=["fused-hca", "walking"])
def test_records_are_bit_identical_with_recording_on_and_off(walking):
    off = _campaign(walking, epochs=2)
    with telemetry.recording():
        on = _campaign(walking, epochs=2)
    assert len(off.records) == len(on.records)
    for a, b in zip(off.records, on.records):
        assert (a.case, a.epoch) == (b.case, b.epoch)
        assert a.times.dtype == b.times.dtype and np.array_equal(a.times, b.times)
        assert {k: v for k, v in a.meta.items()} == {k: v for k, v in b.meta.items()}
    assert off.meta == on.meta


def test_profiler_session_records_ranges_nested_in_call_order(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _campaign(epochs=2)
    snap = telemetry.snapshot()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith(telemetry.PREFIX)]
    events.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
    spans = snap["spans"]
    assert spans and [e["name"] for e in events] == [telemetry.PREFIX + s["name"]
                                                     for s in spans]
    for e, s in zip(events, spans):
        if s["parent"] is not None:
            up = events[s["parent"]]
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            assert float(up["ts"]) <= a and b <= float(up["ts"]) + float(up["dur"]) + 1e-3


def test_each_recording_starts_from_an_empty_store():
    with telemetry.recording():
        _campaign(epochs=2)
    first = telemetry.snapshot()
    assert first["counters"]["records"] == 4
    with telemetry.recording():
        telemetry.count("records")
        with telemetry.span("campaign", campaign="x"):
            pass
    second = telemetry.snapshot()
    assert second["counters"] == {"records": 1}
    assert [s["name"] for s in second["spans"]] == ["campaign"]
    # so does a profiler session that starts after a recording block
    with profile(activities=[ProfilerActivity.CPU]):
        telemetry.count("records", 2)
    assert telemetry.snapshot()["counters"] == {"records": 2}


def test_spans_off_the_main_thread_record_nothing():
    with telemetry.recording():
        with telemetry.span("campaign"):
            t = threading.Thread(target=lambda: telemetry.span("sync").__enter__())
            t.start()
            t.join(timeout=10)
    assert not t.is_alive()
    assert [s["name"] for s in telemetry.snapshot()["spans"]] == ["campaign"]


def test_the_wait_is_a_span_and_no_op_on_the_cpu():
    with telemetry.recording():
        simengine._wait(torch.device("cpu"))
    snap = telemetry.snapshot()
    assert [s["name"] for s in snap["spans"]] == ["engine.wait"] and not snap["counters"]
