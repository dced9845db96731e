"""A cell of a new kind arrives as files: its configuration names its
system module, which brings its own check, limits, run summary and CPU
cut, and the reference's clock sync is found by the configuration's
``sync``. A second system module, kept beside these tests, runs through
the whole harness; a name that finds no module or no sync, and a number
without a limit, end the run with no result."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from perfbench.check import verdict
from perfbench.reference import engine
from perfbench.reference.cluster import Cluster, hca
from perfbench.systems import sim_campaign
from perfbench.tests import sort_system
from perfbench.tests.tiny import BENCH, ROOT, SIM_CELLS, harness, tiny

SORT_CELL = ({"name": "sort.tiny", "config": "sort", "traffic": "rows", "chips": 1},
             {"name": "sort", "system": "sort_system", "rows": 512, "n": 4096,
              "limits": {"sort_gap": 0.0}},
             {"name": "rows"},
             {"end_to_end": [m for m in BENCH["end_to_end"]
                             if m["name"] in ("valid_meas_per_s", "setup_s")],
              "per_layer": []})


def _run_sort(cfg=None, seconds=0.05):
    w, cfg0, traffic, metrics = SORT_CELL
    cfg, traffic = sort_system.System.tiny(cfg or cfg0, traffic)
    return harness.execute(w, cfg, traffic, metrics, seed=2**31 + 21, seconds=seconds,
                           trace=False, device="cpu", system=sort_system,
                           tolerate=frozenset(harness.blocked_modules()))


def test_a_second_system_runs_through_the_harness(capsys):
    res = _run_sort()
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"] == {"sort_gap": {"value": 0.0, "limit": 0.0}}
    assert list(res["run"]) == ["wall_s", "batches", "check_s", "setup_parts",
                                "batches_checked"]
    assert res["run"]["batches_checked"] == res["run"]["batches"] >= 1
    assert set(res["run"]["setup_parts"]) == {"imports", "warm"}
    assert set(res["metrics"]) == {"valid_meas_per_s", "setup_s"}
    assert list(res)[-1] == "checks"
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1] == "check sort_gap 0.0 limit 0.0"


def test_a_wrong_answer_of_the_second_system_is_not_correct(monkeypatch):
    sort = sort_system.sort_rows

    def one_swapped(x):
        y = sort(x).clone()
        y[0, [0, 1]] = y[0, [1, 0]]
        return y

    monkeypatch.setattr(sort_system, "sort_rows", one_swapped)
    res = _run_sort()
    assert res["correct"] is False and res["checks"]["sort_gap"]["value"] > 0


def test_a_number_without_a_limit_never_passes(capsys):
    cfg = dict(SORT_CELL[1], limits={})
    with pytest.raises(SystemExit) as e:
        _run_sort(cfg)
    out = capsys.readouterr()
    assert e.value.code != 0 and out.out == "" and "no limit for sort_gap" in out.err
    with pytest.raises(KeyError):
        verdict({"sort_gap": 0.0}, {}, ("sort_gap",))
    assert not verdict({"sort_gap": float("nan")}, {"sort_gap": 1.0}, ("sort_gap",))
    assert verdict({"sort_gap": 0.0}, {"sort_gap": 0.0}, ("sort_gap",))


@pytest.mark.parametrize("reported", [None, 123456789])
def test_a_system_module_may_report_the_peak_of_its_ranks(monkeypatch, reported):
    """A module whose ranks allocate in processes of their own reports their
    peak; without it the line has the harness's own (none on the CPU)."""
    run = sort_system.System.run

    def with_peak(self, seconds):
        out = run(self, seconds)
        if reported is not None:
            out["memory_peak_bytes"] = reported
        return out

    monkeypatch.setattr(sort_system.System, "run", with_peak)
    res = _run_sort()
    assert res["correct"] is True
    assert res["device"]["memory_peak_bytes"] == (reported or 0)
    assert "memory_peak_bytes" not in res["run"]


# The second system module run in a fresh process, where no other test has
# loaded anything: ``System.check`` or ``System.summary`` loads a stub of the
# JAX package, as a reference or a driver that imported it would.
LATE = r"""
import json, sys, types
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
from perfbench import run as harness
from perfbench.tests import sort_system

where = sys.argv[2]
if where != "none":
    method = getattr(sort_system.System, where)

    def loads_repro(*args):
        sys.modules["repro"] = types.ModuleType("repro")
        return method(*args)

    setattr(sort_system.System, where,
            loads_repro if where == "check" else staticmethod(loads_repro))
w = {"name": "sort.tiny", "config": "sort", "traffic": "rows", "chips": 1}
cfg, traffic = sort_system.System.tiny({"name": "sort", "limits": {"sort_gap": 0.0}}, {})
res = harness.execute(w, cfg, traffic, {"end_to_end": [], "per_layer": []}, 5, 0.05, False,
                      device="cpu", system=sort_system)
print(json.dumps(res))
"""


@pytest.mark.parametrize("where", ["check", "summary", "none"])
def test_a_blocked_module_loaded_after_the_window_fails_the_run(where):
    """The JAX package loaded by the check or the summary, after the window,
    fails the run: exit 5 and no result line. Without it the run prints one."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", LATE, str(ROOT), where], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    if where == "none":
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True
    else:
        assert proc.returncode == 5 and '"correct"' not in proc.stdout, proc.stderr[-3000:]
        assert "were loaded: repro" in proc.stderr


@pytest.mark.parametrize("key,name", [("system", "no_such_system"), ("system", "../check"),
                                      ("sync", "jk"), ("sync", "no_such_sync")])
def test_an_unknown_name_ends_the_run_with_no_result(capsys, key, name):
    w, cfg, traffic, metrics = tiny("hca512-paper")
    cfg[key] = name
    with pytest.raises((SystemExit, ValueError)) as e:
        harness.execute(w, cfg, traffic, metrics, seed=5, seconds=0.05, trace=False,
                        device="cpu", tolerate=frozenset(harness.blocked_modules()))
    out = capsys.readouterr()
    assert out.out == ""
    if key == "system":
        assert e.value.code != 0 and "no system" in out.err
    else:
        assert "the reference has no sync" in str(e.value)


def test_the_default_system_is_the_simulator():
    assert harness.system_module({}) is sim_campaign
    assert harness.system_module({"system": "sim_campaign"}) is sim_campaign
    assert sim_campaign.NUMBERS == ("sync_gap", "time_gap")


def test_the_reference_finds_a_sync_by_name(monkeypatch):
    calls = []

    def sync(cl, cfg, dtype=np.float64):
        calls.append(cfg["sync"])
        return hca(cl, cfg["n_fitpts"], cfg["n_exchanges"], dtype=dtype)

    monkeypatch.setitem(sys.modules, "perfbench.reference.sync_hcacopy",
                        types.SimpleNamespace(sync=sync))
    cfg = tiny("hca512-long")[1]
    ref = engine.Epoch(cfg, 7, 1, "cpu")
    got = engine.Epoch(dict(cfg, sync="hcacopy"), 7, 1, "cpu")
    assert calls == ["hcacopy"]
    assert got.sync.slope.tolist() == ref.sync.slope.tolist()
    assert got.sync.intercept.tolist() == ref.sync.intercept.tolist()
    plain = hca(Cluster(cfg["p"], cfg["net"], cfg["clocks"], seed=7 + 1000), 20, 5)
    assert ref.sync.slope.tolist() == plain.slope.tolist()
    for name in ("jk", "no_such_sync", "../cluster"):
        with pytest.raises(ValueError, match="the reference has no sync"):
            engine.sync_of(name)


@pytest.mark.parametrize("name", SIM_CELLS)
def test_the_simulators_tiny_cut_is_unchanged(name):
    """The cut the harness's CPU tests ran before system modules brought
    their own: 8 hosts, HCA at 20 x 5, two epochs, all checked, nrep 1100 or 300."""
    w, cfg, traffic, _ = harness.cell(BENCH, name)
    got_cfg, got_traffic = tiny(name)[1:3]
    assert got_cfg == dict(cfg, p=8, n_fitpts=20, n_exchanges=5)
    assert got_traffic == dict(traffic, nrep=1100 if traffic["nrep"] >= 1024 else 300,
                               epochs_per_campaign=2, check_epochs_per_campaign=2)
    assert harness.cell(BENCH, name)[1] == cfg and got_cfg is not cfg
