"""The harness on the CPU: discovery by name, the benchmark file's shape,
a tiny campaign of each cell through the whole run, the trace reduction
and the kernel's byte count. The command itself refuses the CPU; these
tests call the harness with ``device="cpu"``."""

from __future__ import annotations

import copy
import re
import subprocess
import sys

import pytest

from perfbench.devtrace import reduce
from perfbench.tests.tiny import BENCH, CELLS, ROOT, SIM_CELLS, harness, run_tiny, system_of
from perfbench.traffic import campaign
from perfbench.yardstick import H100, sim_scan_bound_s, sim_scan_bytes

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def keeps_the_contract_shape(bench: dict) -> None:
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"] and bench["command"][1] == "perfbench/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    cells = [w["name"] for w in bench["workloads"]]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    # at most a quarter of the cells, rounded down, and always one, on four chips
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(cells) // 4)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= set(cells)


def test_benchmark_file_keeps_the_contract_shape():
    keeps_the_contract_shape(BENCH)
    # the simulator runs on one card
    assert all(w["chips"] == 1 for w in BENCH["workloads"] if w["name"] in SIM_CELLS)


def _four_cells(n_four: int) -> dict:
    bench = copy.deepcopy(BENCH)
    w0 = bench["workloads"][0]
    bench["workloads"] = [dict(w0, name=f"cell{i}", chips=4 if i < n_four else 1)
                          for i in range(4)]
    for m in bench["per_layer"]:
        m["workloads"] = ["cell0"]
    return bench


@pytest.mark.parametrize("n_four,kept", [(0, True), (1, True), (2, False)])
def test_four_chip_cells_are_at_most_a_quarter_of_the_cells(n_four, kept):
    bench = _four_cells(n_four)
    if kept:
        keeps_the_contract_shape(bench)
    else:
        with pytest.raises(AssertionError):
            keeps_the_contract_shape(bench)


def test_every_name_finds_its_file():
    for name in CELLS:
        w, cfg, traffic, metrics = harness.cell(BENCH, name)
        assert w["name"] == name and traffic["name"] == w["traffic"]
        entry = [c for c in BENCH["configs"] if c["name"] == w["config"]][0]
        assert cfg["reduced"] == entry["reduced"]
        if system_of(name) == "sim_campaign":
            assert set(cfg["reduced"]) <= set(cfg["cuts"])
        assert harness.system_module(cfg).NUMBERS and set(harness.system_module(cfg).NUMBERS) <= set(
            cfg["limits"])
        assert metrics["end_to_end"] and metrics["per_layer"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        reader = harness.load_module(ROOT / "perfbench" / "metrics" / f"{m['name']}.py",
                                     "reader_" + m["name"])
        assert callable(reader.read)
    drift = harness.cell(BENCH, "drift512-paper")[3]["per_layer"]
    assert "drift_host_share" in [m["name"] for m in drift]
    assert "drift_host_share" not in [m["name"] for m in harness.cell(
        BENCH, "hca512-long")[3]["per_layer"]]


def test_campaigns_and_checked_epochs_are_drawn_from_the_seed():
    mix = {"cases": [["allreduce", 512]], "nrep": 10, "epochs_per_campaign": 10,
           "check_epochs_per_campaign": 2}
    plans = lambda s: [campaign(mix, s, k) for k in range(8)]
    assert plans(2**31 + 11) == plans(2**31 + 11)
    seeds = {(c.design_seed, c.seed0) for s in (2**31 + 11, 2**31 + 12) for c in plans(s)}
    assert len(seeds) == 16
    checked = [c.check_epochs for c in plans(2**31 + 11)]
    assert all(len(e) == 2 and 0 <= e[0] < e[1] < 10 for e in checked) and len(set(checked)) > 1


@pytest.mark.parametrize("name", CELLS)
def test_tiny_campaign_of_each_cell_runs_and_is_correct(name):
    res = run_tiny(name)
    _, cfg, _, metrics = harness.cell(BENCH, name)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(harness.system_module(cfg).NUMBERS)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in metrics["end_to_end"]}
    assert res["metrics"]["valid_meas_per_s"]["value"] > 0
    assert list(res)[-1] == "checks"
    if system_of(name) == "sim_campaign":
        assert set(res["metrics"]) == {"valid_meas_per_s", "setup_s"}
        assert res["run"]["epochs_checked"] >= 2
        assert res["attempted"] == res["run"]["records"]
        assert list(res["run"]) == [
            "wall_s", "campaigns", "records", "valid", "empty", "rows", "topup_calls",
            "dispatches", "span_s", "sim_scan_launches", "check_s", "setup_parts",
            "epochs_checked", "windows_checked", "calls_checked", "flag_rows", "unpaired"]
        assert list(res["run"]["setup_parts"]) == ["imports", "kernel", "sync", "windows"]


def test_traced_run_reads_the_host_layers():
    res = run_tiny("drift512-paper", trace=True)
    assert res["correct"], res["checks"]
    got = set(res["metrics"])
    assert {"dispatches_per_record", "sync_share", "topup_share", "topup_calls_per_record",
            "empty_record_share", "engine_share", "drift_host_share"} <= got
    share = res["metrics"]["empty_record_share"]["value"]
    assert share == 100.0 * res["run"]["empty"] / res["run"]["records"]
    # no device on the CPU: nothing to read, so nothing reported
    assert "idle_pct" not in got and "sim_scan_roofline" not in got
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def test_a_record_the_program_does_not_deliver_counts_as_failed(monkeypatch):
    from perfbench.systems.sim_campaign import System

    campaign_run = System._campaign

    def drop_last_record(self, plan):
        res = campaign_run(self, plan)
        res.records.pop()
        return res

    monkeypatch.setattr(System, "_campaign", drop_last_record)
    res = run_tiny("hca512-paper")
    assert res["failed"] == res["run"]["campaigns"] >= 1
    assert res["attempted"] == res["run"]["records"] + res["failed"]


def test_trace_reduction_busy_idle_and_labels():
    ev = [dict(ph="X", cat="user_annotation", name="perfbench::window", ts=0, dur=100),
          dict(ph="X", cat="user_annotation", name="perfbench::sync", ts=0, dur=40),
          dict(ph="X", cat="user_annotation", name="perfbench::topup", ts=50, dur=50),
          dict(ph="X", cat="user_annotation", name="perfbench::drift", ts=60, dur=10),
          dict(ph="X", cat="kernel", name="k1", ts=10, dur=10),
          dict(ph="X", cat="kernel", name="k1", ts=15, dur=10),
          dict(ph="X", cat="gpu_memcpy", name="copy", ts=80, dur=5),
          dict(ph="X", cat="kernel", name="late", ts=120, dur=5)]
    tr = reduce(ev)
    assert tr.window_s == pytest.approx(1e-4) and tr.busy_s == pytest.approx(2e-5)
    assert tr.device_s == pytest.approx({"k1": 2e-5, "copy": 5e-6})
    assert tr.device_n == {"k1": 2, "copy": 1}
    # gaps 0-10, 25-80 and 85-100, each split over the innermost annotation:
    # sync 0-10 and 25-40, window 40-50, topup 50-60, 70-80 and 85-100, drift 60-70
    assert tr.idle_s == pytest.approx({"sync": 2.5e-5, "window": 1e-5, "topup": 3.5e-5,
                                       "drift": 1e-5})
    assert sum(tr.idle_s.values()) == pytest.approx(tr.window_s - tr.busy_s)
    assert reduce(ev[1:]) is None


def test_idle_time_is_charged_to_the_programs_innermost_span():
    note = lambda prefix, name, ts, dur: dict(ph="X", cat="user_annotation",
                                              name=prefix + name, ts=ts, dur=dur)
    harness_ev = [note("perfbench::", "window", 0, 100), note("perfbench::", "sync", 0, 60),
                  dict(ph="X", cat="kernel", name="k", ts=40, dur=10),
                  dict(ph="X", cat="gpu_user_annotation", name="repro_torch::sync", ts=0,
                       dur=100)]
    program_ev = [note("repro_torch::", "sync", 2, 56), note("repro_torch::", "sync.net", 4, 6),
                  note("repro_torch::", "sync.hca.tree", 12, 40),
                  note("repro_torch::", "engine.window", 70, 20),
                  note("other::", "ignored", 70, 20)]
    plain, tr = reduce(harness_ev), reduce(harness_ev + program_ev)
    # the device readings do not depend on the host's ranges
    assert (tr.window_s, tr.busy_s, tr.device_s) == (plain.window_s, plain.busy_s,
                                                     plain.device_s)
    assert plain.idle_s == pytest.approx({"sync": 5e-5, "window": 4e-5})
    # idle 0-40 and 50-100: the harness's sync 0-2 and 58-60, the program's
    # sync 2-4, 10-12 and 52-58, sync.net 4-10, sync.hca.tree 12-40 and 50-52,
    # engine.window 70-90, the window itself 60-70 and 90-100
    assert tr.idle_s == pytest.approx({"sync": 1.4e-5, "sync.net": 6e-6, "sync.hca.tree": 3e-5,
                                       "engine.window": 2e-5, "window": 2e-5})
    assert sum(tr.idle_s.values()) == pytest.approx(tr.window_s - tr.busy_s)


def test_sim_scan_byte_count_is_48_bytes_an_element():
    assert sim_scan_bytes(30, 100_000) == 144_000_000
    assert sim_scan_bytes(1, 100_000) == 4_800_000
    assert sim_scan_bound_s([(30, 100_000)]) == pytest.approx(144e6 / H100["hbm_bytes_per_s"])


def test_the_command_refuses_to_run_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA device" in proc.stderr
