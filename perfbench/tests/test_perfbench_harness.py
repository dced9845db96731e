"""The harness on the CPU: discovery by name, the benchmark file's shape,
a tiny campaign of each cell through the whole run, the trace reduction
and the kernel's byte count. The command itself refuses the CPU; these
tests call the harness with ``device="cpu"``."""

from __future__ import annotations

import re
import subprocess
import sys

import pytest

from perfbench.devtrace import reduce
from perfbench.tests.tiny import BENCH, CELLS, ROOT, harness, run_tiny
from perfbench.traffic import campaign
from perfbench.yardstick import H100, sim_scan_bound_s, sim_scan_bytes

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_file_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and BENCH["command"][1] == "perfbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)


def test_every_name_finds_its_file():
    for name in CELLS:
        w, cfg, traffic, metrics = harness.cell(BENCH, name)
        assert w["name"] == name and traffic["name"] == w["traffic"]
        entry = [c for c in BENCH["configs"] if c["name"] == w["config"]][0]
        assert cfg["reduced"] == entry["reduced"] and set(cfg["reduced"]) <= set(cfg["cuts"])
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
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["run"]["epochs_checked"] >= 2
    assert res["failed"] == 0 and res["attempted"] == res["run"]["records"]
    assert set(res["metrics"]) == {"valid_meas_per_s", "setup_s"}
    assert res["metrics"]["valid_meas_per_s"]["value"] > 0
    assert list(res)[-1] == "checks"


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
    # gaps: 0-10 sync, 25-80 (middle 52.5: topup), 85-100 topup
    assert tr.idle_s == pytest.approx({"sync": 1e-5, "topup": 7e-5})
    assert reduce(ev[1:]) is None


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
