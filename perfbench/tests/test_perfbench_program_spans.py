"""The program's own spans and counters (``repro_torch.core.telemetry``)
against the harness's wrappers, in a tiny traced run of each cell on the
CPU, for each cell that ``sim_campaign`` runs: the per-layer
metrics that read them are reported where they list the
cell, the counts of records, empty records, valid calls and top-up windows
are the harness's exactly, and the program's span totals at each wrapped
boundary agree with the harness's host spans within 2%, or 2 ms."""

from __future__ import annotations

import pytest

from perfbench.tests.tiny import BENCH, SIM_CELLS, run_tiny

#: The metrics that read the program's spans and counters.
PROGRAM = ("copy_out_share", "d2h_bytes_per_valid", "readbacks_per_window", "hca_tree_share",
           "drift_deadlines_share", "drift_reads_share", "drift_upload_share")


def _close(program_s: float, harness_s: float) -> bool:
    return abs(program_s - harness_s) <= max(0.002, 0.02 * harness_s)


@pytest.mark.parametrize("name", SIM_CELLS)
def test_program_spans_agree_with_the_harness(name):
    from repro_torch.core import telemetry

    telemetry.reset()
    res = run_tiny(name, trace=True)
    assert res["correct"], res["checks"]
    snap = telemetry.snapshot()
    run, c, totals, spans = res["run"], snap["counters"], snap["totals"], snap["spans"]

    listed = {m["name"] for m in BENCH["per_layer"]
              if m["name"] in PROGRAM and name in m["workloads"]}
    assert listed and listed <= set(res["metrics"])
    assert res["metrics"]["d2h_bytes_per_valid"]["value"] == pytest.approx(
        c["engine.d2h_bytes"] / c["records.valid_calls"])
    assert res["metrics"]["readbacks_per_window"]["value"] == pytest.approx(
        c["engine.readbacks"] / c["engine.windows"])

    assert c["records"] == run["records"]
    assert c["records.empty"] == run["empty"]
    assert c["records.valid_calls"] == run["valid"]
    assert c.get("engine.windows.topup", 0) == run["topup_calls"]

    def total(*names):
        return sum(totals[n]["total_s"] for n in names if n in totals)

    first = sum((s["end_ns"] - s["start_ns"]) / 1e9 for s in spans
                if s["name"] == "engine.window" and spans[s["parent"]]["name"] != "topup")
    span_s = run["span_s"]
    assert _close(total("sync"), span_s["sync"])
    assert _close(total("topup"), span_s["topup"])
    assert _close(first + total("engine.fused"), span_s.get("engine", 0.0))
    assert _close(total("drift.deadlines", "drift.reads", "drift.upload"),
                  span_s.get("drift", 0.0))
    if "drift_deadlines_share" in listed:
        assert span_s["drift"] > 0
