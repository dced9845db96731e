"""The harness on the card at a tiny size: the kernel path of each cell,
the check, the trace's device readings, and the float32 control failing.
Marked ``cuda``: skipped, with the reason, where there is no GPU.

    PYTHONPATH=src python -m pytest -q -m cuda perfbench/tests/test_perfbench_card.py
"""

from __future__ import annotations

import pytest

from perfbench import control
from perfbench.check import verdict
from perfbench.tests.tiny import CELLS, harness, system_of, tiny


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sim_scan kernel only runs there")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_on_the_card_is_correct_and_traced(card, name):
    import torch

    w = tiny(name)[0]
    if torch.cuda.device_count() < w["chips"]:
        pytest.skip(f"{name} needs {w['chips']} GPUs")
    res = harness.execute(*tiny(name), seed=2**31 + 9, seconds=0.5, trace=True, device=card,
                          tolerate=frozenset(harness.blocked_modules()))
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    got = res["metrics"]
    if system_of(name) == "sim_campaign":
        assert {"sim_scan_roofline", "idle_pct"} <= set(got)
    for k, v in got.items():
        if k.endswith("_roofline"):
            assert 0 < v["value"] <= 105, k
    if "idle_pct" in got:
        assert 0 <= got["idle_pct"]["value"] < 100


@pytest.mark.cuda
def test_float32_control_fails_on_the_card(card):
    _, cfg, traffic, _ = tiny("hca512-long")
    nums = control.readings(cfg, traffic, seed=3, campaigns=1, device=card)
    assert not verdict(nums, cfg["limits"]), nums
