"""Peaks of the card and the kernels' byte and operation counts.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, at the full 700 W
power limit); a card set below that limit runs slower under load, so a
run reports its limit beside every share of a peak.
"""

from __future__ import annotations

H100 = {
    "hbm_bytes_per_s": 3.35e12,
    "fp64_flops": 67e12,
}


def sim_scan_bytes(rows: int, n: int) -> int:
    """Least bytes one ``sim_scan`` launch moves: four float64 inputs read
    (innovations, three uniforms) and two float64 outputs written
    (durations, AR(1) states), 48 bytes an element."""
    return 48 * int(rows) * int(n)


def sim_scan_bound_s(shapes) -> float:
    """Least time of the launches ``[(rows, n), ...]``: bytes at the HBM
    rate (the kernel does a handful of flops an element, far below the
    float64 peak, so bytes bound it)."""
    return sum(sim_scan_bytes(r, n) for r, n in shapes) / H100["hbm_bytes_per_s"]
