"""The comparison that decides ``correct``: what the timed path produced in
the epochs a run checks, against the plain reference worked out again from
the same seeds.

A capture of one epoch holds what the program produced there: each rank's
fitted clock model, every engine window in the order the program ran them
(collective, message size, calls, the calls' times and discard flags), and
each record's times. The reference rebuilds the epoch's cluster and sync
and measures the epoch's cases in the design's order on its own: its own
flags set its own top-up sizes. The program's windows are paired with the
reference's in order.

Numbers compared (each against the configuration's limit):

* ``sync_gap``: the widest gap of a rank's slope, intercept or first
  reading, relative to the reference's value or the ranks' median of it;
* ``time_gap``: the widest gap of a call's time in a window, or of a
  record's time, relative to the reference's or the median of its array.
  A call whose discard flag differs, a window that does not pair with the
  reference's (a size off the top-up rule, missing, extra or out of
  order) and a record of another length are answers that do not agree
  at all: each makes the gap infinite. Their counts are reported beside.
  A run that checked no epoch compared nothing, which makes the gap
  infinite too.
"""

from __future__ import annotations

import numpy as np

from .reference.engine import Epoch, case_orders

NUMBERS = ("sync_gap", "time_gap")


def rel_gap(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    if b.size == 0:
        return 0.0
    scale = np.maximum(np.abs(b), np.median(np.abs(b)))
    gap = np.abs(a - b) / np.where(scale > 0, scale, 1.0)
    return float(np.nan_to_num(gap, nan=np.inf).max())


def check_epoch(cfg: dict, plan, epoch: int, cap: dict, device, out: dict) -> None:
    """Compare one captured epoch; adds to the totals in ``out``."""
    ref = Epoch(cfg, plan.seed0, epoch, device)
    s = cap["sync"]
    out["sync_gap"] = max(out["sync_gap"], rel_gap(s[0], ref.sync.slope),
                          rel_gap(s[1], ref.sync.intercept), rel_gap(s[2], ref.sync.init))
    calls = list(cap["calls"])
    for op, msize in case_orders(plan.design_seed, plan.epochs, list(plan.cases))[epoch]:
        runs, record = ref.measure(op, msize, plan.nrep)
        mine = []
        while calls and calls[0][:2] == (op, msize):
            mine.append(calls.pop(0))
        out["unpaired"] += abs(len(mine) - len(runs))
        for (_, _, size, t, er), (rsize, rt, rer) in zip(mine, runs):
            if size != rsize:
                out["unpaired"] += 1
                continue
            out["time_gap"] = max(out["time_gap"], rel_gap(t, rt))
            out["flag_rows"] += int(np.count_nonzero(er != rer))
            out["calls_checked"] += int(size)
            out["windows_checked"] += 1
        got = cap["records"].get((op, msize))
        if got is None or got.shape != record.shape:
            out["unpaired"] += 1
        else:
            out["time_gap"] = max(out["time_gap"], rel_gap(got, record))
    out["unpaired"] += len(calls)           # windows of no case, or out of order
    out["epochs_checked"] += 1


def check(cfg: dict, captures: dict, device) -> dict:
    """``captures`` maps ``(plan, epoch)`` to a capture. Returns the numbers
    compared and how much was compared."""
    out = dict(sync_gap=0.0, time_gap=0.0, flag_rows=0, unpaired=0,
               epochs_checked=0, windows_checked=0, calls_checked=0)
    for (plan, epoch), cap in captures.items():
        check_epoch(cfg, plan, epoch, cap, device, out)
    if out["flag_rows"] or out["unpaired"] or not out["epochs_checked"]:
        out["time_gap"] = float("inf")
    return out


def verdict(numbers: dict, limits: dict, names=NUMBERS) -> bool:
    """Every number in ``names`` within its limit (a NaN never is)."""
    return all(numbers[k] <= limits[k] for k in names)
