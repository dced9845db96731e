"""Window-based process synchronization (§3.3, scheme (4) of Fig. 1): the
result type and error flags.

Processes agree on a logical-global-clock start time; measurement ``i``
begins at ``start_time + i * win_size``. Two error flags per measurement,
as SKaMPI/NBCBench record them (Algs. 9/13):

  * ``START_LATE``    — the rank reached the sync point after the window
    opened (its global-clock estimate was behind),
  * ``TOOK_TOO_LONG`` — the operation did not finish within the window.

Measurements with either flag set on any rank are invalid and discarded.
:func:`run_windowed` measures a collective under the scheme; the engine
that fills its :class:`WindowRun` is in :mod:`repro_torch.simengine`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["WindowRun", "START_LATE", "TOOK_TOO_LONG", "run_windowed"]

START_LATE = 1
TOOK_TOO_LONG = 2


@dataclass
class WindowRun:
    """Raw output of a window-synchronized measurement campaign."""

    times: np.ndarray          # global-clock run-times, shape (nrep,)
    errors: np.ndarray         # per-obs error bitmask (max over ranks)
    start_global_est: np.ndarray  # (nrep, p) estimated-global start stamps
    end_global_est: np.ndarray    # (nrep, p)
    start_true: np.ndarray     # (nrep, p) simulator ground truth
    end_true: np.ndarray       # (nrep, p)

    @property
    def valid(self) -> np.ndarray:
        return self.errors == 0

    @property
    def valid_times(self) -> np.ndarray:
        return self.times[self.valid]

    @property
    def invalid_fraction(self) -> float:
        return float(np.mean(~self.valid)) if self.times.size else 0.0

    @classmethod
    def concat(cls, runs: "list[WindowRun]") -> "WindowRun":
        """Merge consecutive chunks over the same ``(net, sync, op)`` into
        one campaign — the accumulation step of valid-sample top-up after
        window discards."""
        runs = list(runs)
        if not runs:
            raise ValueError("WindowRun.concat: empty run list")
        if len(runs) == 1:
            return runs[0]
        return cls(
            times=np.concatenate([r.times for r in runs]),
            errors=np.concatenate([r.errors for r in runs]),
            start_global_est=np.vstack([r.start_global_est for r in runs]),
            end_global_est=np.vstack([r.end_global_est for r in runs]),
            start_true=np.vstack([r.start_true for r in runs]),
            end_true=np.vstack([r.end_true for r in runs]),
        )


def run_windowed(net, sync, op, msize: int, nrep: int, win_size: float,
                 ranks: list[int] | None = None, device="cuda") -> WindowRun:
    """Measure ``nrep`` calls of ``op`` under window-based synchronization.

    Completion time per observation follows §3.2.2 (global times):
    ``max_r global(end_r) - min_r global(start_r)``.

    ``device`` takes the place of the reference's ``engine``: there is one
    engine, :func:`repro_torch.simengine.run_windowed_torch`, for affine
    and random-walk clocks alike, and it draws the durations through
    ``sim_scan`` on the card (``"cuda"``, the default) or through the
    kernel's plain version on the CPU (``"cpu"``). ``"cuda"`` without a
    card raises.
    """
    from ..simengine import run_windowed_torch

    return run_windowed_torch(net, sync, op, msize, nrep, win_size, ranks=ranks,
                              device=device)
