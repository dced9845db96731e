"""Window-based process synchronization (§3.3, scheme (4) of Fig. 1): the
result type and error flags.

Processes agree on a logical-global-clock start time; measurement ``i``
begins at ``start_time + i * win_size``. Two error flags per measurement,
as SKaMPI/NBCBench record them (Algs. 9/13):

  * ``START_LATE``    — the rank reached the sync point after the window
    opened (its global-clock estimate was behind),
  * ``TOOK_TOO_LONG`` — the operation did not finish within the window.

Measurements with either flag set on any rank are invalid and discarded.
:func:`run_windowed` measures a collective under the scheme through one
of five engines:

  * ``engine="torch"`` (the default) — the device engine of
    :mod:`repro_torch.simengine`, for affine and random-walk clocks, its
    draws on the device;
  * ``engine="batch"`` — the reference's numpy engine for affine clocks
    (``rw_sigma == 0``): every local<->global conversion in closed form
    over all ``nrep`` windows at once, on top of
    :meth:`~repro_torch.core.mpi_ops.SimCollective.execute_batch`;
  * ``engine="batch_rw"`` — the same for random-walk clocks: the walk is
    pre-sampled on a window-spaced grid (a
    :class:`~repro_torch.core.clocks.DriftPath`), so deadline inversion is
    a batched binary search over path nodes plus an in-segment affine
    solve;
  * ``engine="scalar"`` — the semantic reference, a per-observation,
    per-rank Python loop of busy-waits and scalar clock reads, on the host
    only;
  * ``engine="auto"`` — ``batch`` for affine clocks, ``batch_rw`` for
    random-walk clocks.

The numpy engines draw from ``net.rng`` in the reference's order, so they
reproduce the JAX package's engines of the same names from one seed; on
``device="cuda"`` the batch engines' durations are scanned by the
``sim_scan`` kernel from the same host draws.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["WindowRun", "START_LATE", "TOOK_TOO_LONG", "resolve_engine",
           "run_windowed", "run_windowed_rw_batch", "run_windowed_scalar"]

ENGINES = ("torch", "auto", "batch", "batch_rw", "scalar")

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


def _clocks_affine(net, ranks: list[int]) -> bool:
    """True when every participating clock is a pure affine map of true
    time (no random-walk state), so deadline conversion has a closed form."""
    return all(net.clocks[r].rw_sigma <= 0.0 for r in ranks)


def _check_engine(engine: str) -> None:
    if engine == "jax":
        raise ValueError("engine='jax' is the JAX package's; the port's "
                         "device engine is 'torch'")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; use " + "|".join(ENGINES))


def resolve_engine(engine: str, net, ranks: list[int] | None = None) -> str:
    """The engine that will run for ``engine``: ``"auto"`` is ``"batch"``
    for affine clocks and ``"batch_rw"`` for random-walk ones, every other
    engine itself. Unknown engines and ``"jax"`` raise ``ValueError``.
    The reference returns ``(resolved, fallback_note)``; the port
    substitutes no engine for another, so it returns the engine alone."""
    _check_engine(engine)
    ranks = list(range(net.p)) if ranks is None else ranks
    if engine == "auto":
        return "batch" if _clocks_affine(net, ranks) else "batch_rw"
    return engine


def run_windowed(net, sync, op, msize: int, nrep: int, win_size: float,
                 ranks: list[int] | None = None, device="cuda",
                 engine: str = "torch") -> WindowRun:
    """Measure ``nrep`` calls of ``op`` under window-based synchronization.

    Completion time per observation follows §3.2.2 (global times):
    ``max_r global(end_r) - min_r global(start_r)``.

    ``engine`` is one of :data:`ENGINES` (see the module's docstring).
    ``"torch"`` runs :func:`repro_torch.simengine.run_windowed_torch` on
    ``device``: ``sim_scan`` on the card (``"cuda"``, the default) or the
    kernel's plain version on the CPU (``"cpu"``). ``"batch"`` and
    ``"batch_rw"`` run the reference's numpy window with the durations
    scanned on ``device`` (the kernel on ``"cuda"``, numpy on ``"cpu"``).
    ``"scalar"`` runs on the host and wants ``device="cpu"``. Explicit
    engines are strict: ``batch`` raises on random-walk clocks rather than
    degrading, and ``"cuda"`` without a card raises.
    """
    _check_engine(engine)
    if engine == "torch":
        from ..simengine import run_windowed_torch

        return run_windowed_torch(net, sync, op, msize, nrep, win_size,
                                  ranks=ranks, device=device)
    if engine == "scalar":
        if str(device) != "cpu":
            raise ValueError(
                "engine='scalar' is the host's semantic reference and runs on "
                f"the CPU only; pass device='cpu' (got device={str(device)!r})")
        return run_windowed_scalar(net, sync, op, msize, nrep, win_size, ranks)
    from ..simengine import resolve_device

    dev = resolve_device(device)
    engine = resolve_engine(engine, net, ranks)
    if engine == "batch_rw":
        return run_windowed_rw_batch(net, sync, op, msize, nrep, win_size,
                                     ranks, device=dev)
    return _run_windowed_batch(net, sync, op, msize, nrep, win_size, ranks,
                               dev)


def _batch_window(net, sync, op, msize, nrep, win_size, ranks,
                  device) -> WindowRun:
    """The batch engines' window over all ``nrep`` observations at once:
    deadlines converted to true time through each clock's inverse (closed
    form for affine clocks, a search over the drift path's nodes for
    walking ones), the calls in closed form
    (:meth:`~repro_torch.core.mpi_ops.SimCollective.execute_batch`), then
    the flags, global estimates and times."""
    p = len(ranks)
    # Root picks a start time in the (global-clock) future and broadcasts it
    # (Alg. 2 line 8). Give every rank a slack window to reach the loop.
    g_now = max(sync.global_time(net, r) for r in ranks)
    start_time = g_now + win_size
    targets = start_time + win_size * np.arange(nrep)

    deadline_true = np.empty((nrep, p))
    for i, r in enumerate(ranks):
        deadline_local = sync.models[r].denormalize(targets) + sync.initial_times[r]
        deadline_true[:, i] = net.clocks[r].true_at_local(deadline_local)

    t0 = net.t[ranks].copy()
    ex = op.execute_batch(net, msize, nrep, ranks,
                          min_start_true=deadline_true, device=device)
    prev_end = np.vstack((t0[None, :], ex.end_true[:-1]))
    # wait_until_local() reports START_LATE when the deadline is <= the
    # rank's current time (i.e. <= its previous finish).
    late = deadline_true <= prev_end

    sg = np.empty((nrep, p))
    eg = np.empty((nrep, p))
    for i, r in enumerate(ranks):
        clk, init = net.clocks[r], sync.initial_times[r]
        model = sync.models[r]
        sg[:, i] = model.normalize(clk.read(ex.start_true[:, i]) - init)
        eg[:, i] = model.normalize(clk.read(ex.end_true[:, i]) - init)
    took = eg > (targets + win_size)[:, None]

    errors = np.zeros(nrep, dtype=np.int64)
    errors[late.any(axis=1)] |= START_LATE
    errors[took.any(axis=1)] |= TOOK_TOO_LONG
    times = eg.max(axis=1) - sg.min(axis=1)

    return WindowRun(
        times=times, errors=errors,
        start_global_est=sg, end_global_est=eg,
        start_true=ex.start_true, end_true=ex.end_true,
    )


def _run_windowed_batch(net, sync, op, msize, nrep, win_size, ranks,
                        device) -> WindowRun:
    """The reference's ``engine="batch"``: affine clocks only."""
    ranks = list(range(net.p)) if ranks is None else ranks
    if not _clocks_affine(net, ranks):
        raise ValueError(
            "engine='batch' requires affine clocks (rw_sigma == 0); "
            "use engine='batch_rw' (or 'auto') for random-walk clocks")
    return _batch_window(net, sync, op, msize, nrep, win_size, ranks, device)


def run_windowed_rw_batch(net, sync, op, msize: int, nrep: int,
                          win_size: float, ranks: list[int] | None = None,
                          device="cuda") -> WindowRun:
    """Vectorized windowed engine for random-walk clocks (the reference's
    ``engine="batch_rw"``), durations scanned on ``device`` as in
    :func:`run_windowed`.

    Once the walk is pre-sampled on a fixed grid
    (:meth:`~repro_torch.core.clocks.SimClock.drift_path`), the local clock
    is a monotone piecewise-affine map of true time: deadline inversion is
    a batched binary search over the path nodes plus an in-segment affine
    solve, and forward reads are vectorized interpolation. Everything else
    is the affine batch engine unchanged. Bit-identical to the scalar
    engine run against the same frozen paths
    (``SimNet.freeze_drift_paths``) when the noise is deterministic; also
    valid for affine clocks, where the path is identically zero.
    """
    ranks = list(range(net.p)) if ranks is None else ranks
    # Pre-sample every participating walk on a window-spaced grid *before*
    # the first clock read, so all conversions — and any later scalar read
    # of the same net — interpolate the same path.
    for r in ranks:
        net.clocks[r].drift_path(win_size)
    return _batch_window(net, sync, op, msize, nrep, win_size, ranks, device)


def run_windowed_scalar(net, sync, op, msize: int, nrep: int, win_size: float,
                        ranks: list[int] | None = None) -> WindowRun:
    """Scalar semantic reference for :func:`run_windowed`, on the host.

    One busy-wait and one clock read per (observation, rank) — exactly the
    per-measurement control flow of Alg. 9/13: the executable
    specification the batch engines are verified against.
    """
    ranks = list(range(net.p)) if ranks is None else ranks
    p = len(ranks)

    g_now = max(sync.global_time(net, r) for r in ranks)
    start_time = g_now + win_size

    times = np.empty(nrep)
    errors = np.zeros(nrep, dtype=np.int64)
    sg = np.empty((nrep, p))
    eg = np.empty((nrep, p))
    st = np.empty((nrep, p))
    et = np.empty((nrep, p))

    for obs in range(nrep):
        target = start_time + obs * win_size
        err = 0
        for i, r in enumerate(ranks):
            deadline_local = sync.local_deadline(r, target)
            on_time = net.wait_until_local(r, deadline_local)
            if not on_time:
                err |= START_LATE
        ex = op.execute(net, msize, ranks)
        st[obs] = ex.start_true
        et[obs] = ex.end_true
        for i, r in enumerate(ranks):
            sg[obs, i] = sync.global_time(
                net, r, net.clocks[r].read(ex.start_true[i]))
            eg[obs, i] = sync.global_time(
                net, r, net.clocks[r].read(ex.end_true[i]))
            if eg[obs, i] > target + win_size:
                err |= TOOK_TOO_LONG
        times[obs] = float(np.max(eg[obs]) - np.min(sg[obs]))
        errors[obs] = err

    return WindowRun(
        times=times, errors=errors,
        start_global_est=sg, end_global_est=eg,
        start_true=st, end_true=et,
    )
