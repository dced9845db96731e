"""MPI-style timing procedures (§3.2, Algorithm 1) and barrier probes (§4.6).

Copied from the JAX package's ``repro.core.timing``, with the operation's
durations drawn on the device. Two ways to compute the completion time of
a distributed operation:

  * **Local times** (§3.2.1, used with barrier sync):
    ``t[i] = max_r (end_local_r[i] - start_local_r[i])`` — no global clock
    needed, but silently *includes barrier exit skew* in the measurement.
  * **Global times** (§3.2.2, used with window sync or drift-corrected
    clocks): ``t[i] = max_r g(end_r[i]) - min_r g(start_r[i])`` — the true
    completion time of the operation, requires synchronized clocks.

Figure 11's gap between the two is reproduced by :func:`run_barrier_timed`
returning *both* quantities, and Fig. 12's barrier exit-skew probe by
:func:`probe_barrier_skew`.

:func:`run_barrier_timed` runs one of two engines (:data:`BARRIER_ENGINES`):

  * ``engine="torch"`` (the default) draws all operation durations and
    finish imbalances up front on the device through
    :func:`~repro_torch.simengine.sample_durations_torch` (``sim_scan`` on
    the card, one launch per cost-model term);
  * ``engine="batch"`` draws as the reference does, from ``net.rng`` in
    its order: on affine clocks the durations through
    :meth:`~repro_torch.core.mpi_ops.SimCollective.sample_durations` (on
    a CUDA device its scan runs in ``sim_scan`` from the same host
    draws), then the ``(nrep, p)`` imbalance, then the barriers; on
    random-walk clocks one :meth:`~repro_torch.core.mpi_ops.SimCollective.execute`
    per observation, after its barrier, on the host only. On the CPU it
    reproduces the reference's run bit for bit from one seed.

Both run the barrier loop on the host with ``net.rng`` latencies and defer
every clock read to vectorized affine conversions after the loop;
random-walk clocks read lazily per observation instead (their reads are
stateful and order-dependent).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .mpi_ops import SimCollective
from .simnet import SimNet
from .sync.base import SyncResult

__all__ = ["BarrierRun", "BARRIER_ENGINES", "run_barrier_timed", "probe_barrier_skew"]

#: The engines of :func:`run_barrier_timed`, by :data:`~repro_torch.core.window.ENGINES`'
#: names: the device engine and the reference's numpy order.
BARRIER_ENGINES = ("torch", "batch")


@dataclass
class BarrierRun:
    """Measurements of ``nrep`` operation calls under barrier sync."""

    times_local: np.ndarray   # max_r (end_r - start_r), scheme of §3.2.1
    times_global: np.ndarray  # max_r g(end_r) - min_r g(start_r), §3.2.2
    barrier_exit_true: np.ndarray  # (nrep, p) true exit times (skew study)
    start_true: np.ndarray
    end_true: np.ndarray


def _barrier(net: SimNet, use_library_barrier: bool, exit_skew: float,
             ranks: list[int]) -> np.ndarray:
    if use_library_barrier:
        return net.library_barrier(exit_skew=exit_skew, ranks=ranks)
    return net.dissemination_barrier(ranks=ranks)


def run_barrier_timed(
    net: SimNet,
    op: SimCollective,
    msize: int,
    nrep: int,
    sync: SyncResult | None = None,
    barrier_exit_skew: float = 0.0,
    use_library_barrier: bool = True,
    ranks: list[int] | None = None,
    device="cuda",
    engine: str = "torch",
) -> BarrierRun:
    """Algorithm 1 with SYNC_PROCESSES = MPI_Barrier.

    ``sync`` (optional) provides globally-synchronized clocks so the *same*
    run can report both the local-max and the global completion time — the
    §4.6 experiment design. ``barrier_exit_skew`` models implementations
    whose barrier releases ranks far apart (Fig. 12: >40 us for MVAPICH).
    ``engine`` is one of :data:`BARRIER_ENGINES` (see the module's
    docstring); the durations are drawn, or scanned, on ``device``.
    ``engine="batch"`` on random-walk clocks draws each observation's
    duration between two barriers, so it runs on the host and wants
    ``device="cpu"``: on a CUDA device it raises ``ValueError``.
    """
    if engine not in BARRIER_ENGINES:
        raise ValueError(f"run_barrier_timed: unknown engine {engine!r}; use "
                         + "|".join(BARRIER_ENGINES))
    from ..simengine import resolve_device, sample_durations_torch

    dev = resolve_device(device)
    ranks = list(range(net.p)) if ranks is None else ranks
    p = len(ranks)
    walking = any(net.clocks[r].rw_sigma > 0.0 for r in ranks)
    if engine == "batch" and walking:
        if dev.type != "cpu":
            raise ValueError(
                "run_barrier_timed(engine='batch') on random-walk clocks draws "
                "each duration between two barriers on the host; pass "
                f"device='cpu', or engine='torch' to draw on {str(device)!r}")

        def finish(obs, start_true):
            return op.execute(net, msize, ranks).end_true

        return _run_barrier_timed_scalar(
            net, finish, nrep, sync, barrier_exit_skew, use_library_barrier, ranks)
    if engine == "batch":
        dur = op.sample_durations(net, p, msize, nrep, device=dev)
        imb = net.rng.normal(0.0, op.rank_imbalance, size=(nrep, p))
        span = dur[:, None] * np.maximum(0.25, 1.0 + imb)
    else:
        dur, factors = sample_durations_torch(net, op, msize, nrep, ranks, dev)
        span = (dur[:, None] * factors).cpu().numpy()
    if walking:
        def finish(obs, start_true):
            end_true = float(np.max(start_true)) + span[obs]
            net.t[ranks] = end_true
            return end_true

        return _run_barrier_timed_scalar(
            net, finish, nrep, sync, barrier_exit_skew, use_library_barrier, ranks)

    bx = np.empty((nrep, p))
    st = np.empty((nrep, p))
    et = np.empty((nrep, p))
    # The per-observation loop only runs the (stochastic, entry-time-
    # dependent) barrier and the entry/finish arithmetic of a
    # synchronizing collective.
    for obs in range(nrep):
        exit_true = _barrier(net, use_library_barrier, barrier_exit_skew, ranks)
        bx[obs] = exit_true
        st[obs] = exit_true
        et[obs] = np.max(exit_true) + span[obs]
        net.t[ranks] = et[obs]

    # Deferred clock reads: local stamps of all (obs, rank) pairs at once.
    start_local = np.empty((nrep, p))
    end_local = np.empty((nrep, p))
    for i, r in enumerate(ranks):
        clk = net.clocks[r]
        start_local[:, i] = clk.read(st[:, i])
        end_local[:, i] = clk.read(et[:, i])
    tl = np.max(end_local - start_local, axis=1)
    tg = np.full(nrep, np.nan)
    if sync is not None:
        g_start = np.empty((nrep, p))
        g_end = np.empty((nrep, p))
        for i, r in enumerate(ranks):
            model, init = sync.models[r], sync.initial_times[r]
            g_start[:, i] = model.normalize(start_local[:, i] - init)
            g_end[:, i] = model.normalize(end_local[:, i] - init)
        tg = np.max(g_end, axis=1) - np.min(g_start, axis=1)

    return BarrierRun(
        times_local=tl, times_global=tg,
        barrier_exit_true=bx, start_true=st, end_true=et,
    )


def _run_barrier_timed_scalar(
    net: SimNet,
    finish,
    nrep: int,
    sync: SyncResult | None,
    barrier_exit_skew: float,
    use_library_barrier: bool,
    ranks: list[int],
) -> BarrierRun:
    """Per-observation loop for random-walk clocks: each clock is read
    lazily in the reference's order (start stamps after the barrier, the
    collective's all-in and finish, end stamps, then the global
    conversions). ``finish(obs, start_true)`` runs observation ``obs``'s
    collective from the ranks' true start times: it moves ``net.t`` to
    their finishes and returns them."""
    p = len(ranks)
    tl = np.empty(nrep)
    tg = np.full(nrep, np.nan)
    bx = np.empty((nrep, p))
    st = np.empty((nrep, p))
    et = np.empty((nrep, p))

    for obs in range(nrep):
        exit_true = _barrier(net, use_library_barrier, barrier_exit_skew, ranks)
        bx[obs] = exit_true
        start_local = np.array([net.local_time(r) for r in ranks])
        start_true = net.t[ranks].copy()
        end_true = finish(obs, start_true)
        end_local = np.array([net.local_time(r) for r in ranks])
        st[obs] = start_true
        et[obs] = end_true
        tl[obs] = float(np.max(end_local - start_local))
        if sync is not None:
            g_start = [
                sync.global_time(net, r, net.clocks[r].read(start_true[i]))
                for i, r in enumerate(ranks)
            ]
            g_end = [
                sync.global_time(net, r, net.clocks[r].read(end_true[i]))
                for i, r in enumerate(ranks)
            ]
            tg[obs] = float(np.max(g_end) - np.min(g_start))

    return BarrierRun(
        times_local=tl, times_global=tg,
        barrier_exit_true=bx, start_true=st, end_true=et,
    )


def probe_barrier_skew(
    net: SimNet,
    nrep: int = 1000,
    barrier_exit_skew: float = 0.0,
    use_library_barrier: bool = True,
    ranks: list[int] | None = None,
) -> np.ndarray:
    """Fig. 12 experiment: per-rank barrier exit times relative to the first
    rank that leaves, over ``nrep`` barrier calls.

    Returns shape ``(nrep, p)`` relative exit times in seconds; column means
    reproduce the per-rank skew profile.
    """
    ranks = list(range(net.p)) if ranks is None else ranks
    p = len(ranks)
    out = np.empty((nrep, p))
    for obs in range(nrep):
        exit_true = _barrier(net, use_library_barrier, barrier_exit_skew, ranks)
        out[obs] = exit_true - np.min(exit_true)
        # small idle gap between probes so barriers do not overlap
        net.sleep_all(5e-6)
    return out
