"""Common interfaces for clock-synchronization algorithms (§4).

Every algorithm produces a :class:`SyncResult`: a per-rank
:class:`~repro_torch.core.clocks.LinearModel` mapping *adjusted local time*
(raw local clock minus a per-rank ``initial_time`` epoch) to the root's
reference time, plus bookkeeping used by the evaluation experiments
(sync-phase duration for the Fig. 10 Pareto, message counts, parameters).

Offset-only algorithms (SKaMPI, Netgauge) return models with ``slope == 0``:
that is precisely the paper's point — without a drift slope, the global
clock error grows linearly in time (Figs. 6, 9, 20, 22).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..clocks import LinearModel
from ..simnet import SimNet

__all__ = [
    "SyncResult",
    "ClockSync",
    "compute_rtt",
    "skampi_pingpong_adjusted",
    "probe_offsets",
    "true_offsets",
]


@dataclass
class SyncResult:
    """Outcome of one clock-synchronization phase."""

    algorithm: str
    models: list[LinearModel]
    initial_times: list[float]
    duration: float            # true seconds, max over hosts (Fig. 10 x-axis)
    n_messages: int
    params: dict = field(default_factory=dict)

    def adjusted_local(self, r: int, raw_local: float) -> float:
        return raw_local - self.initial_times[r]

    def global_time(self, net: SimNet, r: int, raw_local: float | None = None) -> float:
        """Estimated reference ("global") time from rank ``r``'s clock."""
        if raw_local is None:
            raw_local = net.local_time(r)
        return self.models[r].normalize(raw_local - self.initial_times[r])

    def local_deadline(self, r: int, global_target: float) -> float:
        """Raw local clock value at which rank ``r`` believes the global
        clock reads ``global_target`` (used by the window-based scheme)."""
        return self.models[r].denormalize(global_target) + self.initial_times[r]


class ClockSync:
    """Base class; subclasses implement :meth:`synchronize`."""

    name: str = "abstract"

    def synchronize(self, net: SimNet, ranks: list[int] | None = None,
                    device=None) -> SyncResult:
        """Synchronize ``ranks`` (all of ``net``'s by default). ``device``
        is the torch device the caller measures on, or ``None``: HCA runs
        its tree there when it is a CUDA device; the others ignore it."""
        raise NotImplementedError


# --------------------------------------------------------------------------
# Shared measurement primitives (Algorithms 7 and 17)
# --------------------------------------------------------------------------

#: COMPUTE_RTT's ping-pongs: ``RTT_WARMUP`` unrecorded, then
#: ``RTT_PINGPONGS`` recorded.
RTT_WARMUP, RTT_PINGPONGS = 10, 100


def compute_rtt(net: SimNet, p1: int, p2: int, n_pingpongs: int = RTT_PINGPONGS,
                warmup: int = RTT_WARMUP) -> float:
    """COMPUTE_RTT (Alg. 17): mean RTT after Tukey outlier removal.

    ``p2`` is the client measuring the RTT to ``p1`` (matching the paper's
    argument order where ``p1`` holds the reference clock).
    """
    from ..stats import tukey_filter  # local import to avoid cycle

    if warmup:
        net.pingpong_batch(p2, p1, warmup)
    send, _, recv = net.pingpong_batch(p2, p1, n_pingpongs)
    rtt = recv - send
    kept = tukey_filter(rtt)
    return float(np.mean(kept)) if kept.size else float(np.mean(rtt))


def skampi_pingpong_adjusted(
    net: SimNet,
    p1: int,
    p2: int,
    initial_times: list[float] | None = None,
    n_pingpongs: int = 100,
) -> float:
    """SKAMPI_PINGPONG (Alg. 7): returns the estimated clock offset
    ``clock_p2 - clock_p1`` (on adjusted clocks when ``initial_times`` given).

    Uses the min/max window technique: every exchange yields a lower bound
    ``t_server - t_recv_client`` and an upper bound ``t_server - t_send_client``
    on the offset; the estimate is the midpoint of the tightest bounds.
    """
    i1 = i2 = 0.0
    if initial_times is not None:
        i1, i2 = initial_times[p1], initial_times[p2]
    send, srv, recv = net.pingpong_batch(p1, p2, n_pingpongs)
    send = send - i1
    recv = recv - i1
    srv = srv - i2
    td_min = float(np.max(srv - recv))   # lower bound on clock_p2 - clock_p1
    td_max = float(np.min(srv - send))   # upper bound
    return 0.5 * (td_min + td_max)


# --------------------------------------------------------------------------
# Post-sync evaluation probes (§4.5, Figs. 8-9; Appendix Alg. 20)
# --------------------------------------------------------------------------

def probe_offsets(net: SimNet, result: SyncResult, n_rounds: int = 10,
                  root: int = 0) -> np.ndarray:
    """The global-clock offset of every rank vs. the root measured *through
    the network* (Alg. 20): the root exchanges ping-pongs with each rank,
    the rank reports its estimated global time, and the probe of smallest
    magnitude over ``n_rounds`` is kept. Returns an array of length p
    (root slot 0)."""
    p = net.p
    out = np.zeros(p)
    for r in range(p):
        if r == root:
            continue
        best = np.inf
        send, srv, recv = net.pingpong_batch(root, r, n_rounds)
        for j in range(n_rounds):
            g_client = result.global_time(net, r, srv[j])
            g_root_mid = 0.5 * (
                result.global_time(net, root, send[j])
                + result.global_time(net, root, recv[j])
            )
            d = g_client - g_root_mid
            if abs(d) < abs(best):
                best = d
        out[r] = best
    return out


def true_offsets(net: SimNet, result: SyncResult, root: int = 0) -> np.ndarray:
    """Simulator ground truth: disagreement of the estimated global clocks
    at one common true instant. Zero for a perfect synchronization."""
    p = net.p
    t_now = float(np.max(net.t))
    g = np.array([
        result.models[r].normalize(net.clocks[r].read(t_now) - result.initial_times[r])
        for r in range(p)
    ])
    return g - g[root]
