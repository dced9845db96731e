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

    def global_time(self, net: SimNet, r: int, raw_local: float | None = None) -> float:
        """Estimated reference ("global") time from rank ``r``'s clock."""
        if raw_local is None:
            raw_local = net.local_time(r)
        return self.models[r].normalize(raw_local - self.initial_times[r])


class ClockSync:
    """Base class; subclasses implement :meth:`synchronize`."""

    name: str = "abstract"

    def synchronize(self, net: SimNet, ranks: list[int] | None = None) -> SyncResult:
        raise NotImplementedError


# --------------------------------------------------------------------------
# Shared measurement primitives (Algorithms 7 and 17)
# --------------------------------------------------------------------------

def compute_rtt(net: SimNet, p1: int, p2: int, n_pingpongs: int = 100,
                warmup: int = 10) -> float:
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
