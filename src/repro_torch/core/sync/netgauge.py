"""Netgauge / NBCBench hierarchical clock synchronization (§4.1, Algs. 11-12).

Offset-only like SKaMPI, but O(log p) rounds: ranks synchronize pairwise in a
binary-tree pattern and the per-level offsets are *summed* along the tree
path. Scalable, but each level contributes its own measurement error, so the
offset error grows with the number of rounds (Fig. 8(b)) — one of the paper's
key observations, and the same error-accumulation mechanism that HCA inherits
for its slopes (where it is harmless, §4.4) and HCA2 for its intercepts
(where it is not, Fig. 9).
"""

from __future__ import annotations

import math

import numpy as np

from ..clocks import LinearModel
from ..simnet import SimNet
from .base import ClockSync, SyncResult

__all__ = ["NetgaugeSync", "compute_offset_minrtt"]


def compute_offset_minrtt(
    net: SimNet,
    client: int,
    server: int,
    window: int = 100,
    max_exchanges: int = 1000,
) -> float:
    """COMPUTE_OFFSET (Alg. 12): ping-pong until no new minimum RTT has been
    seen for ``window`` consecutive exchanges; the offset estimate
    ``clock_client - clock_server`` is taken from the minimum-RTT exchange
    (``diff = s_time + rtt/2 - tremote``).
    """
    best_rtt = np.inf
    best_diff = 0.0
    since_improve = 0
    done = 0
    while since_improve < window and done < max_exchanges:
        batch = min(window, max_exchanges - done)
        send, srv, recv = net.pingpong_batch(client, server, batch)
        rtt = recv - send
        diff = send + rtt / 2.0 - srv
        for j in range(batch):
            if rtt[j] < best_rtt:
                best_rtt = rtt[j]
                best_diff = diff[j]
                since_improve = 0
            else:
                since_improve += 1
        done += batch
    return float(best_diff)


class NetgaugeSync(ClockSync):
    name = "netgauge"

    def __init__(self, window: int = 100, max_exchanges: int = 300):
        self.window = window
        self.max_exchanges = max_exchanges

    def synchronize(self, net: SimNet, ranks: list[int] | None = None) -> SyncResult:
        ranks = list(range(net.p)) if ranks is None else ranks
        p = len(ranks)
        net.align(ranks)
        snap = net.elapsed_snapshot()
        msgs0 = net.msg_count

        maxpower = 2 ** int(math.floor(math.log2(p))) if p > 1 else 1
        # offset[r] below is the estimated clock offset of rank ``ranks[r]``
        # relative to the subtree reference it is currently attached to; the
        # tree combination sums the per-level estimates (Alg. 11 lines 9-10).
        offset_rel_ref: dict[int, float] = {0: 0.0}
        # subtree[i] = members (local indices) whose offsets are known
        # relative to i.
        subtree: dict[int, dict[int, float]] = {i: {i: 0.0} for i in range(p)}

        # SYNC_CLOCKS_POW2: log2(maxpower) rounds of concurrent pairs.
        rnd = 1
        while 2 ** rnd <= maxpower:
            half = 2 ** (rnd - 1)
            for ref in range(0, maxpower, 2 ** rnd):
                client = ref + half
                # offset of client vs ref (client initiates; Alg. 12).
                d = compute_offset_minrtt(
                    net, ranks[client], ranks[ref], self.window, self.max_exchanges
                )
                # Fold the client's subtree into the ref's, adding the level
                # offset (one model message up the tree).
                net.transfer(ranks[client], ranks[ref])
                for m, off in subtree[client].items():
                    subtree[ref][m] = d + off
            rnd += 1

        # SYNC_CLOCKS_REMAINING: ranks >= maxpower attach in one extra round.
        for j in range(p - maxpower):
            q = maxpower + j
            d = compute_offset_minrtt(
                net, ranks[q], ranks[j], self.window, self.max_exchanges
            )
            net.transfer(ranks[q], ranks[0])
            subtree[0][q] = subtree[0][j] + d

        net.align(ranks)
        duration = net.max_elapsed_since(snap)

        models = [LinearModel(0.0, 0.0) for _ in range(net.p)]
        for i, r in enumerate(ranks):
            models[r] = LinearModel(0.0, subtree[0].get(i, 0.0))
        return SyncResult(
            algorithm=self.name,
            models=models,
            initial_times=[0.0] * net.p,
            duration=duration,
            n_messages=net.msg_count - msgs0,
            params={"window": self.window, "max_exchanges": self.max_exchanges},
        )
