"""Discrete-event simulation of a cluster's host control plane (§3, §4).

Host-side numpy, copied from the JAX package's ``repro.core.simnet`` with
the draws in the same order, so that one seed gives both packages the same
clocks, network latencies and synchronization. It models:

  * per-host hardware clocks (offset + skew), see :mod:`.clocks`,
  * a host network with lognormal one-way latency noise and occasional
    OS-noise spikes (the heavy right tail of Fig. 32),
  * per-host "program counter" timelines so hierarchical rounds of
    pairwise exchanges execute concurrently, like real MPI ranks.

All quantities are in seconds of *true* simulated time. Hosts never see
true time: algorithms only read local clocks via :meth:`SimNet.local_time`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .clocks import SimClock

__all__ = ["NetParams", "ClockParams", "SimNet"]


@dataclass
class NetParams:
    """Host-network latency model (the paper's InfiniBand clusters: RTT of
    a small message ~10-40 us, Fig. 32-33)."""

    one_way: float = 8e-6           # base one-way latency [s]
    jitter_sigma: float = 0.25      # lognormal sigma on one-way latency
    spike_prob: float = 2e-3        # probability of an OS-noise spike
    spike_scale: float = 25.0       # spike multiplies the one-way latency
    proc_overhead: float = 3e-7     # local per-message processing [s]


@dataclass
class ClockParams:
    """Distribution of per-host clock imperfections (``skew_sigma=5e-6``
    reproduces Fig. 3's several hundred microseconds over 50 s)."""

    offset_spread: float = 5e-3     # initial offsets ~ U(-spread, +spread) [s]
    skew_sigma: float = 5e-6        # relative frequency error ~ N(0, sigma)
    rw_sigma: float = 0.0           # oscillator random walk (not ported)
    freq_est_sigma: float = 0.0     # frequency-estimation error (§4.2.1)


class SimNet:
    """A simulated cluster of ``p`` hosts with clocks and a lossless network."""

    def __init__(
        self,
        p: int,
        net: NetParams | None = None,
        clocks: ClockParams | None = None,
        seed: int = 0,
    ) -> None:
        self.p = int(p)
        self.net = net or NetParams()
        self.clock_params = clocks or ClockParams()
        self.rng = np.random.default_rng(seed)
        cp = self.clock_params
        self.clocks = [
            SimClock(
                offset=float(self.rng.uniform(-cp.offset_spread, cp.offset_spread)),
                skew=float(self.rng.normal(0.0, cp.skew_sigma)),
                rw_sigma=cp.rw_sigma,
                scale_error=float(self.rng.normal(0.0, cp.freq_est_sigma)) if cp.freq_est_sigma else 0.0,
                seed=int(self.rng.integers(0, 2**31 - 1)),
            )
            for _ in range(self.p)
        ]
        # Per-host true-time program counters.
        self.t = np.zeros(self.p, dtype=np.float64)
        self.msg_count = 0

    # ------------------------------------------------------------------ time
    def local_time(self, r: int) -> float:
        """Read host ``r``'s hardware clock (what GET_TIME returns)."""
        return self.clocks[r].read(self.t[r])

    # --------------------------------------------------------------- network
    def _latency(self) -> float:
        lat = self.net.one_way * float(self.rng.lognormal(0.0, self.net.jitter_sigma))
        if self.rng.random() < self.net.spike_prob:
            lat *= self.net.spike_scale
        return lat

    def transfer(self, src: int, dst: int) -> None:
        """One-way message; the receiver is blocked in a receive, so
        delivery happens at ``max(t_dst, t_src + latency)``."""
        self.msg_count += 1
        send_done = self.t[src] + self.net.proc_overhead
        self.t[src] = send_done
        arrival = max(self.t[dst], send_done + self._latency())
        self.t[dst] = arrival + self.net.proc_overhead

    def _latencies(self, n: int) -> np.ndarray:
        lat = self.net.one_way * self.rng.lognormal(0.0, self.net.jitter_sigma, size=n)
        spikes = self.rng.random(n) < self.net.spike_prob
        lat[spikes] *= self.net.spike_scale
        return lat

    def pingpong_batch(self, client: int, server: int, n: int):
        """``n`` back-to-back client->server->client exchanges (the primitive
        under SKAMPI_PINGPONG, COMPUTE_OFFSET, COMPUTE_RTT and the JK/HCA
        fitpoints). Returns local-clock arrays ``(t_send_client, t_server,
        t_recv_client)``."""
        if n <= 0:
            return (np.empty(0), np.empty(0), np.empty(0))
        oh = self.net.proc_overhead
        lat1 = self._latencies(n)
        lat2 = self._latencies(n)
        # send_i = recv_{i-1} + oh ; srv_i = send_i + lat1_i + oh ;
        # recv_i = srv_i + lat2_i + oh. Only the first delivery needs the
        # max() against the server's availability.
        send = np.empty(n)
        srv = np.empty(n)
        recv = np.empty(n)
        send[0] = self.t[client] + oh
        srv[0] = max(self.t[server], send[0] + lat1[0]) + oh
        recv[0] = srv[0] + lat2[0] + oh
        if n > 1:
            d = 3 * oh + lat1[1:] + lat2[1:]
            recv[1:] = recv[0] + np.cumsum(d)
            send[1:] = recv[:-1] + oh
            srv[1:] = send[1:] + lat1[1:] + oh
        self.t[client] = recv[-1]
        self.t[server] = srv[-1]
        self.msg_count += 2 * n
        c = self.clocks[client]
        s = self.clocks[server]
        return (c.read_affine(send), s.read_affine(srv), c.read_affine(recv))

    # ------------------------------------------------------------- utilities
    def elapsed_snapshot(self) -> np.ndarray:
        return self.t.copy()

    def max_elapsed_since(self, snap: np.ndarray) -> float:
        """Wall-clock duration of a phase = max over hosts (Fig. 10 x-axis)."""
        return float(np.max(self.t - snap))

    def align(self, ranks: list[int] | None = None) -> None:
        """Bring hosts to a common true time (models a blocking sync point)."""
        ranks = list(range(self.p)) if ranks is None else ranks
        tmax = float(np.max(self.t[ranks]))
        for r in ranks:
            self.t[r] = tmax
