"""Discrete-event simulation of a cluster's host control plane (§3, §4).

Host-side numpy, copied from the JAX package's ``repro.core.simnet`` with
the draws in the same order, so that one seed gives both packages the same
clocks, network latencies and synchronization. It models:

  * per-host hardware clocks (offset + skew + optional random walk),
    see :mod:`.clocks`,
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

__all__ = ["NetParams", "ClockParams", "SimNet", "PingPongSample"]


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
    rw_sigma: float = 0.0           # oscillator random walk [s / sqrt(s)]
    freq_est_sigma: float = 0.0     # frequency-estimation error (§4.2.1)


@dataclass
class PingPongSample:
    """Timestamps of one ping-pong exchange (client -> server -> client)."""

    t_send_client: float   # client local clock when the ping was sent
    t_server: float        # server local clock when it stamped the reply
    t_recv_client: float   # client local clock when the reply arrived


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

    def true_time(self, r: int) -> float:
        """Simulator-only ground truth; never exposed to algorithms."""
        return float(self.t[r])

    def true_time_at_local(self, r: int, local: float) -> float:
        """Invert host ``r``'s clock (simulator bookkeeping for waits):
        exact for affine clocks and for walking clocks in drift-path mode;
        a lazy walk is frozen at its last sampled value."""
        return self.clocks[r].true_at_local(local)

    def freeze_drift_paths(self, dt: float, ranks: list[int] | None = None):
        """Switch the given clocks' random walks to pre-sampled drift-path
        mode (node spacing ``dt``); idempotent. The device engine does this
        itself for walking clocks; tests freeze two nets up front so that
        two engines traverse identical walks."""
        ranks = range(self.p) if ranks is None else ranks
        return [self.clocks[r].drift_path(dt) for r in ranks]

    def advance(self, r: int, dt: float) -> None:
        """Host ``r`` computes locally for ``dt`` true seconds."""
        self.t[r] += max(0.0, dt)

    def wait_until_local(self, r: int, local_deadline: float) -> bool:
        """Busy-wait host ``r`` until its local clock shows
        ``local_deadline``; ``False`` if the deadline already passed (the
        window scheme's START_LATE)."""
        target = self.true_time_at_local(r, local_deadline)
        if target <= self.t[r]:
            return False
        self.t[r] = target
        return True

    def sleep_all(self, dt: float) -> None:
        """All hosts idle for ``dt`` true seconds (used between probes)."""
        self.t += dt

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

    def pingpong(self, client: int, server: int) -> PingPongSample:
        """One client->server->client exchange with local timestamps, each
        read through the clock (the walk included)."""
        t_send_client = self.local_time(client)
        self.transfer(client, server)
        t_server = self.local_time(server)
        self.transfer(server, client)
        t_recv_client = self.local_time(client)
        return PingPongSample(t_send_client, t_server, t_recv_client)

    def _latencies(self, n: int) -> np.ndarray:
        lat = self.net.one_way * self.rng.lognormal(0.0, self.net.jitter_sigma, size=n)
        spikes = self.rng.random(n) < self.net.spike_prob
        lat[spikes] *= self.net.spike_scale
        return lat

    def pingpong_batch(self, client: int, server: int, n: int):
        """``n`` back-to-back client->server->client exchanges (the primitive
        under SKAMPI_PINGPONG, COMPUTE_OFFSET, COMPUTE_RTT and the JK/HCA
        fitpoints). Returns local-clock arrays ``(t_send_client, t_server,
        t_recv_client)``, read through each clock's affine part: the walk
        is left out here, as the reference leaves it out."""
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

    # -------------------------------------------------------------- barriers
    def dissemination_barrier(self, ranks: list[int] | None = None) -> np.ndarray:
        """Dissemination barrier (§4.6): ``ceil(log2 p)`` rounds; in round
        ``k`` rank ``i`` signals ``(i + 2^k) mod p`` and proceeds once it
        heard from ``(i - 2^k) mod p``, each round one latency-vector
        update. Returns the per-rank *true* exit times."""
        ranks = list(range(self.p)) if ranks is None else ranks
        n = len(ranks)
        oh = self.net.proc_overhead
        t = self.t[ranks]
        k = 1
        while k < n:
            send_time = t + oh
            # rotate right by k: receiver i hears from (i - k) mod n
            rotated = np.concatenate((send_time[n - k:], send_time[:n - k]))
            arrival = rotated + self._latencies(n)
            t = np.maximum(t + oh, arrival)
            self.msg_count += n
            k *= 2
        self.t[ranks] = t
        return t.copy()

    def _dissemination_barrier_scalar(self, ranks: list[int] | None = None) -> np.ndarray:
        """Per-rank scalar version of :meth:`dissemination_barrier`."""
        ranks = list(range(self.p)) if ranks is None else ranks
        n = len(ranks)
        idx = {r: i for i, r in enumerate(ranks)}
        k = 1
        while k < n:
            send_time = {r: self.t[r] + self.net.proc_overhead for r in ranks}
            for r in ranks:
                src = ranks[(idx[r] - k) % n]
                arrival = send_time[src] + self._latency()
                self.t[r] = max(self.t[r] + self.net.proc_overhead, arrival)
                self.msg_count += 1
            k *= 2
        return self.t[ranks].copy()

    def library_barrier(self, exit_skew: float = 0.0, ranks: list[int] | None = None) -> np.ndarray:
        """An opaque library barrier with an *exit skew* (§4.6): ranks
        leave up to ``exit_skew`` apart, linearly in rank (Fig. 12's
        MVAPICH barrier); with ``exit_skew=0`` the dissemination barrier."""
        ranks = list(range(self.p)) if ranks is None else ranks
        out = self.dissemination_barrier(ranks)
        if exit_skew > 0.0:
            n = len(ranks)
            bias = exit_skew * np.arange(n) / max(1, n - 1)
            bias = bias + self.rng.normal(0.0, 0.05 * exit_skew, size=n)
            self.t[ranks] += np.maximum(0.0, bias)
        return self.t[ranks].copy()

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

    def true_offset(self, r: int, ref: int = 0) -> float:
        """Ground-truth clock offset of ``r`` vs ``ref`` at the current moment."""
        t = max(self.t[r], self.t[ref])
        return self.clocks[r].read(t) - self.clocks[ref].read(t)
