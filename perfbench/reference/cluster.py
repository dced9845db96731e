"""The simulated cluster and its clock synchronization, in plain numpy.

A frozen copy of the semantics the program under test implements (the
paper's §3-§4: hardware clocks with offset, skew and an optional random
walk, a host network with lognormal latencies and OS-noise spikes, and
HCA's hierarchical linear drift models with SKaMPI intercepts), written
from the method so that the benchmark can work out again, from a seed,
every clock model the program fits. The draws are taken in the order the
method prescribes, so one seed gives both sides the same cluster; nothing
here imports the program.
"""

from __future__ import annotations

import math
import zlib

import numpy as np


def derive_stream(parent, *keys) -> np.random.Generator:
    """A child generator: from an integer seed, or one draw of a live
    generator; string keys are folded in by CRC-32."""
    if isinstance(parent, np.random.Generator):
        root = int(parent.integers(2**31))
    else:
        root = int(parent)
    if not keys:
        return np.random.default_rng(root)
    material = [root & 0xFFFFFFFFFFFFFFFF]
    for k in keys:
        if isinstance(k, str):
            material.append(zlib.crc32(k.encode("utf-8")) & 0xFFFFFFFF)
        else:
            material.append(int(k) & 0xFFFFFFFFFFFFFFFF)
    return np.random.default_rng(np.random.SeedSequence(material))


class DriftPath:
    """A clock's random walk sampled on nodes ``dt`` apart, linear between
    them. Each extension appends at least 256 nodes."""

    def __init__(self, sigma, dt, anchor_t, anchor_x, rng):
        self.sigma, self.dt, self.rng = float(sigma), float(dt), rng
        self.t = np.array([anchor_t], dtype=np.float64)
        self.x = np.array([anchor_x], dtype=np.float64)

    def ensure(self, t_max: float) -> None:
        need = int(np.ceil((float(t_max) - float(self.t[-1])) / self.dt))
        if need <= 0:
            return
        n = max(need, 256)
        if self.sigma > 0.0:
            steps = self.rng.normal(0.0, self.sigma * np.sqrt(self.dt), size=n)
            np.clip(steps, -0.45 * self.dt, 0.45 * self.dt, out=steps)
        else:
            steps = np.zeros(n)
        t_new = self.t[-1] + self.dt * np.arange(1, n + 1)
        self.t = np.concatenate((self.t, t_new))
        self.x = np.concatenate((self.x, self.x[-1] + np.cumsum(steps)))

    def value(self, t_true: float) -> float:
        self.ensure(float(t_true))
        return float(np.interp(t_true, self.t, self.x))


class Clock:
    """``local(t) = (offset + (1 + skew) t + walk(t)) (1 + scale_error)``.
    The walk is drawn at each forward read until :meth:`drift_path` fixes
    it on a grid."""

    def __init__(self, offset, skew, rw_sigma, scale_error, seed):
        self.offset, self.skew = offset, skew
        self.rw_sigma, self.scale_error, self.seed = rw_sigma, scale_error, seed
        self.rng = np.random.default_rng(seed)
        self.rw_t = 0.0
        self.rw_x = 0.0
        self.path: DriftPath | None = None

    def _walk(self, t_true: float) -> float:
        if self.rw_sigma <= 0.0:
            return 0.0
        dt = t_true - self.rw_t
        if dt > 0:
            self.rw_x += float(self.rng.normal(0.0, self.rw_sigma * np.sqrt(dt)))
            self.rw_t = t_true
        return self.rw_x

    def read(self, t_true: float) -> float:
        rw = self.path.value(t_true) if self.path is not None else self._walk(t_true)
        raw = self.offset + (1.0 + self.skew) * t_true + rw
        return float(raw * (1.0 + self.scale_error))

    def read_affine(self, t_true):
        return (self.offset + (1.0 + self.skew) * t_true) * (1.0 + self.scale_error)

    def drift_path(self, dt: float) -> DriftPath:
        if self.path is None:
            self.path = DriftPath(self.rw_sigma, max(float(dt), 1e-9), self.rw_t,
                                  self.rw_x, derive_stream(self.seed, "drift-path"))
        return self.path

    def cover_local(self, raw_max: float) -> None:
        """Grow the path until its last node's raw reading reaches ``raw_max``."""
        path = self.path
        path.ensure((raw_max - self.offset) / (1.0 + self.skew) + 2.0 * path.dt)
        while self.offset + (1.0 + self.skew) * path.t[-1] + path.x[-1] < raw_max:
            path.ensure(path.t[-1] + 16.0 * path.dt)


class Cluster:
    """``p`` hosts with clocks and a network; ``t`` holds each host's true
    time. ``net`` and ``clocks`` are the configuration's parameter dicts."""

    def __init__(self, p: int, net: dict, clocks: dict, seed: int):
        self.p = int(p)
        self.one_way, self.jitter = net["one_way"], net["jitter_sigma"]
        self.spike_prob, self.spike_scale = net["spike_prob"], net["spike_scale"]
        self.oh = net["proc_overhead"]
        self.rng = np.random.default_rng(seed)
        spread, fsig = clocks["offset_spread"], clocks["freq_est_sigma"]
        self.clocks = [
            Clock(offset=float(self.rng.uniform(-spread, spread)),
                  skew=float(self.rng.normal(0.0, clocks["skew_sigma"])),
                  rw_sigma=clocks["rw_sigma"],
                  scale_error=float(self.rng.normal(0.0, fsig)) if fsig else 0.0,
                  seed=int(self.rng.integers(0, 2**31 - 1)))
            for _ in range(self.p)]
        self.t = np.zeros(self.p, dtype=np.float64)

    def local_time(self, r: int) -> float:
        return self.clocks[r].read(self.t[r])

    def align(self) -> None:
        self.t[:] = float(np.max(self.t))

    def latency(self) -> float:
        lat = self.one_way * float(self.rng.lognormal(0.0, self.jitter))
        if self.rng.random() < self.spike_prob:
            lat *= self.spike_scale
        return lat

    def latencies(self, n: int) -> np.ndarray:
        lat = self.one_way * self.rng.lognormal(0.0, self.jitter, size=n)
        lat[self.rng.random(n) < self.spike_prob] *= self.spike_scale
        return lat

    def transfer(self, src: int, dst: int) -> None:
        send_done = self.t[src] + self.oh
        self.t[src] = send_done
        self.t[dst] = max(self.t[dst], send_done + self.latency()) + self.oh

    def pingpongs(self, client: int, server: int, n: int):
        """``n`` back-to-back exchanges; local (affine) stamps of the send,
        the server's reply and the receipt."""
        oh = self.oh
        lat1, lat2 = self.latencies(n), self.latencies(n)
        send, srv, recv = np.empty(n), np.empty(n), np.empty(n)
        send[0] = self.t[client] + oh
        srv[0] = max(self.t[server], send[0] + lat1[0]) + oh
        recv[0] = srv[0] + lat2[0] + oh
        if n > 1:
            recv[1:] = recv[0] + np.cumsum(3 * oh + lat1[1:] + lat2[1:])
            send[1:] = recv[:-1] + oh
            srv[1:] = send[1:] + lat1[1:] + oh
        self.t[client], self.t[server] = recv[-1], srv[-1]
        c, s = self.clocks[client], self.clocks[server]
        return c.read_affine(send), s.read_affine(srv), c.read_affine(recv)


def _tukey_mean(x: np.ndarray) -> float:
    if x.size >= 4:
        q1, q3 = np.percentile(x, [25.0, 75.0])
        iqr = q3 - q1
        lo, hi = float(q1 - 1.5 * iqr), float(q3 + 1.5 * iqr)
        kept = x[(x >= lo) & (x <= hi)]
    else:
        kept = x
    return float(np.mean(kept)) if kept.size else float(np.mean(x))


def _rtt(cl: Cluster, ref: int, client: int) -> float:
    """Mean round trip after Tukey's filter: 10 warm-up exchanges, 100 counted."""
    cl.pingpongs(client, ref, 10)
    send, _, recv = cl.pingpongs(client, ref, 100)
    return _tukey_mean(recv - send)


def _skampi_offset(cl: Cluster, ref: int, client: int, init, n: int, dt) -> float:
    """Midpoint of the tightest bounds on ``clock_client - clock_ref``."""
    send, srv, recv = cl.pingpongs(ref, client, n)
    send, recv = send.astype(dt) - dt(init[ref]), recv.astype(dt) - dt(init[ref])
    srv = srv.astype(dt) - dt(init[client])
    return dt(0.5) * (np.max(srv - recv) + np.min(srv - send))


def _fitpoints(cl: Cluster, client: int, ref: int, rtt: float, nfit: int, nx: int,
               init, dt) -> tuple[np.ndarray, np.ndarray]:
    """``nfit`` fitpoints, each the median offset of ``nx`` exchanges, all
    back to back: every network latency is drawn first (the sends', then
    the replies'), and only a segment's first exchange waits on the server."""
    oh = cl.oh
    lat1 = cl.latencies(nfit * nx).reshape(nfit, nx)
    lat2 = cl.latencies(nfit * nx).reshape(nfit, nx)
    incr = np.zeros((nfit, nx))
    if nx > 1:
        incr[:, 1:] = lat2[:, :-1] + lat1[:, 1:] + 3.0 * oh
    srv_off = np.cumsum(incr, axis=1)
    seg_srv_last = srv_off[:, -1].tolist()
    seg_recv_last = (srv_off[:, -1] + lat2[:, -1] + oh).tolist()
    first = lat1[:, 0].tolist()
    t_ref, t_cli = float(cl.t[ref]), float(cl.t[client])
    srv0 = []
    for s in range(nfit):
        s0 = max(t_ref, t_cli + oh + first[s]) + oh
        srv0.append(s0)
        t_ref = s0 + seg_srv_last[s]
        t_cli = s0 + seg_recv_last[s]
    srv = np.asarray(srv0)[:, None] + srv_off
    recv = srv + lat2 + oh
    cl.t[ref], cl.t[client] = t_ref, t_cli
    srv_local = cl.clocks[ref].read_affine(srv)
    recv_local = cl.clocks[client].read_affine(recv)
    local = recv_local.astype(dt) - dt(init[client])
    diffs = local - (srv_local.astype(dt) - dt(init[ref])) - dt(rtt / 2.0)
    mid = np.argsort(diffs, axis=1)[:, nx // 2]
    take = np.arange(nfit)
    return local[take, mid], diffs[take, mid]


def _linear_fit(x: np.ndarray, y: np.ndarray):
    """Least squares, centred; in the type of ``x`` and ``y``."""
    dt = x.dtype.type
    xm, ym = x.mean(), y.mean()
    dx = x - xm
    denom = np.dot(dx, dx)
    if x.size < 2 or denom == 0.0:
        return dt(0.0), ym
    slope = np.dot(dx, y - ym) / denom
    return slope, ym - slope * xm


def _merge(mid, child):
    """The model of a child relative to the root through an intermediate rank."""
    s1, i1 = mid
    s2, i2 = child
    return s1 + s2 - s1 * s2, i1 + i2 - s1 * i2


class Sync:
    """Per-rank linear drift models ``(slope, intercept)`` on clocks that
    start at ``init`` (each rank's first reading)."""

    def __init__(self, slope, intercept, init):
        self.slope, self.intercept, self.init = slope, intercept, init

    def global_time(self, cl: Cluster, r: int) -> float:
        adj = cl.local_time(r) - self.init[r]
        return adj - (adj * self.slope[r] + self.intercept[r])

    def local_deadline(self, r: int, target: float) -> float:
        return (target + self.intercept[r]) / (1.0 - self.slope[r]) + self.init[r]


def hca(cl: Cluster, n_fitpts: int, n_exchanges: int, intercept_pingpongs: int = 100,
        dtype=np.float64) -> Sync:
    """HCA (Algs. 2-4): slopes merged up a binary tree in O(log p) rounds,
    the ranks past the largest power of two in one more round, then every
    rank's intercept re-anchored by a SKaMPI offset to the root. The fits
    and models are computed in ``dtype`` (the simulated network in float64)."""
    dt = np.dtype(dtype).type
    p = cl.p
    cl.align()
    init = [cl.local_time(r) for r in range(p)]
    maxpower = 2 ** int(math.floor(math.log2(p))) if p > 1 else 1
    zero = (dt(0.0), dt(0.0))
    subtree = {i: {i: zero} for i in range(p)}
    rnd = 1
    while 2 ** rnd <= maxpower:
        half = 2 ** (rnd - 1)
        for ref in range(0, maxpower, 2 ** rnd):
            cli = ref + half
            rtt = _rtt(cl, ref, cli)
            lm = _linear_fit(*_fitpoints(cl, cli, ref, rtt, n_fitpts, n_exchanges, init, dt))
            cl.transfer(cli, ref)
            for m, sub in subtree[cli].items():
                subtree[ref][m] = _merge(lm, sub)
        rnd += 1
    for j in range(p - maxpower):
        q = maxpower + j
        rtt = _rtt(cl, j, q)
        lm = _linear_fit(*_fitpoints(cl, q, j, rtt, n_fitpts, n_exchanges, init, dt))
        cl.transfer(q, 0)
        subtree[0][q] = _merge(subtree[0][j], lm)
    models = [subtree[0].get(i, zero) for i in range(p)]
    for r in range(1, p):
        diff = _skampi_offset(cl, 0, r, init, intercept_pingpongs, dt)
        stamp = dt(cl.local_time(r)) - dt(init[r])
        slope = models[r][0]
        models[r] = (slope, slope * (-stamp) + diff)
    cl.align()
    return Sync(np.array([float(m[0]) for m in models]), np.array([float(m[1]) for m in models]),
                np.array(init, dtype=np.float64).astype(dtype).astype(np.float64))
