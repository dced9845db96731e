"""Jones & Koenig clock synchronization (§4.3, Algorithms 15-17) [19].

Learns a *linear model of the clock drift* of every rank relative to the
root by linear regression over ``N_FITPTS`` fitpoints, each the median of
``N_EXCHANGES`` ping-pong offset measurements corrected by ``rtt/2``.

The fitpoint loops are interleaved across ranks exactly as in Alg. 15
(``for idx: for r: for i:``), which is what gives every rank's regression a
time base spanning the whole O(p * N_FITPTS * N_EXCHANGES * RTT)
synchronization phase — the source of JK's accuracy *and* of its cost
(Fig. 10: the most precise clocks, but ~30s to synchronize).

Fitpoint collection is executed by a vectorized *sweep engine*
(:func:`collect_fitpoints_batch`): all ``nseg x n_exchanges`` network
latencies of a sweep are sampled up front and the ping-pong recurrence is
rolled forward with one scalar max per *segment* (the only place the
server's availability matters) plus closed-form within-segment cumulative
sums — semantically the same serialization through the root's timeline as
back-to-back :meth:`~repro_torch.core.simnet.SimNet.pingpong_batch` calls, at a
fraction of the Python overhead.
"""

from __future__ import annotations

import numpy as np

from ..clocks import LinearModel, linear_fit
from ..simnet import SimNet
from .base import ClockSync, SyncResult, compute_rtt

__all__ = ["JKSync", "collect_fitpoint", "collect_fitpoints_batch"]


def collect_fitpoint(
    net: SimNet,
    client: int,
    ref: int,
    rtt: float,
    n_exchanges: int,
    init_client: float = 0.0,
    init_ref: float = 0.0,
) -> tuple[float, float]:
    """One fitpoint: median offset over ``n_exchanges`` ping-pongs
    (Alg. 15 lines 11-20 / Alg. 4 lines 10-19), the scalar oracle of
    :func:`collect_fitpoints_batch`.

    Returns ``(xfit, yfit)`` where ``yfit`` is the median of
    ``local_time - tremote - rtt/2`` (client clock minus reference clock)
    and ``xfit`` the client local time at which that median was observed.
    """
    send, srv, recv = net.pingpong_batch(client, ref, n_exchanges)
    local_times = recv - init_client
    diffs = local_times - (srv - init_ref) - rtt / 2.0
    order = np.argsort(diffs)
    mid = order[len(order) // 2]  # the paper selects the element == median
    return float(local_times[mid]), float(diffs[mid])


def _fitpoint_sweep_true(
    net: SimNet,
    ref: int,
    clients_seq: np.ndarray,
    n_exchanges: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Roll a whole fitpoint sweep forward in true time.

    ``clients_seq`` holds one client rank per *segment*; each segment is
    ``n_exchanges`` ping-pongs between that client and ``ref``, executed
    back-to-back in the given order (the root serializes everything).
    Returns per-exchange true times ``(srv, recv)`` of shape
    ``(nseg, n_exchanges)`` and advances ``net.t``/``net.msg_count``.

    Equivalent to one :meth:`SimNet.pingpong_batch` call per segment; only
    the first exchange of a segment needs the ``max`` against the server's
    availability, so the cross-segment recurrence is a cheap scalar loop
    while everything within a segment is a cumulative sum.
    """
    nseg = len(clients_seq)
    nx = int(n_exchanges)
    oh = net.net.proc_overhead
    lat1 = net._latencies(nseg * nx).reshape(nseg, nx)
    lat2 = net._latencies(nseg * nx).reshape(nseg, nx)
    # Within a segment (srv_0 known):
    #   srv_j  = srv_0 + sum_{u<=j} (lat2_{u-1} + lat1_u + 3 oh)
    #   recv_j = srv_j + lat2_j + oh
    incr = np.zeros((nseg, nx))
    if nx > 1:
        incr[:, 1:] = lat2[:, :-1] + lat1[:, 1:] + 3.0 * oh
    srv_off = np.cumsum(incr, axis=1)            # srv_j - srv_0
    lat1_first = lat1[:, 0]
    seg_srv_last = srv_off[:, -1]                # srv_last - srv_0
    seg_recv_last = seg_srv_last + lat2[:, -1] + oh

    # Cross-segment recurrence in plain Python floats (numpy scalar access
    # inside the loop costs ~10x more than list indexing).
    srv0 = np.empty(nseg)
    t = net.t                                     # true-time program counters
    t_ref = float(t[ref])
    client_t: dict[int, float] = {}
    seq = clients_seq.tolist()
    l1f = lat1_first.tolist()
    ssl = seg_srv_last.tolist()
    srl = seg_recv_last.tolist()
    s0_list = srv0.tolist()
    for s in range(nseg):
        c = seq[s]
        r_c = client_t.get(c)
        if r_c is None:
            r_c = float(t[c])
        send0 = r_c + oh
        s0 = max(t_ref, send0 + l1f[s]) + oh
        s0_list[s] = s0
        t_ref = s0 + ssl[s]
        client_t[c] = s0 + srl[s]
    srv0 = np.asarray(s0_list)
    srv = srv0[:, None] + srv_off
    recv = srv + lat2 + oh
    t[ref] = t_ref
    for c, tc in client_t.items():
        t[c] = tc
    net.msg_count += 2 * nseg * nx
    return srv, recv


def collect_fitpoints_batch(
    net: SimNet,
    clients_seq,
    ref: int,
    rtts,
    n_fitpts_total: int,
    n_exchanges: int,
    initial_times: list[float] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized fitpoint collection: ``n_fitpts_total`` fitpoints against
    ``ref``, one per entry of ``clients_seq`` (a single rank, or a sequence
    of length ``n_fitpts_total`` for interleaved multi-client sweeps).

    ``rtts`` is a scalar RTT or a dict ``{client: rtt}``. Returns arrays
    ``(xs, ys)`` of shape ``(n_fitpts_total,)`` with the same per-fitpoint
    median selection as Alg. 15 lines 11-20 (the
    element at the median rank of ``n_exchanges`` offsets).
    """
    clients = np.asarray(
        [clients_seq] * n_fitpts_total if np.isscalar(clients_seq)
        else list(clients_seq), dtype=np.int64)
    if clients.size != n_fitpts_total:
        raise ValueError("clients_seq length must equal n_fitpts_total")
    srv_true, recv_true = _fitpoint_sweep_true(net, ref, clients, n_exchanges)

    # True -> raw local clocks (same affine map as pingpong_batch).
    srv_local = net.clocks[ref].read_affine(srv_true)
    recv_local = np.empty_like(recv_true)
    for c in np.unique(clients):
        sel = clients == c
        recv_local[sel] = net.clocks[c].read_affine(recv_true[sel])

    init_ref = initial_times[ref] if initial_times is not None else 0.0
    if initial_times is not None:
        init_cli = np.asarray(initial_times, dtype=np.float64)[clients][:, None]
    else:
        init_cli = 0.0
    if isinstance(rtts, dict):
        rtt_col = np.asarray([rtts[int(c)] for c in clients])[:, None]
    else:
        rtt_col = float(rtts)
    local_times = recv_local - init_cli
    diffs = local_times - (srv_local - init_ref) - rtt_col / 2.0
    mid = np.argsort(diffs, axis=1)[:, n_exchanges // 2]
    take = np.arange(len(clients))
    return local_times[take, mid], diffs[take, mid]


class JKSync(ClockSync):
    name = "jk"

    def __init__(self, n_fitpts: int = 100, n_exchanges: int = 30):
        self.n_fitpts = n_fitpts
        self.n_exchanges = n_exchanges

    def synchronize(self, net: SimNet, ranks: list[int] | None = None,
                    device=None) -> SyncResult:
        ranks = list(range(net.p)) if ranks is None else ranks
        root = ranks[0]
        others = [r for r in ranks if r != root]
        net.align(ranks)
        snap = net.elapsed_snapshot()
        msgs0 = net.msg_count

        # Alg. 15 lines 24-27: RTT of every pair first.
        rtts = {r: compute_rtt(net, root, r) for r in others}

        # Interleaved fitpoint collection (root serves ranks round-robin,
        # `for idx: for r:` as in Alg. 15), executed as one vectorized sweep.
        if others:
            seq = np.tile(np.asarray(others, dtype=np.int64), self.n_fitpts)
            xs_all, ys_all = collect_fitpoints_batch(
                net, seq, root, rtts, seq.size, self.n_exchanges)
            xs_all = xs_all.reshape(self.n_fitpts, len(others))
            ys_all = ys_all.reshape(self.n_fitpts, len(others))

        models = [LinearModel(0.0, 0.0) for _ in range(net.p)]
        for j, r in enumerate(others):
            models[r] = linear_fit(xs_all[:, j], ys_all[:, j])

        net.align(ranks)
        duration = net.max_elapsed_since(snap)
        return SyncResult(
            algorithm=self.name,
            models=models,
            initial_times=[0.0] * net.p,
            duration=duration,
            n_messages=net.msg_count - msgs0,
            params={"n_fitpts": self.n_fitpts, "n_exchanges": self.n_exchanges},
        )
