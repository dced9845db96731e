"""Plain PyTorch version of the ``hca_timeline`` kernel.

One round of HCA's clock-sync tree, batched over its (ref, client) pairs:
from each pair's true times, on the latencies drawn for it, the warm-up
and counted ping-pongs of ``compute_rtt`` and the fitpoint sweep of
``collect_fitpoints_batch``, each computed as ``SimNet.pingpong_batch``
and ``_fitpoint_sweep_true`` compute them for one pair. The running sums
are taken one term at a time, left to right (``torch.cumsum`` on the CPU
adds in that order, as ``np.cumsum`` does), and each segment's start
follows from the one before, so on the same latencies this function, the
kernel and the host path agree to the bit.

A pair's row of latencies holds, in the order the host drew them:
``warmup`` each way, ``counted`` each way, the sweep's ``nseg * nx`` each
way, and the closing transfer's one latency (not used here).
"""

from __future__ import annotations

from itertools import accumulate

import torch

__all__ = ["hca_timeline_ref", "row_edges", "row_length"]


def row_edges(warmup: int, counted: int, nseg: int, nx: int) -> list[int]:
    """Where each block of one pair's row starts, in the order the host
    draws them (the warm-up ping-pongs' requests and replies, the counted
    ones', the sweep's, the transfer), and last the row's length."""
    F = nseg * nx
    return list(accumulate((warmup, warmup, counted, counted, F, F, 1), initial=0))


def row_length(warmup: int, counted: int, nseg: int, nx: int) -> int:
    """Latencies in one pair's row: one a message."""
    return row_edges(warmup, counted, nseg, nx)[-1]


def _pingpongs(l1, l2, tc, tr, oh, oh3):
    """``n`` back-to-back exchanges of every pair from ``(tc, tr)``:
    ``(send, recv, tc, tr)``, ``send`` and ``recv`` ``(K, n)``."""
    send0 = tc + oh
    srv0 = torch.maximum(tr, send0 + l1[:, 0]) + oh
    recv0 = (srv0 + l2[:, 0]) + oh
    run = torch.cumsum((oh3 + l1[:, 1:]) + l2[:, 1:], dim=1)
    recv = torch.cat([recv0[:, None], recv0[:, None] + run], dim=1)
    send = torch.cat([send0[:, None], recv[:, :-1] + oh], dim=1)
    tr = (send[:, -1] + l1[:, -1]) + oh if l1.shape[1] > 1 else srv0
    return send, recv, recv[:, -1], tr


def hca_timeline_ref(lat, t_ref, t_cli, *, warmup, counted, nseg, nx, oh):
    """Returns ``(c_send, c_recv, srv, recv, t_ref, t_cli)``: the counted
    ping-pongs' send and receive true times ``(K, counted)``, the sweep's
    server and receive true times ``(K, nseg * nx)``, and each pair's
    server and client true times after the sweep ``(K,)``.

    ``lat`` is ``(K, row_length(...))`` float64, ``t_ref`` and ``t_cli``
    ``(K,)``; ``warmup``, ``counted`` and ``nx`` are at least 1.
    """
    K = lat.shape[0]
    oh3 = 3 * oh
    w1, w2, c1, c2, s1, s2, tx, _ = row_edges(warmup, counted, nseg, nx)
    _, _, tc, tr = _pingpongs(lat[:, w1:w2], lat[:, w2:c1], t_cli, t_ref, oh, oh3)
    c_send, c_recv, tc, tr = _pingpongs(lat[:, c1:c2], lat[:, c2:s1], tc, tr, oh, oh3)
    l1 = lat[:, s1:s2].reshape(K, nseg, nx)
    l2 = lat[:, s2:tx].reshape(K, nseg, nx)
    run = torch.cumsum((l2[..., :-1] + l1[..., 1:]) + oh3, dim=-1)
    srv_off = torch.cat([torch.zeros_like(l1[..., :1]), run], dim=-1)
    ssl = srv_off[..., -1]
    srl = (ssl + l2[..., -1]) + oh
    start = torch.empty_like(ssl)
    for s in range(nseg):
        s0 = torch.maximum(tr, (tc + oh) + l1[:, s, 0]) + oh
        start[:, s] = s0
        tr = s0 + ssl[:, s]
        tc = s0 + srl[:, s]
    srv = start[..., None] + srv_off
    recv = (srv + l2) + oh
    return (c_send, c_recv, srv.reshape(K, nseg * nx), recv.reshape(K, nseg * nx),
            tr.clone(), tc.clone())
