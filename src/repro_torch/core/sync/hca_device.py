"""HCA's fitpoint tree on a torch device, one round at a time.

The host path (:meth:`~repro_torch.core.sync.hca.HCASync.synchronize`
without a device) runs the tree's pairs one after another in numpy: per
pair an RTT from 10 + 100 ping-pongs, a fitpoint sweep, a linear fit, one
transfer and the merges into the parent's model table. The pairs of one
round are disjoint, so nothing but the order of their draws ties them
together. Here each round is one batch of device work:

* the host draws every pair's latencies in the host path's order, from
  the same generator (a lognormal as ``standard_normal``, which consumes
  the same stream, then ``random`` for the spikes), into one staging
  tensor a round, pinned on CUDA and uploaded by one non-blocking copy,
  so that the host draws round ``k + 1`` while the device computes round
  ``k``;
* the device forms the latencies (the lognormal's ``exp``, ``one_way``,
  the spikes), runs the pairs' true-time timelines through the
  ``hca_timeline`` kernel (the host path's sums in its order), reads the
  clocks, takes Tukey's mean of the RTTs, the median-rank offset of each
  fitpoint and the least-squares fit, applies the transfers and merges
  every member of each client's subtree into its new root's table;
* the true times and the model table stay on the device until the tree
  ends and come back in one read.

The generator ends where the host path leaves it, ``msg_count`` grows by
the host path's count, and ``net.t`` and the models agree with the host
path's to rounding: the sums in the kernel round as numpy's do, while the
device's ``exp`` and its reductions (Tukey's mean, the fit's sums) may
differ in the last bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...kernels.hca_timeline import hca_timeline, row_edges
from ..clocks import LinearModel
from ..simnet import SimNet
from ..telemetry import count
from .base import RTT_PINGPONGS, RTT_WARMUP

__all__ = ["run_tree"]


def _rounds(p: int) -> list[tuple[list[int], list[int], bool]]:
    """The tree's rounds as local indices: ``(refs, clients, to_root)``;
    ``to_root`` marks the last round of a non-power-of-two ``p``, whose
    clients send their tables to index 0."""
    maxpower = 2 ** int(math.floor(math.log2(p))) if p > 1 else 1
    out = []
    step = 2
    while step <= maxpower:
        refs = list(range(0, maxpower, step))
        out.append((refs, [r + step // 2 for r in refs], False))
        step *= 2
    if p > maxpower:
        out.append((list(range(p - maxpower)), list(range(maxpower, p)), True))
    return out


def _pinned(shape, dtype, device: torch.device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


def _upload(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    return host.to(device, non_blocking=True)


def _draw(rng: np.random.Generator, host: np.ndarray, slices) -> None:
    """Fill ``host`` ``(2, K, row)``, normals then uniforms, pair by pair
    and slice by slice in the host path's order."""
    normal, uniform = rng.standard_normal, rng.random
    for z, u in zip(host[0], host[1]):
        for sl in slices:
            normal(out=z[sl])
            uniform(out=u[sl])


def _tukey_mean(x: torch.Tensor) -> torch.Tensor:
    """Per row of ``x`` ``(K, n)``, ``n >= 4``: the mean of what Tukey's
    fences at 1.5 IQR keep (``tukey_filter`` and ``np.mean``); the
    quartiles' linear interpolation is ``np.percentile``'s."""
    q1, q3 = torch.quantile(x, torch.tensor([0.25, 0.75], dtype=x.dtype, device=x.device),
                            dim=1)
    iqr = q3 - q1
    lo, hi = q1 - 1.5 * iqr, q3 + 1.5 * iqr
    keep = (x >= lo[:, None]) & (x <= hi[:, None])
    n_kept = keep.sum(dim=1)
    kept_mean = torch.where(keep, x, 0.0).sum(dim=1) / n_kept.clamp_min(1)
    return torch.where(n_kept > 0, kept_mean, x.mean(dim=1))


def _fit(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``linear_fit`` per row of ``(K, n)``, ``n >= 2``: centred least
    squares, slope 0 and the mean where ``x`` does not vary."""
    xm = x.mean(dim=1)
    ym = y.mean(dim=1)
    dx = x - xm[:, None]
    denom = (dx * dx).sum(dim=1)
    flat = denom == 0
    slope = (dx * (y - ym[:, None])).sum(dim=1) / torch.where(flat, 1.0, denom)
    slope = torch.where(flat, 0.0, slope)
    return slope, torch.where(flat, ym, ym - slope * xm)


def run_tree(net: SimNet, ranks: list[int], initial_times: list[float],
             n_fitpts: int, n_exchanges: int, device) -> list[LinearModel]:
    """Run HCA's tree over ``ranks`` (``len(ranks) >= 2``, ``n_fitpts >= 2``,
    ``n_exchanges >= 1``) on ``device``: advances ``net``'s generator,
    true times and message count as the host path does, and returns each
    local index's model relative to ``ranks[0]``. Counts the pairs in
    ``sync.hca.pairs_on_device`` and the staged draws' bytes in
    ``sync.hca.h2d_bytes``."""
    device = torch.device(device)
    p, P = len(ranks), net.p
    nseg, nx = int(n_fitpts), int(n_exchanges)
    edges = row_edges(RTT_WARMUP, RTT_PINGPONGS, nseg, nx)
    L = edges[-1]
    prm = net.net
    oh = prm.proc_overhead
    rounds = _rounds(p)
    slices = [slice(a, b) for a, b in zip(edges, edges[1:])]

    # the clocks, the true times and every round's indices, uploaded once
    clocks = net.clocks
    static = _pinned((5, P), torch.float64, device)
    st = static.numpy()
    st[0] = net.t
    st[1] = [c.offset for c in clocks]
    st[2] = [1.0 + c.skew for c in clocks]
    st[3] = [1.0 + c.scale_error for c in clocks]
    st[4] = initial_times
    # a round's indices: its refs' and clients' ranks, the local indices
    # whose models change (the clients' subtrees), and for each the pair
    # it merges with (in the last round of a non-power-of-two p: its ref)
    index = []
    for refs, clis, to_root in rounds:
        if to_root:
            changed, via = clis, refs
        else:
            step = 2 * (clis[0] - refs[0])
            changed = [m for m in range(refs[-1] + step) if m % step >= step // 2]
            via = [m // step for m in changed]
        index += [[ranks[i] for i in refs], [ranks[i] for i in clis], changed, via]
    index.append(list(ranks))
    idx_host = _pinned(sum(len(a) for a in index), torch.int64, device)
    idx_host.numpy()[:] = [i for a in index for i in a]
    static_d, idx_d = _upload(static, device), _upload(idx_host, device)
    t, off, rate, scl, init = static_d.unbind(0)
    t = t.clone()
    cuts = np.cumsum([0] + [len(a) for a in index]).tolist()
    views = [idx_d[a:b] for a, b in zip(cuts, cuts[1:])]
    S = torch.zeros(p, dtype=torch.float64, device=device)
    I = torch.zeros(p, dtype=torch.float64, device=device)

    def read(x, who):
        return (off[who][:, None] + rate[who][:, None] * x) * scl[who][:, None]

    for k, (refs, _, to_root) in enumerate(rounds):
        R, C, changed, via = views[4 * k:4 * k + 4]
        K = len(refs)
        host = _pinned((2, K, L), torch.float64, device)
        _draw(net.rng, host.numpy(), slices)
        draws = _upload(host, device)
        count("sync.hca.pairs_on_device", K)
        count("sync.hca.h2d_bytes", host.numel() * host.element_size())

        lat = prm.one_way * torch.exp(prm.jitter_sigma * draws[0])
        lat = torch.where(draws[1] < prm.spike_prob, lat * prm.spike_scale, lat)
        c_send, c_recv, srv, recv, t_r, t_c = hca_timeline(
            lat, t[R], t[C], warmup=RTT_WARMUP, counted=RTT_PINGPONGS, nseg=nseg, nx=nx,
            oh=oh)
        rtt = _tukey_mean(read(c_recv, C) - read(c_send, C))
        local = read(recv, C) - init[C][:, None]
        diffs = (local - (read(srv, R) - init[R][:, None])) - (rtt / 2.0)[:, None]
        ys, mid = torch.kthvalue(diffs.view(K, nseg, nx), nx // 2 + 1, dim=2)
        xs = local.view(K, nseg, nx).gather(2, mid[..., None])[..., 0]
        slope, icpt = _fit(xs, ys)

        # the closing transfer, client to ref (to the root in the last
        # round of a non-power-of-two p)
        send_done = t_c + oh
        arrival = send_done + lat[:, -1]
        t[C] = send_done
        if not to_root:
            # the clients' tables join their refs'; each member m of a
            # client's subtree gets MERGE_LMS(pair's model, m's model)
            t[R] = torch.maximum(t_r, arrival) + oh
            s1, i1, s2, i2 = slope[via], icpt[via], S[changed], I[changed]
            S[changed] = (s1 + s2) - s1 * s2
            I[changed] = (i1 + i2) - s1 * i2
        else:
            # every client sends to the root in turn: a serial max chain
            t[R] = t_r
            root = ranks[0]
            T = t[root]
            for j in range(K):
                T = torch.maximum(T, arrival[j]) + oh
            t[root] = T
            s1, i1 = S[via], I[via]
            S[changed] = (s1 + slope) - s1 * slope
            I[changed] = (i1 + icpt) - s1 * icpt

    out = torch.cat([t[views[-1]], S, I]).cpu().numpy()
    net.t[ranks] = out[:p]
    net.msg_count += sum(len(r[0]) for r in rounds) * L     # a message a latency
    return [LinearModel(float(s), float(i)) for s, i in zip(out[p:2 * p], out[2 * p:])]
