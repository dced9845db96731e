"""Device engine of the simulated measurement campaign (PyTorch port of
the JAX package's ``repro.simjax.engine``).

One measurement of a case is two steps on the device:

  * ``sample`` — per cost-model term: draw the AR(1) innovations and the
    mixture uniforms, then run the fused AR(1) scan and tail/spike mixture
    (:func:`~repro_torch.kernels.sim_scan.sim_durations_scan`: the CUDA
    kernel on a GPU, its plain version on the CPU);
  * ``window`` — deadline conversion, the cross-call entry recurrence
    ``all_in_i = C_i + max(max_r t0_r, cummax_i(dmax - C))``, per-rank
    finish imbalance, START_LATE / TOOK_TOO_LONG flags and global-time
    estimates over the ``(nrep, p)`` grid, as PyTorch ops.

Host-side work per call is O(p): clock/sync coefficients, per-term epoch
biases and the AR(1) carry in and out. The host RNG order per epoch is the
reference's — the window seed ``net.rng.integers(2**31)``, then each
term's epoch bias — so both packages draw the same biases from one seed.

Device draws use one explicit ``torch.Generator`` per (window seed, term
index), and the imbalance draw its own, seeded from (window seed, number
of terms). They are Philox (CUDA) or Mersenne Twister (CPU) streams, not
JAX's threefry, so the port is a different draw of the same process as the
reference, never bit-identical to it.

:func:`run_windowed_torch` is the per-epoch engine: float64 throughout,
and a full :class:`~repro_torch.core.window.WindowRun`. It also runs
random-walk clocks (the reference's ``batch_rw`` engine): each walk is
grown on the host as a :class:`~repro_torch.core.clocks.DriftPath`, with
the reference's sequence of ``ensure`` calls so the node values are the
reference's to the bit, mirrored on the device (each node sent once),
and inverted (deadlines) and interpolated (start/end stamps) there; the
forward reads' growth needs the per-rank maxima of the true stamps back
from the device. :func:`sample_durations_torch` draws the durations
and finish-imbalance factors of ``nrep`` calls for callers outside the
window (the barrier scheme, :mod:`repro_torch.core.timing`).
:func:`run_windowed_epochs_torch` measures one case across all launch
epochs: every term is sampled for all epochs in one kernel launch, each
epoch from its own generator, so a lane's durations are bit-identical to
what the per-epoch engine draws for that epoch. The window then runs per
epoch through the per-epoch engine's own float64 window on the device, and
only the O(nrep) times and flags come back to the host: a fused record is
the per-epoch record, bit for bit, so how a campaign was scheduled (fused,
per epoch, or across a fleet's retried attempts) never changes what it
measured.
"""

from __future__ import annotations

import os
import weakref
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from .core.window import START_LATE, TOOK_TOO_LONG, WindowRun
from .kernels.sim_scan.kernel import sim_durations_scan

__all__ = [
    "SimTorchUnavailable",
    "resolve_device",
    "run_windowed_torch",
    "run_windowed_epochs_torch",
    "sample_durations_torch",
    "scan_host_draws",
    "FusedWindowRun",
    "engine_stats",
    "reset_engine_stats",
]

_F64 = torch.float64
_F32 = torch.float32


class SimTorchUnavailable(RuntimeError):
    """The torch engine cannot run this request: the fused multi-epoch
    engine on random-walk clocks (``rw_sigma > 0``). Raised, never worked
    around."""


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index filled in. Raises
    when CUDA is asked for and there is none: a run meant for the card
    never carries on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev


def _bucket(nrep: int) -> int:
    """Sampling length for ``nrep``: next power of two (>= 32) below 1024,
    exact above — both engines draw at this length, so the durations of a
    bucket are a prefix of the same draws."""
    if nrep >= 1024:
        return nrep
    n = 32
    while n < nrep:
        n *= 2
    return n


class _EngineStats:
    """Process-global dispatch telemetry: every sample and window call is
    counted, and the distinct (step, shape) keys are collected. Monotone,
    so a snapshot-delta is a campaign's share."""

    __slots__ = ("dispatches", "shape_keys")

    def __init__(self) -> None:
        self.dispatches = 0
        self.shape_keys: set = set()

    def count(self, key: tuple) -> None:
        self.dispatches += 1
        self.shape_keys.add(key)


_STATS = _EngineStats()

#: Per-net device mirrors of the drift paths (:class:`_DevicePaths`),
#: freed with the net.
_MIRRORS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def engine_stats() -> dict:
    """Cumulative telemetry: ``n_dispatches`` (sample + window calls) and
    ``n_shapes`` (distinct step x shape signatures among them)."""
    return {"n_shapes": len(_STATS.shape_keys),
            "n_dispatches": _STATS.dispatches}


def reset_engine_stats() -> None:
    _STATS.dispatches = 0
    _STATS.shape_keys.clear()


def _terms(op, p: int, msize: int):
    """Flatten an op into ``(term, term_p, term_msize)`` triples —
    composites sample each constituent at its own size/count and sum."""
    sub_terms = getattr(op, "terms", None)
    if not sub_terms:
        return [(op, p, msize)]
    return [(sub, op._term_p(p, ps), max(0, int(round(ms * msize))))
            for sub, ms, ps in sub_terms]


def _generator(device: torch.device, *key: int) -> torch.Generator:
    """An explicit generator on ``device`` seeded from the integer ``key``."""
    seed = np.random.SeedSequence([int(k) for k in key]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _walking(net, ranks) -> bool:
    return any(net.clocks[r].rw_sigma > 0.0 for r in ranks)


def _check_affine(nets, ranks) -> None:
    for net in nets:
        if _walking(net, ranks):
            raise SimTorchUnavailable(
                "the fused torch engine requires affine clocks (rw_sigma == "
                "0); measure random-walk clocks per epoch with "
                "run_windowed_torch")


def _sample(seeds, j, subs, nets, tp, tm, n, nrep, device) -> torch.Tensor:
    """Durations ``(E, n)`` of term ``j`` for each epoch ``e`` (window seed
    ``seeds[e]``, op ``subs[e]``, net ``nets[e]``); writes each op's AR(1)
    carry-out (state after repetition ``nrep - 1``)."""
    s0 = subs[0]
    t0 = torch.tensor([sub.base_time(tp, tm) * sub._bias_for(net)
                       for sub, net in zip(subs, nets)], dtype=_F64, device=device)
    state = torch.tensor([sub._ar_state for sub in subs], dtype=_F64,
                         device=device)
    noise = torch.empty((4, len(seeds), n), dtype=_F64, device=device)
    for e, seed in enumerate(seeds):
        gen = _generator(device, seed, j)
        noise[0, e].normal_(0.0, s0.noise_sigma, generator=gen)
        for k in (1, 2, 3):
            noise[k, e].uniform_(generator=gen)
    _STATS.count(("sample", len(seeds), n))
    t, s = sim_durations_scan(
        noise[0], noise[1], noise[2], noise[3], coeff=s0.autocorr,
        state=state, t0=t0, tail_prob=s0.tail_prob, tail_shift=s0.tail_shift,
        spike_prob=s0.spike_prob, spike_scale=s0.spike_scale)
    for sub, last in zip(subs, s[:, nrep - 1].tolist()):
        sub._ar_state = last
    return t


def _draw(net, op, msize, p, nrep, device):
    """One epoch's draws for ``nrep`` calls, in the host order of the
    reference's engines: the window seed from ``net.rng``, then each
    term's epoch bias as it is sampled. Returns the summed durations at
    the bucketed length and the imbalance generator of (seed, number of
    terms)."""
    n = _bucket(nrep)
    seed = int(net.rng.integers(2**31))
    terms = _terms(op, p, msize)
    durations = sum(_sample([seed], j, [sub], [net], tp, tm, n, nrep, device)[0]
                    for j, (sub, tp, tm) in enumerate(terms))
    return durations, _generator(device, seed, len(terms))


def _rank_arrays(nets, syncs, ranks, device) -> dict:
    """Per-rank clock and sync coefficients as ``(E, p)`` float64 tensors."""
    def rows(fn):
        return torch.tensor([[fn(net, sync, r) for r in ranks]
                             for net, sync in zip(nets, syncs)],
                            dtype=_F64, device=device)

    return dict(
        t0=rows(lambda net, sync, r: net.t[r]),
        off=rows(lambda net, sync, r: net.clocks[r].offset),
        skew=rows(lambda net, sync, r: net.clocks[r].skew),
        scale=rows(lambda net, sync, r: net.clocks[r].scale_error),
        slope=rows(lambda net, sync, r: sync.models[r].slope),
        intercept=rows(lambda net, sync, r: sync.models[r].intercept),
        init_t=rows(lambda net, sync, r: sync.initial_times[r]),
    )


def _imbalance(gen, n, p, rank_imbalance, device) -> torch.Tensor:
    """Per-rank finish-imbalance factors ``(n, p)``, float64:
    ``max(0.25, 1 + rank_imbalance * z)`` with ``z`` a float32 normal draw."""
    z = torch.empty((n, p), dtype=_F32, device=device).normal_(generator=gen)
    imb = rank_imbalance * z.to(_F64)
    return torch.clamp_min(1.0 + imb, 0.25)


class _DevicePaths:
    """The drift paths of a net's ranks mirrored on the device: node true
    times ``T`` and walk values ``X`` as ``(p, capacity)`` float64, padded
    past each rank's length with ``T = inf`` (so a binary search never
    lands there), and each rank's node count ``lens``.

    The paths grow on the host (:func:`grow_paths_for_deadlines`,
    :func:`grow_paths_for_reads`) and only ever append, so :meth:`upload`
    copies the nodes appended since its last call (one host-to-device copy
    of their concatenation) and a net's mirror is kept between calls
    (:meth:`of`): each node crosses to the device once."""

    def __init__(self, clocks, device):
        self.clocks = clocks
        self.paths = [c._path for c in clocks]
        self.device = device
        p = len(clocks)
        self.T = torch.full((p, 0), torch.inf, dtype=_F64, device=device)
        self.X = torch.zeros((p, 0), dtype=_F64, device=device)
        self.sent = [0] * p
        self.dt = torch.tensor([pth.dt for pth in self.paths], dtype=_F64,
                               device=device)[:, None]

    @classmethod
    def of(cls, net, ranks, device) -> "_DevicePaths":
        """The mirror of ``net``'s drift paths for ``ranks`` on ``device``,
        reused while it mirrors the same path objects."""
        clocks = [net.clocks[r] for r in ranks]
        mirror = _MIRRORS.get(net)
        if (mirror is None or mirror.device != device
                or len(mirror.clocks) != len(clocks)
                or any(a is not b or a._path is not pth for a, b, pth in
                       zip(clocks, mirror.clocks, mirror.paths))):
            mirror = _MIRRORS[net] = cls(clocks, device)
        return mirror

    def stale(self) -> bool:
        return any(pth.t.size != n for pth, n in zip(self.paths, self.sent))

    def upload(self) -> None:
        lens = [pth.t.size for pth in self.paths]
        need = max(lens)
        if need > self.T.shape[1]:          # room for top-ups to append
            cap = need + need // 4 + 1024
            T = torch.full((len(lens), cap), torch.inf, dtype=_F64,
                           device=self.device)
            X = torch.zeros((len(lens), cap), dtype=_F64, device=self.device)
            T[:, :self.T.shape[1]] = self.T
            X[:, :self.X.shape[1]] = self.X
            self.T, self.X = T, X
        new_t = np.concatenate([pth.t[n:] for pth, n in zip(self.paths, self.sent)])
        new_x = np.concatenate([pth.x[n:] for pth, n in zip(self.paths, self.sent)])
        new_t = torch.from_numpy(new_t).to(self.device)
        new_x = torch.from_numpy(new_x).to(self.device)
        at = 0
        for i, (n, m) in enumerate(zip(self.sent, lens)):
            self.T[i, n:m] = new_t[at:at + m - n]
            self.X[i, n:m] = new_x[at:at + m - n]
            at += m - n
        self.sent = lens
        self.lens = torch.tensor(lens, device=self.device)[:, None]

    def true_at_raw(self, raw, off, skew) -> torch.Tensor:
        """``SimClock.true_at_local`` on raw readings ``raw`` ``(n, p)``:
        the last node reading at or below each target by binary search,
        then the in-segment affine solve."""
        T, X, lens = self.T, self.X, self.lens
        F = off[:, None] + (1.0 + skew)[:, None] * T + X
        q = raw.T.contiguous()
        idx = torch.searchsorted(F, q, right=True) - 1
        idx = torch.minimum(idx.clamp_min(0), lens - 2)
        x0, x1 = X.gather(1, idx), X.gather(1, idx + 1)
        seg_slope = (1.0 + skew)[:, None] + (x1 - x0) / self.dt
        return (T.gather(1, idx) + (q - F.gather(1, idx)) / seg_slope).T

    def value(self, t_true) -> torch.Tensor:
        """``DriftPath.value`` (``np.interp``) at true times ``(n, p)``."""
        T, X, lens = self.T, self.X, self.lens
        q = t_true.T.contiguous()
        j = torch.searchsorted(T, q, right=True) - 1
        jc = torch.minimum(j.clamp_min(0), lens - 2)
        t0, t1 = T.gather(1, jc), T.gather(1, jc + 1)
        x0, x1 = X.gather(1, jc), X.gather(1, jc + 1)
        out = (x1 - x0) / (t1 - t0) * (q - t0) + x0
        out = torch.where(t0 == q, x0, out)
        out = torch.where(j >= lens - 1, X.gather(1, lens - 1), out)
        out = torch.where(j < 0, X[:, :1], out)
        return out.T


def grow_paths_for_deadlines(clocks, sync, ranks, targets_last) -> None:
    """Grow each walking clock's drift path on the host for the deadline
    inversion of the window targets up to ``targets_last``, as the
    reference's ``true_at_local`` does (the deadlines rise with the
    target, so the last target's is the largest). Each path draws from
    its own stream, so the paths grow on a thread pool (numpy releases
    the GIL while it draws) without changing a node."""
    def grow(clk_r):
        clk, r = clk_r
        clk.cover_local(sync.local_deadline(r, targets_last)
                        / (1.0 + clk.scale_error))

    workers = min(8, os.cpu_count() or 1, max(1, len(clocks) // 32))
    if workers == 1:
        for pair in zip(clocks, ranks):
            grow(pair)
        return
    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(grow, zip(clocks, ranks)))


def grow_paths_for_reads(clocks, start_max, end_max) -> None:
    """Grow each drift path for the forward reads of the start stamps, then
    of the end stamps (per-rank maxima), as the reference's ``read`` of
    each column does."""
    for clk, a, b in zip(clocks, start_max.tolist(), end_max.tolist()):
        clk._path.ensure(a)
        clk._path.ensure(b)


def _exclusive_cumsum(e: torch.Tensor) -> torch.Tensor:
    """``[0, e0, e0 + e1, ...]`` (length ``len(e)``), summed in order on
    the host. CUDA's one-dimensional ``torch.cumsum`` (CUB's decoupled
    look-back) associates float sums in an order that changes from run to
    run: on the card it broke the fused engine's bit-equality with the
    per-epoch engine in about one epoch in twelve (1-ulp differences in a
    few dozen of 20 000 times). numpy's sequential sum is the same on
    every run, on either device's tensors."""
    host = np.concatenate([[0.0], np.cumsum(e[:-1].cpu().numpy())])
    return torch.from_numpy(host).to(e.device)


def _window(durations, gen, t0, off, skew, scale, slope, intercept, init_t,
            rank_imbalance, start_time, win_size, walk=None):
    """The per-epoch window over the whole ``(n, p)`` grid, float64.
    Returns ``(times, errors, start_global, end_global, start_true,
    end_true)``.

    ``walk`` is ``None`` for affine clocks, else ``(paths, nrep)``: the
    ranks' :class:`_DevicePaths`, grown for the deadline inversion, and the
    rows that count (the paths grow for the reads of these rows only)."""
    n, p = durations.shape[0], t0.shape[0]
    dev = durations.device
    targets = start_time + win_size * torch.arange(n, dtype=_F64, device=dev)
    # deadline: sync-model denormalize, then the clock inverse
    dl_local = (targets[:, None] + intercept) / (1.0 - slope) + init_t
    raw = dl_local / (1.0 + scale)
    if walk is None:
        deadline_true = (raw - off) / (1.0 + skew)
    else:
        paths, nrep = walk
        deadline_true = paths.true_at_raw(raw, off, skew)
    span = durations[:, None] * _imbalance(gen, n, p, rank_imbalance, dev)
    e = span.amax(dim=1)
    dmax = deadline_true.amax(dim=1)
    C = _exclusive_cumsum(e)
    all_in = C + torch.clamp_min(torch.cummax(dmax - C, dim=0).values,
                                 t0.max())
    end = all_in[:, None] + span
    prev_end = torch.cat([t0[None, :], end[:-1]], dim=0)
    start = torch.maximum(deadline_true, prev_end)
    late = (deadline_true <= prev_end).any(dim=1)

    def to_global(t_true, rw=None):
        if rw is None:
            local = (off + (1.0 + skew) * t_true) * (1.0 + scale)
        else:
            local = (off + (1.0 + skew) * t_true + rw) * (1.0 + scale)
        adj = local - init_t
        return adj - (adj * slope + intercept)

    if walk is None:
        sg = to_global(start)
        eg = to_global(end)
    else:
        peaks = torch.stack([start[:nrep].amax(dim=0),
                             end[:nrep].amax(dim=0)]).cpu().numpy()
        grow_paths_for_reads(paths.clocks, peaks[0], peaks[1])
        if paths.stale():       # the reads outran the deadlines' growth
            paths.upload()
        sg = to_global(start, paths.value(start))
        eg = to_global(end, paths.value(end))
    took = (eg > (targets + win_size)[:, None]).any(dim=1)
    errors = late.to(torch.int64) * START_LATE | took.to(torch.int64) * TOOK_TOO_LONG
    times = eg.amax(dim=1) - sg.amin(dim=1)
    return times, errors, sg, eg, start, end


def run_windowed_torch(net, sync, op, msize, nrep, win_size, ranks=None,
                       device="cuda") -> WindowRun:
    """Measure ``nrep`` calls of ``op`` under window-based synchronization
    on ``device``; float64 throughout. Advances ``net.t`` and each term's
    AR(1) state as the reference engines do.

    Random-walk clocks follow the reference's ``batch_rw`` engine: every
    rank's drift path (node spacing ``win_size``) is activated before the
    first clock read, then the start time, window seed and term biases are
    drawn, and the paths grow on the host in the reference's order."""
    dev = resolve_device(device)
    ranks = list(range(net.p)) if ranks is None else list(ranks)
    p = len(ranks)
    walking = _walking(net, ranks)
    if walking:
        clocks = [net.clocks[r] for r in ranks]
        for clk in clocks:
            clk.drift_path(win_size)
    start_time = max(sync.global_time(net, r) for r in ranks) + win_size
    if nrep <= 0:
        empty = np.empty((0, p))
        return WindowRun(times=np.empty(0), errors=np.empty(0, dtype=np.int64),
                         start_global_est=empty, end_global_est=empty.copy(),
                         start_true=empty.copy(), end_true=empty.copy())

    durations, gen = _draw(net, op, msize, p, nrep, dev)
    rk = {k: v[0] for k, v in _rank_arrays([net], [sync], ranks, dev).items()}
    walk = None
    if walking:
        grow_paths_for_deadlines(clocks, sync, ranks,
                                 start_time + win_size * (nrep - 1))
        paths = _DevicePaths.of(net, ranks, dev)
        if paths.stale():
            paths.upload()
        walk = (paths, nrep)
    _STATS.count(("window", durations.shape[0], p))
    out = _window(durations, gen, rk["t0"], rk["off"], rk["skew"], rk["scale"],
                  rk["slope"], rk["intercept"], rk["init_t"], op.rank_imbalance,
                  start_time, win_size, walk)
    times, errors, sg, eg, st, et = (x[:nrep].cpu().numpy() for x in out)
    net.t[ranks] = et[nrep - 1]
    return WindowRun(times=times, errors=errors, start_global_est=sg,
                     end_global_est=eg, start_true=st, end_true=et)


def sample_durations_torch(net, op, msize, nrep, ranks=None, device="cuda"):
    """Durations of ``nrep`` consecutive calls of ``op`` and their per-rank
    finish-imbalance factors, drawn on ``device`` as the per-epoch engine
    draws them: the window seed from ``net.rng``, then each term's epoch
    bias, each term through ``sim_scan`` with its AR(1) state carried out,
    and the ``(nrep, p)`` imbalance from the generator of (seed, number of
    terms). Returns float64 tensors ``(nrep,)`` and ``(nrep, p)`` on
    ``device``; a rank's finish is ``durations[:, None] * factors`` after
    the call's all-in."""
    dev = resolve_device(device)
    ranks = list(range(net.p)) if ranks is None else list(ranks)
    p = len(ranks)
    if nrep <= 0:
        return (torch.empty(0, dtype=_F64, device=dev),
                torch.empty((0, p), dtype=_F64, device=dev))
    durations, gen = _draw(net, op, msize, p, nrep, dev)
    factors = _imbalance(gen, durations.shape[0], p, op.rank_imbalance, dev)
    return durations[:nrep], factors[:nrep]


def scan_host_draws(op, rng, nrep, t0, device="cuda"):
    """``nrep`` durations of cost-model term ``op`` from host draws: the
    reference's ``sample_durations`` with its scan and mixture on ``device``.

    Draws from the numpy generator ``rng`` in the reference's order, one
    double per element each: the AR(1) innovations ``normal(0,
    noise_sigma)``, the tail coins, the uniforms under the tail magnitudes
    (``uniform(0.7, 1.3)`` consumes one ``random()`` each, so the
    generator ends where the reference's does) and the spike coins. Then
    ``sim_durations_scan`` at one row from ``op._ar_state`` with base time
    ``t0`` (base time times epoch bias, cold discount included): the
    kernel on a CUDA device, its plain version on the CPU. The magnitude
    is ``0.7 + 0.6 * u`` where numpy forms ``0.7 + (1.3 - 0.7) * u``, and
    the scan associates in the kernel's order, so the durations agree with
    the reference's to rounding, not to the bit. Returns ``(durations,
    carry)``: float64 numpy ``(nrep,)`` and the AR(1) state after the last
    call as a Python float; ``op`` is not changed."""
    dev = resolve_device(device)
    draws = (rng.normal(0.0, op.noise_sigma, size=nrep), rng.random(nrep),
             rng.random(nrep), rng.random(nrep))
    eps, u_tail, u_mag, u_spike = (torch.from_numpy(x).to(dev)[None]
                                   for x in draws)
    t, s = sim_durations_scan(
        eps, u_tail, u_mag, u_spike, coeff=op.autocorr,
        state=torch.tensor([op._ar_state], dtype=_F64, device=dev),
        t0=torch.tensor([t0], dtype=_F64, device=dev),
        tail_prob=op.tail_prob, tail_shift=op.tail_shift,
        spike_prob=op.spike_prob, spike_scale=op.spike_scale)
    return t[0].cpu().numpy(), float(s[0, -1])


@dataclass
class FusedWindowRun:
    """O(nrep) outputs of one fused epoch: the ``(nrep, p)`` grids of
    :class:`WindowRun` are not materialized."""

    times: np.ndarray
    errors: np.ndarray

    @property
    def valid_times(self) -> np.ndarray:
        return self.times[self.errors == 0]


def run_windowed_epochs_torch(nets, syncs, ops, msize, nrep, win_size,
                              ranks=None, device="cuda") -> "list[FusedWindowRun]":
    """Measure one case across launch epochs: ``nets[e] / syncs[e] /
    ops[e]`` are epoch ``e``'s simulator objects.

    Each cost-model term is sampled for all epochs in one kernel launch;
    the window runs per epoch (start times differ) through the per-epoch
    engine's window. Host RNG order per epoch, the AR(1) carries, the
    ``net.t`` writebacks and the times and flags are those of ``E``
    sequential :func:`run_windowed_torch` calls, bit for bit, so fused and
    per-epoch measurement of different cases may interleave freely.
    Returns one :class:`FusedWindowRun` per epoch.
    """
    dev = resolve_device(device)
    E = len(nets)
    if E == 0:
        return []
    ranks = list(range(nets[0].p)) if ranks is None else list(ranks)
    p = len(ranks)
    _check_affine(nets, ranks)
    if nrep <= 0:
        return [FusedWindowRun(times=np.empty(0),
                               errors=np.empty(0, dtype=np.int64))
                for _ in range(E)]

    n = _bucket(nrep)
    # Host pass: per-epoch window origins and seeds; per-net RNG order
    # (seed before biases) matches the per-epoch engine.
    start_times, seeds, term_lists = [], [], []
    for net, sync, op in zip(nets, syncs, ops):
        start_times.append(max(sync.global_time(net, r) for r in ranks) + win_size)
        seeds.append(int(net.rng.integers(2**31)))
        term_lists.append(_terms(op, p, msize))
    nterms = len(term_lists[0])

    durations = None
    for j in range(nterms):
        subs = [terms[j][0] for terms in term_lists]
        tp, tm = term_lists[0][j][1], term_lists[0][j][2]
        d = _sample(seeds, j, subs, nets, tp, tm, n, nrep, dev)
        durations = d if durations is None else durations + d

    rk = _rank_arrays(nets, syncs, ranks, dev)
    runs = []
    for e in range(E):
        _STATS.count(("window_fused", n, p))
        times, errors, _, _, _, end = _window(
            durations[e], _generator(dev, seeds[e], nterms), rk["t0"][e],
            rk["off"][e], rk["skew"][e], rk["scale"][e], rk["slope"][e],
            rk["intercept"][e], rk["init_t"][e], ops[e].rank_imbalance,
            start_times[e], win_size)
        nets[e].t[ranks] = end[nrep - 1].cpu().numpy()
        runs.append(FusedWindowRun(times=times[:nrep].cpu().numpy(),
                                   errors=errors[:nrep].cpu().numpy()))
    return runs
