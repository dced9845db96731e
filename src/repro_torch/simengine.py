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
and a full :class:`~repro_torch.core.window.WindowRun`.
:func:`run_windowed_epochs_torch` measures one case across all launch
epochs: every term is sampled for all epochs in one kernel launch, each
epoch from its own generator, so a lane's durations are bit-identical to
what the per-epoch engine draws for that epoch. The window then runs per
epoch over chunks of repetitions in float32 on window-relative times, with
the float64 chain (entry cumsum/cummax, previous-window row) carried across
chunks, and returns only the O(nrep) times and flags.
"""

from __future__ import annotations

import functools
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
    "FusedWindowRun",
    "engine_stats",
    "reset_engine_stats",
]

_F64 = torch.float64
_F32 = torch.float32


class SimTorchUnavailable(RuntimeError):
    """The torch engine cannot run this request: random-walk clocks
    (``rw_sigma > 0``) are not ported. Raised, never worked around."""


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


def engine_stats() -> dict:
    """Cumulative telemetry: ``n_dispatches`` (sample + window calls) and
    ``n_shapes`` (distinct step x shape signatures among them)."""
    return {"n_shapes": len(_STATS.shape_keys),
            "n_dispatches": _STATS.dispatches}


def reset_engine_stats() -> None:
    _STATS.dispatches = 0
    _STATS.shape_keys.clear()


def _chunk_for(p: int, n: int) -> int:
    """Repetitions per chunk of the fused window: the largest power of two
    with ``chunk * p <= 2**24``, never above ``n``. Each of the ~30
    elementwise launches of a chunk then moves a 64 MB float32
    ``(chunk, p)`` block, so launch overhead stays small against memory
    time, and the chunk's temporaries stay near 1 GB at any ``p``."""
    ch = max(1, (1 << 24) // max(1, p))
    return min(1 << (ch.bit_length() - 1), n)


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


def _check_affine(nets, ranks) -> None:
    for net in nets:
        if not all(net.clocks[r].rw_sigma <= 0.0 for r in ranks):
            raise SimTorchUnavailable(
                "the torch engine requires affine clocks (rw_sigma == 0); "
                "random-walk clocks are not ported")


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


def _window(durations, gen, t0, off, skew, scale, slope, intercept, init_t,
            rank_imbalance, start_time, win_size):
    """The per-epoch window over the whole ``(n, p)`` grid, float64.
    Returns ``(times, errors, start_global, end_global, start_true,
    end_true)``."""
    n, p = durations.shape[0], t0.shape[0]
    dev = durations.device
    targets = start_time + win_size * torch.arange(n, dtype=_F64, device=dev)
    # deadline: sync-model denormalize, then the affine clock inverse
    dl_local = (targets[:, None] + intercept) / (1.0 - slope) + init_t
    raw = dl_local / (1.0 + scale)
    deadline_true = (raw - off) / (1.0 + skew)
    z = torch.empty((n, p), dtype=_F32, device=dev).normal_(generator=gen)
    imb = rank_imbalance * z.to(_F64)
    span = durations[:, None] * torch.clamp_min(1.0 + imb, 0.25)
    e = span.amax(dim=1)
    dmax = deadline_true.amax(dim=1)
    C = torch.cat([torch.zeros(1, dtype=_F64, device=dev),
                   torch.cumsum(e[:-1], dim=0)])
    all_in = C + torch.clamp_min(torch.cummax(dmax - C, dim=0).values,
                                 t0.max())
    end = all_in[:, None] + span
    prev_end = torch.cat([t0[None, :], end[:-1]], dim=0)
    start = torch.maximum(deadline_true, prev_end)
    late = (deadline_true <= prev_end).any(dim=1)

    def to_global(t_true):
        local = (off + (1.0 + skew) * t_true) * (1.0 + scale)
        adj = local - init_t
        return adj - (adj * slope + intercept)

    sg = to_global(start)
    eg = to_global(end)
    took = (eg > (targets + win_size)[:, None]).any(dim=1)
    errors = late.to(torch.int64) * START_LATE | took.to(torch.int64) * TOOK_TOO_LONG
    times = eg.amax(dim=1) - sg.amin(dim=1)
    return times, errors, sg, eg, start, end


def run_windowed_torch(net, sync, op, msize, nrep, win_size, ranks=None,
                       device="cuda") -> WindowRun:
    """Measure ``nrep`` calls of ``op`` under window-based synchronization
    on ``device``; float64 throughout. Advances ``net.t`` and each term's
    AR(1) state as the reference engines do. Raises
    :class:`SimTorchUnavailable` on random-walk clocks."""
    dev = resolve_device(device)
    ranks = list(range(net.p)) if ranks is None else list(ranks)
    p = len(ranks)
    _check_affine([net], ranks)
    if nrep <= 0:
        empty = np.empty((0, p))
        return WindowRun(times=np.empty(0), errors=np.empty(0, dtype=np.int64),
                         start_global_est=empty, end_global_est=empty.copy(),
                         start_true=empty.copy(), end_true=empty.copy())

    start_time = max(sync.global_time(net, r) for r in ranks) + win_size
    n = _bucket(nrep)
    seed = int(net.rng.integers(2**31))
    terms = _terms(op, p, msize)
    durations = sum(_sample([seed], j, [sub], [net], tp, tm, n, nrep, dev)[0]
                    for j, (sub, tp, tm) in enumerate(terms))
    rk = {k: v[0] for k, v in _rank_arrays([net], [sync], ranks, dev).items()}
    _STATS.count(("window", n, p))
    out = _window(durations, _generator(dev, seed, len(terms)), rk["t0"],
                  rk["off"], rk["skew"], rk["scale"], rk["slope"],
                  rk["intercept"], rk["init_t"], op.rank_imbalance,
                  start_time, win_size)
    times, errors, sg, eg, st, et = (x[:nrep].cpu().numpy() for x in out)
    net.t[ranks] = et[nrep - 1]
    return WindowRun(times=times, errors=errors, start_global_est=sg,
                     end_global_est=eg, start_true=st, end_true=et)


@dataclass
class FusedWindowRun:
    """O(nrep) outputs of one fused epoch: the ``(nrep, p)`` grids of
    :class:`WindowRun` are not materialized."""

    times: np.ndarray
    errors: np.ndarray

    @property
    def valid_times(self) -> np.ndarray:
        return self.times[self.errors == 0]


@functools.lru_cache(maxsize=None)
def _norm_lut(device: torch.device) -> torch.Tensor:
    """2^16-entry float32 normal-quantile table (quantile midpoints, so the
    discretized draw is exactly stratified): the fused window draws 16-bit
    indices into it for the finish-imbalance factors."""
    q = (torch.arange(65536, dtype=_F64) + 0.5) / 65536.0
    return torch.special.ndtri(q).to(_F32).to(device)


def _window_fused(durations, gen, rk, rank_imbalance, start_time, win_size,
                  nrep, ch):
    """The window of one epoch over chunks of ``ch`` repetitions. Per-rank
    arithmetic is float32 on times relative to each window's target; the
    deadline and the global-time conversion are affine in the target, so
    they reduce to per-rank slope/anchor pairs. Returns numpy
    ``(times, errors, end_true of repetition nrep - 1)``."""
    dev = durations.device
    slope, intercept, init_t = rk["slope"], rk["intercept"], rk["init_t"]
    off, skew, scale, t0 = rk["off"], rk["skew"], rk["scale"], rk["t0"]
    p = t0.shape[0]
    alpha = 1.0 / ((1.0 - slope) * (1.0 + scale) * (1.0 + skew))
    beta = ((intercept / (1.0 - slope) + init_t) / (1.0 + scale) - off) / (1.0 + skew)
    gamma = (1.0 - slope) * (1.0 + scale) * (1.0 + skew)
    delta = (off * (1.0 + scale) - init_t) * (1.0 - slope) - intercept
    T0 = start_time
    d0_32 = ((alpha - 1.0) * T0 + beta).to(_F32)
    g0_32 = ((gamma - 1.0) * T0 + delta).to(_F32)
    am1_32 = (alpha - 1.0).to(_F32)
    gm1_32 = (gamma - 1.0).to(_F32)
    gam32 = gamma.to(_F32)
    maxt0 = t0.max()
    ws32 = torch.tensor(win_size, dtype=_F32, device=dev)
    ri32 = torch.tensor(rank_imbalance, dtype=_F32, device=dev)
    lut = _norm_lut(dev)

    times = torch.empty(nrep, dtype=_F64, device=dev)
    errors = torch.empty(nrep, dtype=torch.int64, device=dev)
    c_run = torch.zeros((), dtype=_F64, device=dev)
    c_max = torch.full((), -torch.inf, dtype=_F64, device=dev)
    prev_last = (t0 - T0).to(_F32) + ws32
    last_row = nrep - 1
    for lo in range(0, nrep, ch):
        m = min(ch, nrep - lo)
        tau = win_size * torch.arange(lo, lo + m, dtype=_F64, device=dev)
        tau32 = tau.to(_F32)[:, None]
        z = lut[torch.randint(0, 65536, (m, p), generator=gen, device=dev)]
        drel = am1_32 * tau32 + d0_32
        span = durations[lo:lo + m].to(_F32)[:, None] \
            * torch.clamp_min(1.0 + ri32 * z, 0.25)
        e = span.amax(dim=1).to(_F64)
        dmaxrel = drel.amax(dim=1).to(_F64)
        T = T0 + tau
        C = c_run + torch.cat([torch.zeros(1, dtype=_F64, device=dev),
                               torch.cumsum(e[:-1], dim=0)])
        cm = torch.cummax(torch.cat([c_max[None], T + dmaxrel - C]),
                          dim=0).values[1:]
        all_in = C + torch.clamp_min(cm, maxt0)
        endrel = (all_in - T).to(_F32)[:, None] + span
        prevrel = torch.cat([prev_last[None, :], endrel[:-1]], dim=0) - ws32
        startrel = torch.maximum(drel, prevrel)
        late = (drel <= prevrel).any(dim=1)
        base = gm1_32 * tau32 + g0_32
        egrel = base + gam32 * endrel
        sgrel = base + gam32 * startrel
        took = (egrel > ws32).any(dim=1)
        errors[lo:lo + m] = late.to(torch.int64) * START_LATE \
            | took.to(torch.int64) * TOOK_TOO_LONG
        times[lo:lo + m] = egrel.amax(dim=1).to(_F64) - sgrel.amin(dim=1).to(_F64)
        c_run = C[-1] + e[-1]
        c_max = cm[-1]
        prev_last = endrel[-1]
        if lo <= last_row < lo + m:
            et_last = endrel[last_row - lo].to(_F64) + (T0 + win_size * last_row)
    return times.cpu().numpy(), errors.cpu().numpy(), et_last.cpu().numpy()


def run_windowed_epochs_torch(nets, syncs, ops, msize, nrep, win_size,
                              ranks=None, device="cuda") -> "list[FusedWindowRun]":
    """Measure one case across launch epochs: ``nets[e] / syncs[e] /
    ops[e]`` are epoch ``e``'s simulator objects.

    Each cost-model term is sampled for all epochs in one kernel launch;
    the window runs per epoch (start times differ). Host RNG order per
    epoch, the AR(1) carries and the ``net.t`` writebacks are those of
    ``E`` sequential :func:`run_windowed_torch` calls, so fused and
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
    ch = _chunk_for(p, nrep)
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
        _STATS.count(("window_fused", ch, p))
        times, errors, et_last = _window_fused(
            durations[e], _generator(dev, seeds[e], nterms),
            {k: v[e] for k, v in rk.items()}, ops[e].rank_imbalance,
            start_times[e], win_size, nrep, ch)
        nets[e].t[ranks] = et_last
        runs.append(FusedWindowRun(times=times, errors=errors))
    return runs
