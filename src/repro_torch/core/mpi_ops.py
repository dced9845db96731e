"""Simulated collective-operation cost models (§3.2, §5.1).

The parameters of the JAX package's ``repro.core.mpi_ops``, field for
field: a base time ``alpha * ceil(log2 p) + beta * m + gamma`` and the
statistical structure the paper reports — right-skewed durations with a
second smaller peak (Fig. 14), OS-noise spikes, per-rank finish imbalance,
lag-1 autocorrelation (Fig. 18) and a per-launch-epoch bias (§5.2).

The device engine (:mod:`repro_torch.simengine`) draws the durations on
the device; it takes from here the per-epoch bias and the AR(1) state
carried from one call to the next. The reference's numpy engines are
here too, with its draws in its order, so one seed gives both packages
the same campaign bit for bit:

  * :meth:`SimCollective.execute` — the scalar semantic reference, one
    simulated call per invocation;
  * :meth:`SimCollective.execute_batch` — the vectorized engine: all
    ``nrep`` durations at once (:meth:`SimCollective.sample_durations`),
    then the per-rank start/end recurrence in closed form. With
    ``device="cuda"`` the same host draws go through the ``sim_scan``
    kernel (:func:`repro_torch.simengine.scan_host_draws`), which runs
    the AR(1) scan and the mixture on the card.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import numpy as np

from .clocks import derive_stream
from .simnet import SimNet

__all__ = [
    "OP_LIBRARY",
    "SimCollective",
    "SimCompositeOp",
    "CollectiveExecution",
    "BatchExecution",
    "make_op",
    "make_composite_op",
]


@dataclass
class CollectiveExecution:
    """Per-rank true start/finish times of one simulated collective call."""

    start_true: np.ndarray
    end_true: np.ndarray


@dataclass
class BatchExecution:
    """Per-rank true start/finish times of ``nrep`` consecutive calls.

    ``start_true``/``end_true`` have shape ``(nrep, p)``; ``durations`` is
    the common (synchronized-start) duration of each call, shape ``(nrep,)``.
    """

    start_true: np.ndarray
    end_true: np.ndarray
    durations: np.ndarray


def _ar1_filter(eps: np.ndarray, coeff: float, state: float) -> np.ndarray:
    """Vectorized AR(1) recurrence ``s_i = coeff * s_{i-1} + eps_i``.

    Uses the exponential-decay closed form ``s_j = a^{j+1} s_{-1} +
    sum_k a^{j-k} eps_k`` evaluated in chunks small enough that the
    ``a^{-k}`` rescaling cannot overflow, so it is numerically equivalent
    to the scalar loop for any ``|coeff| < 1``.
    """
    n = eps.size
    if n == 0:
        return eps.copy()
    a = float(coeff)
    if a == 0.0:
        return eps.copy()
    if abs(a) >= 1.0:  # non-stationary config: fall back to the plain loop
        out = np.empty(n)
        s = state
        for i in range(n):
            s = a * s + eps[i]
            out[i] = s
        return out
    # chunk so that |a|^-(chunk-1) stays far below float64 overflow
    chunk = max(1, min(n, int(500.0 / max(1e-12, -np.log(abs(a))))))
    out = np.empty(n)
    carry = state
    for lo in range(0, n, chunk):
        e = eps[lo:lo + chunk]
        m = e.size
        decay = a ** np.arange(m)                     # a^j
        s = decay * np.cumsum(e / decay) + carry * a * decay
        out[lo:lo + m] = s
        carry = s[-1]
    return out


@dataclass
class SimCollective:
    """Cost model ``T(p, m) = alpha * ceil(log2 p) + beta * m + gamma``.

    ``epoch_bias`` models the launch-epoch factor (§5.2): a per-process-
    instantiation multiplicative offset, sampled once per (net, op) pair
    and cached weakly by the :class:`SimNet` object itself.
    """

    name: str = "allreduce"
    alpha: float = 3.0e-6        # per tree level [s]
    beta: float = 2.5e-10        # per byte [s] (~4 GB/s effective)
    gamma: float = 2.0e-6        # fixed overhead [s]
    msize_factor: float = 1.0    # e.g. 2x for allreduce (reduce+bcast phases)
    noise_sigma: float = 0.04    # lognormal sigma on the common duration
    tail_prob: float = 0.08      # bimodal right peak probability (Fig. 14)
    tail_shift: float = 0.35     # right peak at ~(1+shift) * mean
    spike_prob: float = 0.003    # OS-noise spike
    spike_scale: float = 8.0
    rank_imbalance: float = 0.06 # per-rank finish spread (fraction of T)
    autocorr: float = 0.35       # AR(1) coefficient between consecutive calls
    epoch_bias_sigma: float = 0.02  # per-launch-epoch mean shift (§5.2)
    warm_cache_discount: float = 0.12  # §5.8: warm buffers run faster
    _ar_state: float = field(default=0.0, init=False, repr=False)
    _epoch_bias: "weakref.WeakKeyDictionary[SimNet, float]" = field(
        default_factory=weakref.WeakKeyDictionary, init=False, repr=False)

    def base_time(self, p: int, msize: int) -> float:
        levels = max(1, int(np.ceil(np.log2(max(2, p)))))
        return self.alpha * levels + self.beta * self.msize_factor * msize + self.gamma

    def _bias_for(self, net: SimNet) -> float:
        bias = self._epoch_bias.get(net)
        if bias is None:
            # one draw from net.rng, through the same helper as the
            # reference, so both packages draw the same epoch bias
            rng = derive_stream(net.rng)
            bias = float(np.exp(rng.normal(0.0, self.epoch_bias_sigma)))
            self._epoch_bias[net] = bias
        return bias

    def sample_duration(self, net: SimNet, p: int, msize: int,
                        warm: bool = True) -> float:
        """Common (synchronized-start) duration of one call."""
        t0 = self.base_time(p, msize) * self._bias_for(net)
        if not warm:
            t0 *= 1.0 + self.warm_cache_discount
        rng = net.rng
        # AR(1) lognormal noise (Fig. 18's autocorrelation).
        eps = float(rng.normal(0.0, self.noise_sigma))
        self._ar_state = self.autocorr * self._ar_state + eps
        t = t0 * float(np.exp(self._ar_state))
        if rng.random() < self.tail_prob:
            t *= 1.0 + self.tail_shift * float(rng.uniform(0.7, 1.3))
        if rng.random() < self.spike_prob:
            t *= self.spike_scale
        return t

    def sample_durations(self, net: SimNet, p: int, msize: int, nrep: int,
                         warm: bool = True, device=None) -> np.ndarray:
        """Vectorized :meth:`sample_duration`: ``nrep`` consecutive common
        durations with the same AR(1)/bimodal/spike structure.

        RNG draws are batched per quantity (noise, tail, tail magnitude,
        spike), so the stream order differs from ``nrep`` scalar calls; the
        marginal and joint (autocorrelation) distributions are identical.
        The AR(1) state is carried in and out.

        ``device`` ``None`` or ``"cpu"`` runs the reference's numpy math.
        A CUDA device takes the same draws from ``net.rng`` (the tail
        magnitudes as the uniforms under them, one double each) and runs
        the AR(1) scan and the mixture through the ``sim_scan`` kernel
        (:func:`repro_torch.simengine.scan_host_draws`): the durations
        agree with the numpy ones to rounding, and the generator ends in
        the same state.
        """
        if nrep <= 0:
            return np.empty(0)
        t0 = self.base_time(p, msize) * self._bias_for(net)
        if not warm:
            t0 *= 1.0 + self.warm_cache_discount
        rng = net.rng
        if device is not None and str(device) != "cpu":
            from ..simengine import scan_host_draws

            t, self._ar_state = scan_host_draws(self, rng, nrep, t0, device)
            return t
        eps = rng.normal(0.0, self.noise_sigma, size=nrep)
        s = _ar1_filter(eps, self.autocorr, self._ar_state)
        self._ar_state = float(s[-1])
        t = t0 * np.exp(s)
        tails = rng.random(nrep) < self.tail_prob
        tail_mag = 1.0 + self.tail_shift * rng.uniform(0.7, 1.3, size=nrep)
        t = np.where(tails, t * tail_mag, t)
        spikes = rng.random(nrep) < self.spike_prob
        t = np.where(spikes, t * self.spike_scale, t)
        return t

    def execute(self, net: SimNet, msize: int, ranks: list[int] | None = None,
                warm: bool = True) -> CollectiveExecution:
        """Run one collective call on the simulated cluster.

        Semantics of a synchronizing collective: no rank can finish before
        every rank has entered the call, so skewed entries inflate early
        entrants' *local* durations (§4.6 / Fig. 11's mechanism).
        """
        ranks = list(range(net.p)) if ranks is None else ranks
        p = len(ranks)
        start = net.t[ranks].copy()
        t_all_in = float(np.max(start))
        dur = self.sample_duration(net, p, msize, warm)
        imb = net.rng.normal(0.0, self.rank_imbalance, size=p)
        # one randomly-chosen "late" rank pattern per call
        end = t_all_in + dur * np.maximum(0.25, 1.0 + imb)
        for i, r in enumerate(ranks):
            net.t[r] = end[i]
        return CollectiveExecution(start_true=start, end_true=end)

    def execute_batch(
        self,
        net: SimNet,
        msize: int,
        nrep: int,
        ranks: list[int] | None = None,
        warm: bool = True,
        min_start_true: np.ndarray | None = None,
        device=None,
    ) -> BatchExecution:
        """Run ``nrep`` consecutive collective calls in closed form.

        Semantically equivalent to ``nrep`` calls of :meth:`execute` (same
        synchronizing-collective entry rule), optionally with a per-call
        per-rank earliest start ``min_start_true`` of shape ``(nrep, p)``
        (the window scheme's deadlines in *true* time): rank ``r`` enters
        call ``i`` at ``max(min_start_true[i, r], end[i-1, r])``.

        The cross-call recurrence ``all_in_i = max(deadline_max_i,
        all_in_{i-1} + e_{i-1})`` (``e_i`` = duration times the slowest
        rank's imbalance factor) is solved with a prefix-sum +
        running-maximum identity, so no Python loop over ``nrep`` remains.
        ``device`` is where the durations are scanned
        (:meth:`sample_durations`); the rest is numpy on the host.
        """
        ranks = list(range(net.p)) if ranks is None else ranks
        p = len(ranks)
        if nrep <= 0:
            empty = np.empty((0, p))
            return BatchExecution(empty, empty.copy(), np.empty(0))
        dur = self.sample_durations(net, p, msize, nrep, warm, device=device)
        imb = net.rng.normal(0.0, self.rank_imbalance, size=(nrep, p))
        m = np.maximum(0.25, 1.0 + imb)
        span = dur[:, None] * m          # per-rank duration after all-in
        e = span.max(axis=1)             # slowest rank per call
        t0 = net.t[ranks].copy()
        if min_start_true is None:
            dmax = np.full(nrep, -np.inf)
        else:
            dmax = np.max(min_start_true, axis=1)
        # all_in_i = max(dmax_i, all_in_{i-1} + e_{i-1}) with
        # all_in_{-1} + e_{-1} := max(t0).  Unrolled:
        #   all_in_i = C_i + max(max_r t0_r, max_{j<=i} (dmax_j - C_j))
        # where C_i = sum_{k<i} e_k.
        C = np.concatenate(([0.0], np.cumsum(e[:-1])))
        all_in = C + np.maximum(
            float(np.max(t0)), np.maximum.accumulate(dmax - C))
        end = all_in[:, None] + span
        prev_end = np.vstack((t0[None, :], end[:-1]))
        if min_start_true is None:
            start = prev_end
        else:
            start = np.maximum(min_start_true, prev_end)
        net.t[ranks] = end[-1]
        return BatchExecution(start_true=start, end_true=end, durations=dur)


@dataclass
class SimCompositeOp(SimCollective):
    """A guideline mock-up: constituent collectives run back to back.

    ``terms`` holds ``(op, msize_scale, p_scale)`` triples; one call's
    common duration is the sum of the terms' durations, each at its own
    message size (``round(msize_scale * msize)``) and process count
    (``round(p_scale * p)``). Each constituent keeps its own AR(1) state
    and per-epoch bias.
    """

    terms: tuple = ()   # tuple[(SimCollective, float msize_scale, float p_scale)]

    def __post_init__(self):
        if self.terms:
            # the slowest-rank exit spread of the sequence is dominated by
            # its most imbalanced constituent
            self.rank_imbalance = max(op.rank_imbalance
                                      for op, _, _ in self.terms)

    @staticmethod
    def _term_p(p: int, p_scale: float) -> int:
        return max(2, int(round(p_scale * p)))

    def base_time(self, p: int, msize: int) -> float:
        return sum(op.base_time(self._term_p(p, ps),
                                max(0, int(round(ms * msize))))
                   for op, ms, ps in self.terms)

    def sample_duration(self, net: SimNet, p: int, msize: int,
                        warm: bool = True) -> float:
        return float(sum(
            op.sample_duration(net, self._term_p(p, ps),
                               max(0, int(round(ms * msize))), warm)
            for op, ms, ps in self.terms))

    def sample_durations(self, net: SimNet, p: int, msize: int, nrep: int,
                         warm: bool = True, device=None) -> np.ndarray:
        if nrep <= 0:
            return np.empty(0)
        total = np.zeros(nrep)
        for op, ms, ps in self.terms:
            total += op.sample_durations(net, self._term_p(p, ps),
                                         max(0, int(round(ms * msize))),
                                         nrep, warm, device=device)
        return total


def make_composite_op(expr: str, per_op_kw: dict | None = None,
                      **overrides) -> SimCollective:
    """Build the simulated op for an op *expression* (see :mod:`.opexpr`).

    A plain name returns :func:`make_op` unchanged; anything composite (a
    ``+`` sequence, a ``*scale`` or ``@half`` modifier) returns a
    :class:`SimCompositeOp`. ``overrides`` apply to every constituent;
    ``per_op_kw`` maps constituent names to extra overrides (how a single
    mis-tuned collective is modeled). ``#impl`` tags are rejected.
    """
    from .opexpr import is_composite, parse_opexpr

    per_op_kw = per_op_kw or {}

    def _mk(name: str) -> SimCollective:
        kw = dict(overrides)
        kw.update(per_op_kw.get(name, {}))
        return make_op(name, **kw)

    terms = parse_opexpr(expr)
    for t in terms:
        if t.impl is not None:
            raise ValueError(
                f"opexpr {expr!r}: '#{t.impl}' implementation tags are not "
                "supported by the simulator backend")
    if not is_composite(expr):
        return _mk(terms[0].op)
    return SimCompositeOp(
        name=expr,
        terms=tuple((_mk(t.op), t.msize_scale,
                     0.5 if t.procs == "half" else 1.0) for t in terms),
    )


def make_op(name: str, **overrides) -> SimCollective:
    """Factory for the collectives studied in the paper."""
    presets = {
        # msize_factor approximates the algorithmic volume multiplier.
        "bcast":     dict(msize_factor=1.0, alpha=2.5e-6),
        "allreduce": dict(msize_factor=2.0, alpha=3.0e-6),
        "alltoall":  dict(msize_factor=4.0, alpha=4.0e-6, rank_imbalance=0.10),
        "scan":      dict(msize_factor=2.0, alpha=3.5e-6, tail_prob=0.12),
        "reduce":    dict(msize_factor=1.0, alpha=2.5e-6),
        "barrier":   dict(msize_factor=0.0, alpha=2.0e-6, gamma=1.0e-6),
    }
    kw = dict(presets.get(name, {}))
    kw.update(overrides)
    return SimCollective(name=name, **kw)


OP_LIBRARY = tuple(sorted(["bcast", "allreduce", "alltoall", "scan", "reduce", "barrier"]))
