"""Simulated collective-operation cost models (§3.2, §5.1).

The parameters of the JAX package's ``repro.core.mpi_ops``, field for
field: a base time ``alpha * ceil(log2 p) + beta * m + gamma`` and the
statistical structure the paper reports — right-skewed durations with a
second smaller peak (Fig. 14), OS-noise spikes, per-rank finish imbalance,
lag-1 autocorrelation (Fig. 18) and a per-launch-epoch bias (§5.2). The
durations themselves are drawn on the device by
:mod:`repro_torch.simengine`; what stays on the host is the per-epoch
bias draw and the AR(1) state carried from one call to the next.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import numpy as np

from .clocks import derive_stream
from .simnet import SimNet

__all__ = [
    "SimCollective",
    "SimCompositeOp",
    "make_op",
    "make_composite_op",
]


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

