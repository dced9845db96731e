"""The calibration parameter surface: SimNet's noise model as a bounded,
declarative search space.

The simulator's stochastic behavior is controlled by the
:class:`~repro_torch.core.mpi_ops.SimCollective` noise model (AR(1) coefficient,
bimodal-tail / spike / rank-imbalance mixture weights, per-op base
latencies) and the :class:`~repro_torch.core.simnet.ClockParams` drift model
(``rw_sigma`` et al.). A :class:`CalibrationSpace` names a subset of those
knobs with bounds, and :meth:`CalibrationSpace.materialize` turns any
point of the space into a concrete :class:`~repro_torch.campaign.TorchSimBackend` —
through the same dataclass-replacement route (``op_kw`` / ``per_op_kw`` /
``clock_kw`` overrides) a :class:`~repro_torch.core.factors.FactorGrid` cell
uses, so every candidate carries its parameters in its factor fingerprint
and its campaigns resume from a store like any other experiment.

Parameter names are dotted paths:

  ``op.<field>``              a :class:`SimCollective` field applied to
                              every collective (``op_kw``);
  ``per_op.<name>.<field>``   the same field for one named collective only
                              (``per_op_kw`` — per-op base latencies);
  ``clock.<field>``           a :class:`ClockParams` field (``clock_kw``).

Unknown fields are rejected at space-construction time: a typo'd knob
would otherwise "fit" by never changing anything.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np

from ..campaign.backends import TorchSimBackend
from ..core.mpi_ops import SimCollective
from ..core.simnet import ClockParams

__all__ = ["CalibrationParam", "CalibrationSpace", "default_space"]

_OP_FIELDS = {f.name for f in dataclasses.fields(SimCollective)
              if not f.name.startswith("_")}
_CLOCK_FIELDS = {f.name for f in dataclasses.fields(ClockParams)}


@dataclass(frozen=True)
class CalibrationParam:
    """One bounded knob of the noise model.

    ``init`` is the fit's starting value (defaults to the bounds'
    midpoint); fits never step outside ``[lo, hi]``. ``resolution`` is the
    granularity values are rounded to before materialization — it makes
    parameter vectors hashable-by-value, so a resumed fit re-requests
    bit-identical backend configs (and therefore identical factor
    fingerprints) for the evaluations it replays.
    """

    name: str
    lo: float
    hi: float
    init: float | None = None
    resolution: float = 1e-9

    def __post_init__(self):
        if not np.isfinite(self.lo) or not np.isfinite(self.hi) \
                or self.lo >= self.hi:
            raise ValueError(f"CalibrationParam {self.name!r}: need finite "
                             f"lo < hi, got [{self.lo}, {self.hi}]")
        parts = self.name.split(".")
        if parts[0] == "op" and len(parts) == 2:
            fields, kind = _OP_FIELDS, "SimCollective"
        elif parts[0] == "per_op" and len(parts) == 3:
            fields, kind = _OP_FIELDS, "SimCollective"
        elif parts[0] == "clock" and len(parts) == 2:
            fields, kind = _CLOCK_FIELDS, "ClockParams"
        else:
            raise ValueError(
                f"CalibrationParam {self.name!r}: name must be "
                "'op.<field>', 'per_op.<opname>.<field>' or "
                "'clock.<field>'")
        if parts[-1] not in fields:
            raise ValueError(
                f"CalibrationParam {self.name!r}: {parts[-1]!r} is not a "
                f"{kind} field (a typo'd knob would silently never move)")
        if self.init is not None and not self.lo <= self.init <= self.hi:
            raise ValueError(f"CalibrationParam {self.name!r}: init "
                             f"{self.init} outside [{self.lo}, {self.hi}]")

    @property
    def start(self) -> float:
        return self.init if self.init is not None \
            else 0.5 * (self.lo + self.hi)

    def clip(self, value: float) -> float:
        v = float(np.clip(value, self.lo, self.hi))
        if self.resolution > 0:
            v = round(round(v / self.resolution) * self.resolution, 12)
        return float(np.clip(v, self.lo, self.hi))


@dataclass
class CalibrationSpace:
    """A named, bounded subset of SimNet's noise-model knobs, plus the
    base :class:`~repro_torch.campaign.TorchSimBackend` every candidate
    derives from (cluster size, sync method, window size, engine, device —
    everything that is *not* being fitted). Each candidate is the base
    with its overrides applied by :func:`dataclasses.replace`, which
    reruns the backend's device check and gives the candidate a cluster
    of its own. The execution fields ``device`` and ``fuse_epochs`` stay
    out of :meth:`manifest`."""

    params: tuple
    base: TorchSimBackend = field(default_factory=TorchSimBackend)

    def __post_init__(self):
        self.params = tuple(self.params)
        if not self.params:
            raise ValueError("CalibrationSpace: no parameters to fit")
        names = [p.name for p in self.params]
        if len(set(names)) != len(names):
            raise ValueError(f"CalibrationSpace: duplicate params {names}")

    def names(self) -> list[str]:
        return [p.name for p in self.params]

    def start(self) -> dict[str, float]:
        """The fit's starting point."""
        return {p.name: p.clip(p.start) for p in self.params}

    def clip(self, values: dict) -> dict:
        """``values`` clamped into bounds and snapped to resolution, in
        parameter-declaration order."""
        by_name = {p.name: p for p in self.params}
        unknown = sorted(set(values) - set(by_name))
        if unknown:
            raise KeyError(f"CalibrationSpace.clip: unknown params "
                           f"{unknown}; space has {self.names()}")
        return {p.name: p.clip(values[p.name]) for p in self.params}

    def materialize(self, values: dict) -> TorchSimBackend:
        """A concrete backend at one point of the space — the base
        backend with ``op_kw`` / ``per_op_kw`` / ``clock_kw`` overridden
        by dataclass replacement, exactly as a factor-grid cell would.
        The overrides land in the backend's factor ``extra`` tuples, so
        two candidates never share a fingerprint."""
        values = self.clip(values)
        op_kw = dict(self.base.op_kw)
        per_op_kw = {op: dict(kw) for op, kw in self.base.per_op_kw.items()}
        clock_kw = dict(self.base.clock_kw)
        for name, v in values.items():
            parts = name.split(".")
            if parts[0] == "op":
                op_kw[parts[1]] = v
            elif parts[0] == "per_op":
                per_op_kw.setdefault(parts[1], {})[parts[2]] = v
            else:
                clock_kw[parts[1]] = v
        return dataclasses.replace(self.base, op_kw=op_kw,
                                   per_op_kw=per_op_kw, clock_kw=clock_kw)

    def manifest(self) -> dict:
        """The declarative form persisted in the store's ``calib`` line —
        enough for a resumed fit to verify it is continuing the same
        search."""
        return dict(
            params=[dict(name=p.name, lo=p.lo, hi=p.hi, init=p.start,
                         resolution=p.resolution) for p in self.params],
            base=dict(p=self.base.p, seed0=self.base.seed0,
                      sync_name=self.base.sync_name,
                      win_size=self.base.win_size, engine=self.base.engine,
                      op_kw=dict(self.base.op_kw),
                      per_op_kw={op: dict(kw) for op, kw
                                 in self.base.per_op_kw.items()},
                      clock_kw=dict(self.base.clock_kw)),
        )


def default_space(base: TorchSimBackend | None = None,
                  names: list[str] | None = None,
                  latency_scale: float = 1.0) -> CalibrationSpace:
    """The stock noise-model surface: the knobs the paper's variability
    phenomenology actually exercises — common-duration noise, the bimodal
    tail (Fig. 14), OS-noise spikes, rank imbalance, the AR(1)
    autocorrelation between consecutive calls, the per-op latency terms,
    and the clock's random-walk drift. ``names`` restricts to a subset
    (CI smoke fits 2-3 knobs, the nightly fit takes the lot).

    ``latency_scale`` widens the absolute-latency bounds (``alpha`` /
    ``gamma``) by that factor. The stock bounds are sized for simulator-
    scale collectives (tens of µs); a real target measured through a
    dispatch-heavy runtime (hundreds of µs per call) sits far outside
    them, and a fit against it would silently rail at the upper bound
    instead of fitting.

    ``base`` defaults to ``TorchSimBackend()``, on the card."""
    if latency_scale <= 0:
        raise ValueError(f"default_space: latency_scale must be positive, "
                         f"got {latency_scale}")
    ls = float(latency_scale)
    stock = {
        "op.alpha": CalibrationParam("op.alpha", 0.5e-6, 12e-6 * ls),
        "op.gamma": CalibrationParam("op.gamma", 0.2e-6, 8e-6 * ls),
        "op.noise_sigma": CalibrationParam("op.noise_sigma", 0.005, 0.20),
        "op.tail_prob": CalibrationParam("op.tail_prob", 0.0, 0.30),
        "op.tail_shift": CalibrationParam("op.tail_shift", 0.05, 1.0),
        "op.spike_prob": CalibrationParam("op.spike_prob", 0.0, 0.02),
        "op.rank_imbalance": CalibrationParam("op.rank_imbalance", 0.0, 0.25),
        "op.autocorr": CalibrationParam("op.autocorr", 0.0, 0.9),
        "clock.rw_sigma": CalibrationParam("clock.rw_sigma", 0.0, 1e-6),
    }
    if names is not None:
        unknown = sorted(set(names) - set(stock))
        if unknown:
            raise ValueError(f"default_space: unknown params {unknown}; "
                             f"stock params are {sorted(stock)}")
        params = tuple(stock[n] for n in names)
    else:
        params = tuple(stock.values())
    return CalibrationSpace(params=params, base=base or TorchSimBackend())
