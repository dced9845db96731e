"""Clock models and linear drift models (paper §3.1, §4.3-4.4).

Host-side numpy, kept identical to the JAX package's ``repro.core.clocks``
so that a seeded simulated cluster draws the same clocks in both packages.

A hardware clock is modeled as an affine distortion of true time ``t``
plus an optional random walk ``rw(t)`` (oscillator wander)::

    local(t) = (offset + (1 + skew) * t + rw(t)) * (1 + scale_error)

the linearity assumption of Jones & Koenig [19] that the paper adopts
(§4.3), with the walk as the deviation from it. The walk is sampled
lazily, one increment per forward read, until :meth:`SimClock.drift_path`
switches it to a :class:`DriftPath` pre-sampled on a fixed grid; the
engine in :mod:`repro_torch.simengine` grows such paths on the host and
inverts and reads them on the device.

``LinearModel`` is the paper's (slope, intercept) drift model: a process
``r`` learns ``d_r(t_r) = t_r - t_ref ~= slope * t_r + intercept`` and
normalizes local to global time with Algorithm 16::

    global(t_r) = t_r - (slope * t_r + intercept)

``LinearModel.merge`` is MERGE_LMS of Algorithm 4.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "Clock",
    "PerfClock",
    "SimClock",
    "AdjustedClock",
    "DriftPath",
    "LinearModel",
    "IDENTITY_MODEL",
    "derive_stream",
    "linear_fit",
]


def derive_stream(parent, *keys) -> np.random.Generator:
    """Derive an independent child RNG stream from ``parent``.

    ``parent`` is either an integer seed or a live
    :class:`numpy.random.Generator` — in the latter case exactly one draw
    is consumed from it. ``keys`` namespace sibling streams
    deterministically; strings are hashed with CRC-32 rather than
    ``hash()`` (which is salted per process), so every engine derives the
    *same* stream for the same logical purpose.
    """
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


class Clock:
    """Abstract local clock. ``read(t_true)`` maps true time -> local time.

    Real clocks ignore ``t_true`` and read the host monotonic clock. The
    simulation passes the discrete-event true time explicitly.
    """

    def read(self, t_true: float) -> float:  # pragma: no cover - interface
        raise NotImplementedError


class PerfClock(Clock):
    """Monotonic host clock (``time.perf_counter_ns``, unaffected by NTP
    slewing of the wall clock on Linux)."""

    def read(self, t_true: float = 0.0) -> float:
        return time.perf_counter_ns() * 1e-9


@dataclass
class DriftPath:
    """Pre-sampled cumulative random-walk drift on a fixed true-time grid.

    The walk is materialized on nodes ``t_k = anchor + k * dt`` and
    linearly interpolated between them: the same Gaussian process at the
    nodes, a piecewise-affine function everywhere else, which makes
    batched local-to-true deadline inversion a binary search over the
    nodes plus an in-segment affine solve.

    Node values depend on the derived stream and on the sequence of
    :meth:`ensure` calls (each appends ``x[-1] + cumsum(steps)``, so a
    different chunking rounds the later nodes differently); engines that
    must agree bit for bit grow a path with the same sequence of calls.
    """

    sigma: float
    dt: float
    rng: np.random.Generator = field(repr=False)
    t: np.ndarray = field(repr=False)    # node true times, fixed spacing dt
    x: np.ndarray = field(repr=False)    # node walk values [s]

    @classmethod
    def start(cls, sigma: float, dt: float, anchor_t: float, anchor_x: float,
              rng: np.random.Generator) -> "DriftPath":
        return cls(sigma=float(sigma), dt=float(dt), rng=rng,
                   t=np.array([anchor_t], dtype=np.float64),
                   x=np.array([anchor_x], dtype=np.float64))

    @property
    def version(self) -> int:
        """Grows monotonically with the path; cheap cache-invalidation key."""
        return self.t.size

    def ensure(self, t_max: float) -> None:
        """Extend the path so its last node is at or past ``t_max``."""
        need = int(np.ceil((float(t_max) - float(self.t[-1])) / self.dt))
        if need <= 0:
            return
        n = max(need, 256)
        if self.sigma > 0.0:
            steps = self.rng.normal(0.0, self.sigma * np.sqrt(self.dt), size=n)
            # Keep per-segment local time strictly increasing even if a step
            # outruns the clock's own rate (needs sigma ~ sqrt(dt)/2, never
            # at physical rw_sigma ~ 1e-7, but the inversion must not hang).
            np.clip(steps, -0.45 * self.dt, 0.45 * self.dt, out=steps)
        else:
            steps = np.zeros(n)
        t_new = self.t[-1] + self.dt * np.arange(1, n + 1)
        self.t = np.concatenate((self.t, t_new))
        self.x = np.concatenate((self.x, self.x[-1] + np.cumsum(steps)))

    def value(self, t_true):
        """Walk value at ``t_true`` (scalar or array), extending on demand."""
        arr = np.asarray(t_true, dtype=np.float64)
        if arr.size:
            self.ensure(float(np.max(arr)))
        out = np.interp(arr, self.t, self.x)
        return out if arr.ndim else float(out)


@dataclass
class SimClock(Clock):
    """Simulated hardware clock with offset, skew and optional noise.

    ``local(t) = offset + (1 + skew) * t + rw(t)`` where ``rw`` is an
    optional random walk (std ``rw_sigma`` per square-root second)
    modelling oscillator wander. ``scale_error`` models the *frequency
    estimation* error of §4.2.1: reading the clock through a mis-estimated
    frequency multiplies elapsed local time by ``(1 + scale_error)``.

    The walk has two sampling modes. *Lazy* (the default): an increment is
    drawn from the clock's own stream at every forward read, so reads are
    scalar and their order matters. *Path*: after :meth:`drift_path`
    activates a :class:`DriftPath`, reads interpolate the pre-sampled walk
    and accept arrays, and :meth:`true_at_local` inverts the clock exactly.
    """

    offset: float = 0.0
    skew: float = 0.0
    rw_sigma: float = 0.0
    scale_error: float = 0.0
    seed: int = 0
    _rng: np.random.Generator = field(init=False, repr=False)
    _rw_t: float = field(default=0.0, init=False, repr=False)
    _rw_x: float = field(default=0.0, init=False, repr=False)
    _path: "DriftPath | None" = field(default=None, init=False, repr=False)
    _raw_nodes_cache: tuple = field(default=None, init=False, repr=False)

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.seed)

    def _random_walk(self, t_true: float) -> float:
        if self.rw_sigma <= 0.0:
            return 0.0
        dt = t_true - self._rw_t
        if dt > 0:
            self._rw_x += float(self._rng.normal(0.0, self.rw_sigma * np.sqrt(dt)))
            self._rw_t = t_true
        return self._rw_x

    def drift_path(self, dt: float) -> DriftPath:
        """Switch the walk to path mode (idempotent; returns the path).

        The path anchors at the walk's current state and samples forward on
        a ``dt`` grid from a stream derived from the clock seed, so two
        identically-seeded clocks frozen at the same state grow identical
        paths under the same sequence of :meth:`DriftPath.ensure` calls.
        """
        if self._path is None:
            self._path = DriftPath.start(
                self.rw_sigma, max(float(dt), 1e-9), self._rw_t, self._rw_x,
                derive_stream(self.seed, "drift-path"))
        return self._path

    def read(self, t_true):
        """Local clock at true time ``t_true``.

        Scalar in lazy mode; accepts arrays once a drift path is active.
        """
        if self._path is not None:
            rw = self._path.value(t_true)
        else:
            rw = self._random_walk(t_true)
        raw = self.offset + (1.0 + self.skew) * t_true + rw
        out = raw * (1.0 + self.scale_error)
        return out if np.ndim(out) else float(out)

    def read_affine(self, t_true):
        """Affine part of :meth:`read` (no random-walk term); accepts
        arrays. This is the map the vectorized network paths
        (``pingpong_batch``, the fitpoint sweep) apply to whole true-time
        batches; identical to :meth:`read` whenever ``rw_sigma == 0``.
        """
        return (self.offset + (1.0 + self.skew) * t_true) * (1.0 + self.scale_error)

    def _raw_nodes(self) -> np.ndarray:
        """Node-wise raw local readings ``offset + (1+skew) t_k + x_k``
        of the drift path, cached until the path grows."""
        path = self._path
        cache = self._raw_nodes_cache
        if cache is None or cache[0] != path.version:
            f = self.offset + (1.0 + self.skew) * path.t + path.x
            self._raw_nodes_cache = (path.version, f)
        return self._raw_nodes_cache[1]

    def cover_local(self, raw_max: float) -> None:
        """Grow the drift path until its last raw node reading reaches
        ``raw_max`` (a raw local reading, before ``scale_error``), with the
        sequence of :meth:`DriftPath.ensure` calls of :meth:`true_at_local`.
        Only the last node's reading is formed, as ``_raw_nodes`` would."""
        path = self._path
        path.ensure((raw_max - self.offset) / (1.0 + self.skew) + 2.0 * path.dt)

        def last():
            return self.offset + (1.0 + self.skew) * path.t[-1] + path.x[-1]

        while last() < raw_max:     # drift pushed the root past the horizon
            path.ensure(path.t[-1] + 16.0 * path.dt)

    def true_at_local(self, local):
        """Invert :meth:`read`: local reading -> true time (scalar or array).

        In path mode the inversion is exact: raw local readings are
        strictly increasing node to node (``DriftPath.ensure`` clips steps
        below the clock rate), so bracket the target by binary search over
        the node readings and solve the in-segment affine map. In lazy mode
        the walk is frozen at its last sampled value (the future cannot be
        anticipated).
        """
        scalar = np.ndim(local) == 0
        raw = np.asarray(local, dtype=np.float64) / (1.0 + self.scale_error)
        if self._path is None:
            out = (raw - self.offset - self._rw_x) / (1.0 + self.skew)
            return float(out) if scalar else out
        path = self._path
        rate = 1.0 + self.skew
        raw_max = float(np.max(raw)) if raw.size else -np.inf
        self.cover_local(raw_max)
        f = self._raw_nodes()
        idx = np.clip(np.searchsorted(f, raw, side="right") - 1,
                      0, f.size - 2)
        seg_slope = rate + (path.x[idx + 1] - path.x[idx]) / path.dt
        out = path.t[idx] + (raw - f[idx]) / seg_slope
        return float(out) if scalar else out

    def true_offset_to(self, other: "SimClock", t_true: float) -> float:
        """Ground-truth offset ``self - other`` at true time ``t_true``."""
        return self.read(t_true) - other.read(t_true)


@dataclass
class AdjustedClock(Clock):
    """Logical local clock starting at zero (Alg. 3 line 1 /
    GET_ADJUSTED_TIME): the initially-read timestamp is subtracted so that
    a drift model's intercept is the offset at local time zero."""

    base: Clock
    initial_time: float = 0.0

    def read(self, t_true: float) -> float:
        return self.base.read(t_true) - self.initial_time


@dataclass(frozen=True)
class LinearModel:
    """Linear model of the clock drift of one process relative to a reference.

    ``d(t_local) = slope * t_local + intercept ~= t_local - t_ref``.
    """

    slope: float = 0.0
    intercept: float = 0.0

    def normalize(self, local_time: float) -> float:
        """Algorithm 16: local time -> reference (global) time."""
        return local_time - (local_time * self.slope + self.intercept)

    def denormalize(self, global_time: float) -> float:
        """Inverse of :meth:`normalize` (exact)."""
        return (global_time + self.intercept) / (1.0 - self.slope)

    def with_intercept_from_offset(self, diff: float, diff_timestamp: float) -> "LinearModel":
        """COMPUTE_AND_SET_INTERCEPT (Alg. 4 lines 22-28): re-anchor the
        intercept from a directly measured clock offset ``diff`` observed
        at adjusted local time ``diff_timestamp``."""
        return LinearModel(self.slope, self.slope * (-diff_timestamp) + diff)

    @staticmethod
    def merge(lm_mid: "LinearModel", lm_child: "LinearModel") -> "LinearModel":
        """MERGE_LMS (Alg. 4 lines 29-31): C's model relative to R from
        M's model relative to R (``lm_mid``) and C's relative to M
        (``lm_child``); ``slope = s1 + s2 - s1*s2``, ``intercept = i1 +
        i2 - s1*i2``."""
        s1, i1 = lm_mid.slope, lm_mid.intercept
        s2, i2 = lm_child.slope, lm_child.intercept
        return LinearModel(s1 + s2 - s1 * s2, i1 + i2 - s1 * i2)


IDENTITY_MODEL = LinearModel(0.0, 0.0)


def linear_fit(x: np.ndarray, y: np.ndarray) -> LinearModel:
    """Least-squares LINEAR_FIT used by JK and HCA (Alg. 4 line 20),
    centered for numerical stability with large time values."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if x.size < 2:
        return LinearModel(0.0, float(y.mean()) if y.size else 0.0)
    xm = x.mean()
    ym = y.mean()
    dx = x - xm
    denom = float(np.dot(dx, dx))
    if denom == 0.0:
        return LinearModel(0.0, float(ym))
    slope = float(np.dot(dx, y - ym) / denom)
    intercept = float(ym - slope * xm)
    return LinearModel(slope, intercept)
