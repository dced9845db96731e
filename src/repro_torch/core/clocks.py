"""Clock models and linear drift models (paper §3.1, §4.3-4.4).

Host-side numpy, kept identical to the JAX package's ``repro.core.clocks``
so that a seeded simulated cluster draws the same clocks in both packages.

A hardware clock is modeled as an affine distortion of true time ``t``::

    local(t) = (offset + (1 + skew) * t) * (1 + scale_error)

the linearity assumption of Jones & Koenig [19] that the paper adopts
(§4.3). Random-walk clocks (``rw_sigma > 0``) are not ported yet: a
:class:`SimClock` refuses them rather than silently dropping the walk.

``LinearModel`` is the paper's (slope, intercept) drift model: a process
``r`` learns ``d_r(t_r) = t_r - t_ref ~= slope * t_r + intercept`` and
normalizes local to global time with Algorithm 16::

    global(t_r) = t_r - (slope * t_r + intercept)

``LinearModel.merge`` is MERGE_LMS of Algorithm 4.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

__all__ = [
    "SimClock",
    "LinearModel",
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


@dataclass
class SimClock:
    """Simulated hardware clock with offset, skew and frequency-estimation
    error. ``scale_error`` models the *frequency estimation* error of
    §4.2.1: reading the clock through a mis-estimated frequency multiplies
    elapsed local time by ``(1 + scale_error)``.

    ``rw_sigma`` and ``seed`` are kept so that the clock parameters match
    the reference field for field; a clock with ``rw_sigma > 0`` raises.
    """

    offset: float = 0.0
    skew: float = 0.0
    rw_sigma: float = 0.0
    scale_error: float = 0.0
    seed: int = 0

    def __post_init__(self) -> None:
        if self.rw_sigma > 0.0:
            raise ValueError("SimClock: random-walk clocks (rw_sigma > 0) are "
                             "not ported to repro_torch yet")

    def read(self, t_true):
        """Local clock at true time ``t_true`` (scalar or array)."""
        out = (self.offset + (1.0 + self.skew) * t_true) * (1.0 + self.scale_error)
        return out if np.ndim(out) else float(out)

    read_affine = read


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
