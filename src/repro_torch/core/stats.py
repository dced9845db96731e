"""The statistics the experimental design needs (§3.5, §3.4).

Copied from the JAX package's ``repro.core.stats`` (numpy only): Tukey's
outlier filter and the relative CI half-width of the mean behind
adaptive-``nrep`` stopping. The tests that certify the port run the
reference package's own statistics on its results.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "tukey_filter",
    "tukey_fences",
    "normal_ppf",
    "t_ppf",
    "mean_confidence_interval",
    "relative_ci_width",
]


def tukey_fences(x: np.ndarray, k: float = 1.5) -> tuple[float, float]:
    """``(Q1 - k*IQR, Q3 + k*IQR)`` fences of Tukey's filter."""
    x = np.asarray(x, dtype=np.float64)
    q1, q3 = np.percentile(x, [25.0, 75.0])
    iqr = q3 - q1
    return float(q1 - k * iqr), float(q3 + k * iqr)


def tukey_filter(x: np.ndarray, k: float = 1.5) -> np.ndarray:
    """Remove observations outside the Tukey fences (paper §3.5).

    Robust against OS-noise spikes and unknown warm-up length without the
    implicit bias of min-taking benchmarks (Table 2 discussion).
    """
    x = np.asarray(x, dtype=np.float64)
    if x.size < 4:
        return x
    lo, hi = tukey_fences(x, k)
    return x[(x >= lo) & (x <= hi)]


# ---------------------------------------------------------------------------
# Quantiles (numpy-only inverse normal / t)
# ---------------------------------------------------------------------------

def normal_ppf(q: float) -> float:
    """Inverse standard-normal CDF (Acklam's rational approximation,
    |rel err| < 1.15e-9)."""
    if not 0.0 < q < 1.0:
        raise ValueError(f"q must be in (0,1), got {q}")
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if q < plow:
        u = math.sqrt(-2 * math.log(q))
        return (((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4]) * u + c[5]) / \
               ((((d[0] * u + d[1]) * u + d[2]) * u + d[3]) * u + 1)
    if q > phigh:
        u = math.sqrt(-2 * math.log(1 - q))
        return -(((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4]) * u + c[5]) / \
               ((((d[0] * u + d[1]) * u + d[2]) * u + d[3]) * u + 1)
    u = q - 0.5
    r = u * u
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * u / \
           (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)


def t_ppf(q: float, df: int) -> float:
    """Student-t quantile via the Cornish-Fisher expansion in the normal
    quantile (Hill 1970 style); adequate for CI construction (df >= 3)."""
    if df <= 0:
        raise ValueError("df must be positive")
    z = normal_ppf(q)
    g1 = (z**3 + z) / 4.0
    g2 = (5 * z**5 + 16 * z**3 + 3 * z) / 96.0
    g3 = (3 * z**7 + 19 * z**5 + 17 * z**3 - 15 * z) / 384.0
    g4 = (79 * z**9 + 776 * z**7 + 1482 * z**5 - 1920 * z**3 - 945 * z) / 92160.0
    return z + g1 / df + g2 / df**2 + g3 / df**3 + g4 / df**4


def mean_confidence_interval(x: np.ndarray, level: float = 0.95) -> tuple[float, float, float]:
    """``(mean, lo, hi)`` CI of the sample mean.

    Valid when the sample mean is ~normal — per §5.1 (Fig. 15), this needs
    a sample size of >= ~30 for MPI run-time distributions.
    """
    x = np.asarray(x, dtype=np.float64)
    n = x.size
    m = float(np.mean(x))
    if n < 2:
        return m, m, m
    se = float(np.std(x, ddof=1) / math.sqrt(n))
    q = 0.5 + level / 2.0
    crit = t_ppf(q, n - 1) if n <= 60 else normal_ppf(q)
    return m, m - crit * se, m + crit * se


def relative_ci_width(x: np.ndarray, level: float = 0.95) -> float:
    """Relative half-width of the CI of the mean: ``(hi - lo) / (2 |mean|)``.

    The precision measure behind sequential (adaptive-``nrep``) stopping:
    SKaMPI-style benchmarks repeat a measurement until this drops below a
    target fraction (§3.4's "repeat until the result is stable"). Returns
    ``inf`` when the sample is too small (n < 2) or the mean is zero, so a
    caller's ``rel <= target`` check naturally keeps sampling.
    """
    x = np.asarray(x, dtype=np.float64)
    if x.size < 2:
        return float("inf")
    m, lo, hi = mean_confidence_interval(x, level)
    if m == 0.0:
        return float("inf")
    return float((hi - lo) / (2.0 * abs(m)))
