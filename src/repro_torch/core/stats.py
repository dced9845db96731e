"""The statistics the experimental design needs (§3.5, §3.4, §6.2).

Copied from the JAX package's ``repro.core.stats`` (numpy only): Tukey's
outlier filter, the relative CI half-width of the mean behind
adaptive-``nrep`` stopping, and the Wilcoxon rank-sum test with Holm's
step-down correction and the paper's significance stars that compare two
implementations and verify guideline families. The tests that certify the
port run the reference package's own statistics on its results.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

__all__ = [
    "tukey_filter",
    "tukey_fences",
    "normal_ppf",
    "t_ppf",
    "mean_confidence_interval",
    "relative_ci_width",
    "RankSumResult",
    "wilcoxon_rank_sum",
    "holm_bonferroni",
    "significance_stars",
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


# ---------------------------------------------------------------------------
# Wilcoxon rank-sum (Mann-Whitney) test (§6.2)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RankSumResult:
    statistic: float       # Mann-Whitney U of sample A
    z: float               # normal-approximation z score
    p_value: float
    alternative: str
    n_a: int
    n_b: int

    @property
    def significant(self) -> bool:
        return self.p_value <= 0.05

    @property
    def stars(self) -> str:
        return significance_stars(self.p_value)


def _rank_with_ties(values: np.ndarray) -> tuple[np.ndarray, float]:
    """Midranks plus the tie-correction term ``sum(t^3 - t)``."""
    order = np.argsort(values, kind="mergesort")
    ranks = np.empty(values.size, dtype=np.float64)
    sorted_vals = values[order]
    tie_term = 0.0
    i = 0
    while i < values.size:
        j = i
        while j + 1 < values.size and sorted_vals[j + 1] == sorted_vals[i]:
            j += 1
        avg_rank = 0.5 * (i + j) + 1.0
        ranks[order[i:j + 1]] = avg_rank
        t = j - i + 1
        if t > 1:
            tie_term += t**3 - t
        i = j + 1
    return ranks, tie_term


def wilcoxon_rank_sum(a: np.ndarray, b: np.ndarray,
                      alternative: str = "two-sided") -> RankSumResult:
    """WILCOXON TEST of the paper (§6.2): nonparametric comparison of two
    independent samples (e.g. the 30 per-mpirun medians of two MPI
    libraries, Fig. 28).

    ``alternative='less'`` tests H_a: A < B (the "is library X faster?"
    question of Fig. 30); ``'greater'`` the reverse. Normal approximation
    with tie correction and continuity correction — appropriate for the
    paper's regime (n >= ~10 per side).
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n1, n2 = a.size, b.size
    if n1 == 0 or n2 == 0:
        raise ValueError("empty sample")
    if alternative not in ("two-sided", "less", "greater"):
        raise ValueError(f"unknown alternative {alternative!r}")
    combined = np.concatenate([a, b])
    ranks, tie_term = _rank_with_ties(combined)
    r1 = float(np.sum(ranks[:n1]))
    u1 = r1 - n1 * (n1 + 1) / 2.0   # Mann-Whitney U of sample A
    mu = n1 * n2 / 2.0
    n = n1 + n2
    sigma2 = n1 * n2 / 12.0 * ((n + 1) - tie_term / (n * (n - 1)))
    if sigma2 <= 0.0:
        # every observation tied: under the permutation null every
        # assignment yields this same U, so the exact p is 1 for every
        # alternative — crucially NOT 0, which the continuity-corrected
        # normal approximation would produce from the floored sigma (and
        # which would let two bit-identical constant runs test "different")
        return RankSumResult(statistic=u1, z=0.0, p_value=1.0,
                             alternative=alternative, n_a=n1, n_b=n2)
    sigma = math.sqrt(sigma2)

    def z_of(u: float, shift: float) -> float:
        return (u - mu + shift) / sigma

    if alternative == "two-sided":
        z = z_of(u1, -0.5 * math.copysign(1.0, u1 - mu))
        p = 2.0 * 0.5 * math.erfc(abs(z) / math.sqrt(2.0))
        p = min(1.0, p)
    elif alternative == "less":
        # small U1 (A ranked low -> A smaller) is evidence for A < B
        z = z_of(u1, +0.5)
        p = 0.5 * math.erfc(-z / math.sqrt(2.0))  # P(Z <= z)
    elif alternative == "greater":
        z = z_of(u1, -0.5)
        p = 0.5 * math.erfc(z / math.sqrt(2.0))   # P(Z >= z)
    else:
        raise ValueError(f"unknown alternative {alternative!r}")
    return RankSumResult(statistic=u1, z=z, p_value=float(p),
                         alternative=alternative, n_a=n1, n_b=n2)


def holm_bonferroni(pvals) -> np.ndarray:
    """Holm's step-down adjusted p-values (family-wise error control).

    Verifying a whole family of performance guidelines means one Wilcoxon
    test per (guideline, message size) cell; declaring a violation whenever
    any raw p <= alpha would inflate the family-wise false-violation rate
    far past alpha. Holm's procedure — ``adj_(i) = max_{j<=i} (m-j+1) *
    p_(j)`` over the ascending order, clipped at 1 — is uniformly more
    powerful than plain Bonferroni and needs no independence assumption,
    which matters because guideline tests share measurement cells.
    """
    p = np.asarray(pvals, dtype=np.float64)
    if p.ndim != 1:
        raise ValueError("holm_bonferroni expects a 1-D array of p-values")
    m = p.size
    if m == 0:
        return p.copy()
    if np.any((p < 0) | (p > 1) | ~np.isfinite(p)):
        raise ValueError("p-values must be finite and in [0, 1]")
    order = np.argsort(p, kind="mergesort")
    stepped = (m - np.arange(m)) * p[order]
    adj_sorted = np.minimum(np.maximum.accumulate(stepped), 1.0)
    adj = np.empty(m)
    adj[order] = adj_sorted
    return adj


def significance_stars(p: float) -> str:
    """The paper's asterisk notation: *** p<=0.001, ** p<=0.01, * p<=0.05."""
    if p <= 0.001:
        return "***"
    if p <= 0.01:
        return "**"
    if p <= 0.05:
        return "*"
    return ""
