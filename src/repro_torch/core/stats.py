"""The statistics the experimental design needs (§3.5, §3.4, §6.2).

Copied from the JAX package's ``repro.core.stats`` (numpy and ``math``
only): Tukey's outlier filter, the relative CI half-width of the mean
behind adaptive-``nrep`` stopping, the Wilcoxon rank-sum test with Holm's
step-down correction and the paper's significance stars that compare two
implementations and verify guideline families, the TOST equivalence test
and bootstrap intervals that certify a reproduction, the Kruskal-Wallis
test and Cliff's delta that rank factors, and the normality and
autocorrelation diagnostics of §5.1 and §5.3.
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
    "TostResult",
    "tost_wilcoxon",
    "bootstrap_ci",
    "chi2_sf",
    "kruskal_wallis",
    "cliffs_delta",
    "jarque_bera",
    "autocorrelation",
    "autocorr_significant_lags",
    "coefficient_of_variation",
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


@dataclass(frozen=True)
class TostResult:
    """Outcome of a two-one-sided-tests (TOST) equivalence test."""

    p_value: float         # max of the two one-sided p-values
    p_lower: float         # H_a: a > (1 - margin) * b  (not too far below)
    p_upper: float         # H_a: a < (1 + margin) * b  (not too far above)
    margin: float
    n_a: int
    n_b: int

    def equivalent(self, alpha: float = 0.05) -> bool:
        """Equivalence demonstrated at ``alpha`` — deliberately a method,
        not a 5%-hardcoded property: certifying at the wrong level is the
        dangerous direction, and family-wise users must pass their
        *corrected* threshold."""
        return self.p_value <= alpha


def tost_wilcoxon(a: np.ndarray, b: np.ndarray,
                  margin: float = 0.10) -> TostResult:
    """Nonparametric TOST equivalence test with a *relative* margin.

    Difference tests (the Wilcoxon above) can only ever *fail to refute*
    sameness — "no significant difference" is weak evidence that gets
    weaker as the sample shrinks. Certifying reproducibility needs the
    burden of proof reversed: the null hypothesis here is *non*-equivalence
    (``a`` below ``(1-margin)·b`` or above ``(1+margin)·b``), and only data
    can overturn it. Both one-sided nulls are tested by the Wilcoxon
    rank-sum against the margin-scaled ``b`` sample; rejecting both (the
    reported ``p_value`` is the max, the standard intersection-union
    argument, no multiplicity correction needed between the pair) concludes
    that ``a`` lies within ``±margin`` of ``b`` on the ratio scale.

    Run-times are strictly positive, which is what makes the relative
    margin (and the scaling of ``b``) meaningful; both samples are
    required to be > 0.

    Each one-sided p is floored at ``1 / C(n_a+n_b, n_a)`` — the exact
    probability of complete separation under H0, the smallest p the exact
    rank-sum test can produce. The normal approximation dips *below* that
    at tiny n, and for an equivalence test anti-conservatism is the
    dangerous direction: it would let two or three noisy epochs "certify"
    a reproduction.
    """
    if not 0.0 < margin < 1.0:
        raise ValueError(f"margin must be in (0, 1), got {margin}")
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.size == 0 or b.size == 0:
        raise ValueError("empty sample")
    if np.any(a <= 0) or np.any(b <= 0):
        raise ValueError("tost_wilcoxon: a relative margin needs strictly "
                         "positive samples (run-times)")
    p_min = 1.0 / math.comb(a.size + b.size, a.size)
    p_lower = max(p_min,
                  wilcoxon_rank_sum(a, (1.0 - margin) * b, "greater").p_value)
    p_upper = max(p_min,
                  wilcoxon_rank_sum(a, (1.0 + margin) * b, "less").p_value)
    return TostResult(p_value=float(max(p_lower, p_upper)),
                      p_lower=float(p_lower), p_upper=float(p_upper),
                      margin=float(margin), n_a=a.size, n_b=b.size)


def bootstrap_ci(statistic, samples, n_boot: int = 1000,
                 level: float = 0.95, seed: int = 0) -> tuple[float, float]:
    """Percentile-bootstrap confidence interval of ``statistic(*samples)``.

    Each sample is resampled independently with replacement (they come
    from independent runs/epochs), the statistic is recomputed per
    replicate, and the ``(1-level)/2`` tails of the replicate distribution
    are the interval. Distribution-free — the right companion for a
    statistic like the ratio of medians, whose sampling distribution has
    no usable closed form in the paper's non-normal regime.
    """
    if not 0.0 < level < 1.0:
        raise ValueError(f"level must be in (0, 1), got {level}")
    if n_boot < 1:
        raise ValueError(f"n_boot must be >= 1, got {n_boot}")
    arrays = [np.asarray(s, dtype=np.float64) for s in samples]
    if not arrays or any(s.size == 0 for s in arrays):
        raise ValueError("empty sample")
    rng = np.random.default_rng(seed)
    reps = np.empty(n_boot, dtype=np.float64)
    for i in range(n_boot):
        reps[i] = statistic(*(s[rng.integers(0, s.size, s.size)]
                              for s in arrays))
    tail = 100.0 * (1.0 - level) / 2.0
    lo, hi = np.percentile(reps, [tail, 100.0 - tail])
    return float(lo), float(hi)


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


def chi2_sf(x: float, df: int) -> float:
    """Chi-square survival function ``P(X > x)`` for integer ``df``.

    Closed forms via the regularized upper incomplete gamma at integer and
    half-integer shape (no SciPy): for even ``df`` a finite Poisson sum,
    for odd ``df`` the erfc term plus a finite sum with half-integer
    gamma weights. Exact (up to float rounding) for every integer df —
    the null distribution of the Kruskal-Wallis H statistic below.
    """
    if df < 1:
        raise ValueError(f"df must be a positive integer, got {df}")
    if x <= 0.0:
        return 1.0
    h = x / 2.0
    if df % 2 == 0:
        # Q(h, m) = exp(-h) * sum_{k<m} h^k / k!,  m = df/2
        term, total = 1.0, 1.0
        for k in range(1, df // 2):
            term *= h / k
            total += term
        return float(min(1.0, math.exp(-h) * total))
    # odd df = 2m+1: Q = erfc(sqrt(h)) + exp(-h) * sum_{k=1..m} h^(k-1/2)/G(k+1/2)
    m = (df - 1) // 2
    total = math.erfc(math.sqrt(h))
    if m > 0:
        # h^(k-1/2) / Gamma(k+1/2), built iteratively to avoid overflow
        term = math.sqrt(h) / math.gamma(1.5)          # k = 1
        acc = term
        for k in range(2, m + 1):
            term *= h / (k - 0.5)
            acc += term
        total += math.exp(-h) * acc
    return float(min(1.0, total))


def kruskal_wallis(samples) -> tuple[float, float]:
    """Kruskal-Wallis H test across ``k`` independent samples ->
    ``(H, p_value)``.

    The k-level generalization of the Wilcoxon rank-sum test — the
    paper-consistent (nonparametric, §5.1) omnibus test for "does this
    experimental factor have *any* effect across its levels?". Tie-
    corrected; the null distribution is chi-square with ``k - 1`` degrees
    of freedom (adequate for the sweep regime, every group >= ~5).
    """
    groups = [np.asarray(s, dtype=np.float64) for s in samples]
    if len(groups) < 2:
        raise ValueError("kruskal_wallis needs at least 2 samples")
    if any(g.size == 0 for g in groups):
        raise ValueError("kruskal_wallis: empty sample")
    n = np.array([g.size for g in groups])
    total = int(n.sum())
    ranks, tie_term = _rank_with_ties(np.concatenate(groups))
    h = 0.0
    pos = 0
    for size in n:
        r = float(np.sum(ranks[pos:pos + size]))
        h += r * r / size
        pos += size
    h = 12.0 / (total * (total + 1)) * h - 3.0 * (total + 1)
    correction = 1.0 - tie_term / (total**3 - total)
    if correction <= 0.0:      # every observation tied: no information
        return 0.0, 1.0
    h /= correction
    return float(h), chi2_sf(float(h), len(groups) - 1)


def cliffs_delta(a: np.ndarray, b: np.ndarray) -> float:
    """Cliff's delta effect size ``P(a > b) - P(a < b)`` in ``[-1, 1]``.

    The ordinal companion to the rank tests: +1 means every ``a``
    observation exceeds every ``b`` (sample A strictly slower when the
    samples are run-times), 0 means complete overlap. Unlike a p-value it
    does not grow with sample size, so it is the sound *ranking* key for
    "which factors matter most" (|delta|), with the Wilcoxon/KW p-values
    gating significance.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.size == 0 or b.size == 0:
        raise ValueError("empty sample")
    bs = np.sort(b)
    n_less = np.searchsorted(bs, a, side="left").sum()     # b < a_i pairs
    n_greater = (b.size - np.searchsorted(bs, a, side="right")).sum()
    return float((int(n_less) - int(n_greater)) / (a.size * b.size))


def significance_stars(p: float) -> str:
    """The paper's asterisk notation: *** p<=0.001, ** p<=0.01, * p<=0.05."""
    if p <= 0.001:
        return "***"
    if p <= 0.01:
        return "**"
    if p <= 0.05:
        return "*"
    return ""


# ---------------------------------------------------------------------------
# Normality & independence diagnostics (§5.1, §5.3)
# ---------------------------------------------------------------------------

def jarque_bera(x: np.ndarray) -> tuple[float, float]:
    """Jarque-Bera normality test -> ``(statistic, p_value)``.

    Plays the role of the paper's KS/Shapiro-Wilk gate before a t-test
    (§6.2): the JB statistic is asymptotically chi-square(2), whose survival
    function is ``exp(-x/2)`` — no special functions needed.
    """
    x = np.asarray(x, dtype=np.float64)
    n = x.size
    if n < 8:
        return 0.0, 1.0
    m = x.mean()
    d = x - m
    s2 = float(np.mean(d**2))
    if s2 <= 0:
        return 0.0, 1.0
    skew = float(np.mean(d**3)) / s2**1.5
    kurt = float(np.mean(d**4)) / s2**2
    jb = n / 6.0 * (skew**2 + 0.25 * (kurt - 3.0) ** 2)
    return jb, float(math.exp(-jb / 2.0))


def autocorrelation(x: np.ndarray, max_lag: int = 50) -> np.ndarray:
    """ACF coefficients ``C_h / C_0`` for lags 0..max_lag (§5.3)."""
    x = np.asarray(x, dtype=np.float64)
    n = x.size
    max_lag = min(max_lag, n - 1)
    d = x - x.mean()
    c0 = float(np.dot(d, d)) / n
    if c0 <= 0:
        return np.zeros(max_lag + 1)
    acf = np.empty(max_lag + 1)
    for h in range(max_lag + 1):
        acf[h] = float(np.dot(d[: n - h], d[h:])) / n / c0
    return acf


def autocorr_significant_lags(x: np.ndarray, max_lag: int = 50) -> np.ndarray:
    """Lags (>=1) whose ACF exceeds the 95% significance bound 1.96/sqrt(n).

    Empty result => measurements can be treated as independent; otherwise
    the paper suggests sub-sampling (§5.3, Fig. 18b).
    """
    x = np.asarray(x, dtype=np.float64)
    acf = autocorrelation(x, max_lag)
    bound = 1.96 / math.sqrt(max(1, x.size))
    lags = np.arange(1, acf.size)
    return lags[np.abs(acf[1:]) > bound]


def coefficient_of_variation(x: np.ndarray) -> float:
    x = np.asarray(x, dtype=np.float64)
    m = float(np.mean(x))
    return float(np.std(x, ddof=1) / m) if x.size > 1 and m != 0 else 0.0
