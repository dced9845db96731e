"""The port's statistics (``repro_torch.core.stats``) held against the JAX
package's ``repro.core.stats`` on seeded inputs: both are numpy and
``math`` only, so each statistic agrees to the bit."""

import dataclasses

import numpy as np
import pytest

from repro.core import stats as ref
from repro_torch.core import stats


def _samples(seed, sizes=(40, 55, 30), tie=False):
    rng = np.random.default_rng(seed)
    out = [rng.lognormal(-11.0 + 0.05 * i, 0.3, n) for i, n in enumerate(sizes)]
    if tie:
        out = [np.round(s, 7) for s in out]
    return out


@pytest.mark.parametrize("margin", [0.05, 0.10, 0.30])
@pytest.mark.parametrize("sizes", [(3, 3), (30, 45), (400, 380)])
def test_tost_wilcoxon(margin, sizes):
    a, b = _samples(1, sizes)
    got, want = stats.tost_wilcoxon(a, b, margin), ref.tost_wilcoxon(a, b, margin)
    assert isinstance(got, stats.TostResult)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.equivalent(0.05) == want.equivalent(0.05)


def test_tost_wilcoxon_rejects_what_the_reference_rejects():
    a, b = _samples(2, (10, 10))
    for bad in (dict(margin=0.0), dict(margin=1.0)):
        with pytest.raises(ValueError):
            stats.tost_wilcoxon(a, b, **bad)
    with pytest.raises(ValueError, match="positive"):
        stats.tost_wilcoxon(a - 1.0, b)
    with pytest.raises(ValueError):
        stats.tost_wilcoxon(np.empty(0), b)


@pytest.mark.parametrize("n_boot,level", [(1, 0.9), (200, 0.95), (500, 0.99)])
def test_bootstrap_ci(n_boot, level):
    a, b = _samples(3, (25, 35))

    def ratio(x, y):
        return float(np.median(x) / np.median(y))

    assert stats.bootstrap_ci(ratio, (a, b), n_boot, level, seed=4) == \
        ref.bootstrap_ci(ratio, (a, b), n_boot, level, seed=4)


@pytest.mark.parametrize("df", [1, 2, 3, 4, 7, 10, 31])
@pytest.mark.parametrize("x", [0.0, 0.3, 2.5, 11.0, 80.0])
def test_chi2_sf(df, x):
    assert stats.chi2_sf(x, df) == ref.chi2_sf(x, df)


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("k", [2, 3, 5])
def test_kruskal_wallis_and_cliffs_delta(tie, k):
    groups = _samples(5, (12, 30, 7, 25, 16)[:k], tie=tie)
    assert stats.kruskal_wallis(groups) == ref.kruskal_wallis(groups)
    assert stats.cliffs_delta(groups[0], groups[1]) == \
        ref.cliffs_delta(groups[0], groups[1])
    same = [np.ones(5), np.ones(4)]
    assert stats.kruskal_wallis(same) == ref.kruskal_wallis(same) == (0.0, 1.0)


@pytest.mark.parametrize("n", [5, 50, 2000])
def test_diagnostics(n):
    rng = np.random.default_rng(n)
    eps = rng.normal(0.0, 1.0, n)
    x = np.empty(n)
    x[0] = eps[0]
    for i in range(1, n):          # AR(1): significant low lags
        x[i] = 0.6 * x[i - 1] + eps[i]
    assert stats.jarque_bera(x) == ref.jarque_bera(x)
    assert np.array_equal(stats.autocorrelation(x, 20), ref.autocorrelation(x, 20))
    assert np.array_equal(stats.autocorr_significant_lags(x, 20),
                          ref.autocorr_significant_lags(x, 20))
    assert stats.coefficient_of_variation(x + 10.0) == \
        ref.coefficient_of_variation(x + 10.0)
    assert stats.coefficient_of_variation(np.ones(1)) == 0.0
