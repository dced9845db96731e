"""The port's experimental design with its epoch fan-out
(``repro_torch.core.design``) and retry policy (``repro_torch.core.retry``),
held against the JAX package's, on the CPU."""

import operator
import warnings

import numpy as np
import pytest

from repro.core import ExperimentDesign as RefDesign
from repro.core import RetryPolicy as RefRetryPolicy
from repro.core import case_orders as ref_case_orders
from repro_torch.campaign import TorchSimBackend
from repro_torch.core import (ExperimentDesign, RetryBudgetExceeded,
                              RetryPolicy, TestCase, case_orders,
                              map_parallel, retry_call, run_design)

CASES = [TestCase("allreduce", 256), TestCase("bcast", 4096)]


def _backend():
    return TorchSimBackend(p=4, seed0=50, device="cpu",
                           sync_kw=dict(n_fitpts=30, n_exchanges=10))


def test_epoch_parallel_run_design_reproduces_serial():
    """Spawned workers (each its own torch) give the serial records bit
    for bit, in the serial order."""
    design = ExperimentDesign(n_launch_epochs=4, nrep=25, seed=3)
    serial = run_design(design, _backend(), cases=CASES, n_workers=1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        parallel = run_design(design, _backend(), cases=CASES, n_workers=2)
    assert not [w for w in caught if "serially" in str(w.message)]
    assert len(serial) == len(parallel) == 8
    for a, b in zip(serial, parallel):
        assert (a.case, a.epoch) == (b.case, b.epoch)
        assert np.array_equal(a.times, b.times)
        assert a.meta == b.meta


class _LambdaBackend:
    """A backend whose ``measure`` is a lambda: it cannot be pickled."""

    def __init__(self):
        self.inner = _backend()
        self.make_epoch = self.inner.make_epoch
        self.measure = lambda ctx, case, nrep: self.inner.measure(ctx, case, nrep)


def test_run_design_unpicklable_falls_back_to_serial():
    design = ExperimentDesign(n_launch_epochs=2, nrep=5, seed=0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        records = run_design(design, _LambdaBackend(), cases=CASES[:1],
                             n_workers=2)
    assert len(records) == 2 and all(r.times.size for r in records)
    assert any("not picklable" in str(w.message) for w in caught)


def test_run_design_legacy_pair_and_default_cases():
    design = ExperimentDesign(n_launch_epochs=2, nrep=5, seed=1)
    backend = _backend()
    with pytest.warns(DeprecationWarning, match="deprecated"):
        pair = run_design(design, backend.make_epoch, backend.measure,
                          cases=CASES)
    assert len(pair) == 4
    assert len(run_design(design, _backend())) == 4    # default_cases()
    with pytest.raises(TypeError):
        run_design(design, object(), cases=CASES)


def test_map_parallel_keeps_submission_order():
    seen = []
    out = map_parallel(operator.add, [(1, 2), (3, 4), (5, 6)], 2,
                       on_result=lambda i, r: seen.append((i, r)))
    assert out == [3, 7, 11]
    assert sorted(seen) == [(0, 3), (1, 7), (2, 11)]
    assert map_parallel(operator.add, [], 2) == []


def test_design_replace_and_case_orders():
    design = ExperimentDesign(n_launch_epochs=5, nrep=7, seed=9)
    other = design.replace(nrep=11, shuffle=False)
    assert (other.nrep, other.shuffle, other.seed) == (11, False, 9)
    assert design.nrep == 7
    ref = RefDesign(n_launch_epochs=5, nrep=7, seed=9)
    assert [[c.key() for c in o] for o in case_orders(design, CASES)] == \
        [[c.key() for c in o] for o in ref_case_orders(ref, CASES)]


@pytest.mark.parametrize("kw", [dict(seed=3), dict(seed=3, deadline=0.15),
                                dict(base=0.0, seed=1),
                                dict(base=0.2, factor=3.0, max_delay=1.0,
                                     attempts=6, seed=7)])
def test_retry_policy_schedule_matches_reference(kw):
    ours, theirs = RetryPolicy(**kw), RefRetryPolicy(**kw)
    for key in (0, 5):
        assert list(ours.delays(key)) == list(theirs.delays(key))
        assert [ours.ceiling(k) for k in range(4)] == \
            [theirs.ceiling(k) for k in range(4)]


def test_retry_call():
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    policy = RetryPolicy(base=0.01, attempts=4, seed=0)
    assert retry_call(flaky, policy, sleep=slept.append) == "ok"
    assert len(calls) == 3 and slept == list(policy.delays())[:2]
    with pytest.raises(RetryBudgetExceeded) as info:
        retry_call(lambda: 1 / 0, policy, sleep=slept.append)
    assert info.value.attempts == 4
    with pytest.raises(KeyError):       # not in retry_on: no retry
        retry_call(lambda: {}["x"], policy, retry_on=(OSError,),
                   sleep=slept.append)
    for bad in (dict(factor=0.5), dict(attempts=0), dict(base=-1.0)):
        with pytest.raises(ValueError):
            RetryPolicy(**bad)
