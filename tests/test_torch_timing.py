"""The barrier scheme (``repro_torch.core.timing``) held against the JAX
package's ``repro.core.timing``, on the CPU.

The port's default engine (``engine="torch"``) draws the operation's
durations and finish imbalances through ``sim_durations_scan`` (its plain
version here) before the barrier loop; the reference draws them from
``net.rng`` in between. So the two consume ``net.rng`` in different
orders, and an exact comparison needs a run in which no draw matters: a
noise-free op and a noise-free network (the barrier's latencies are the
network's noise). The sync phase before it runs on the live network in
both, from one seed. ``engine="batch"`` draws from ``net.rng`` in the
reference's order, and is held to it bit for bit under live noise.
"""

import numpy as np
import pytest

from repro.core import ClockParams as RefClockParams
from repro.core import SimNet as RefNet
from repro.core import make_op as ref_make_op
from repro.core import make_sync as ref_make_sync
from repro.core import probe_barrier_skew as ref_probe_barrier_skew
from repro.core import run_barrier_timed as ref_run_barrier_timed
from repro.core import run_windowed as ref_run_windowed
from repro.core import wilcoxon_rank_sum
from repro_torch.convert import (net_from_reference, op_from_reference,
                                 sync_from_reference)
from repro_torch.core import (BarrierRun, ClockParams, SimNet, make_op,
                              make_sync, probe_barrier_skew,
                              run_barrier_timed, run_windowed)
from repro_torch.kernels.sim_scan import sim_durations_scan

NOISE_FREE = dict(noise_sigma=0.0, tail_prob=0.0, spike_prob=0.0,
                  rank_imbalance=0.0, epoch_bias_sigma=0.0, autocorr=0.0)
CPU = "cpu"
FIELDS = ("times_local", "times_global", "barrier_exit_true", "start_true",
          "end_true")


def _pair(seed, p, rw_sigma):
    ref = RefNet(p, seed=seed, clocks=RefClockParams(rw_sigma=rw_sigma))
    ref_sync = ref_make_sync("hca", n_fitpts=60, n_exchanges=20).synchronize(ref)
    return ref, ref_sync, net_from_reference(ref), sync_from_reference(ref_sync)


@pytest.mark.parametrize("rw_sigma", [0.0, 1e-7])
@pytest.mark.parametrize("library", [True, False])
@pytest.mark.parametrize("composite", [False, True])
def test_barrier_timed_exact_when_noise_free(rw_sigma, library, composite):
    """Noise-free op and network: the same campaign as the reference, at
    atol 1e-12, with affine clocks (deferred vectorized reads) and with
    lazy walking clocks (per-observation reads in the reference's order),
    through the library and the dissemination barrier."""
    ref, ref_sync, net, sync = _pair(5, 16, rw_sigma)
    for n in (ref, net):
        n.net = type(n.net)(jitter_sigma=0.0, spike_prob=0.0)
    name = "allreduce + bcast*0.5" if composite else "allreduce"
    if composite:
        from repro.core import make_composite_op as ref_make_composite_op
        op_a = ref_make_composite_op(name, **NOISE_FREE)
    else:
        op_a = ref_make_op(name, **NOISE_FREE)
    op_b = op_from_reference(op_a)
    launches = sim_durations_scan.launches
    a = ref_run_barrier_timed(ref, op_a, 4096, 300, sync=ref_sync,
                              use_library_barrier=library)
    b = run_barrier_timed(net, op_b, 4096, 300, sync=sync,
                          use_library_barrier=library, device=CPU)
    assert isinstance(b, BarrierRun)
    # on CPU tensors the wrapper runs its plain version: no launch counted
    assert sim_durations_scan.launches == launches
    for k in FIELDS:
        np.testing.assert_allclose(getattr(b, k), getattr(a, k), rtol=0,
                                   atol=1e-12)
    np.testing.assert_allclose(net.t, ref.t, rtol=0, atol=1e-12)
    if rw_sigma:
        assert all((c._rw_t, c._rw_x) == (rc._rw_t, rc._rw_x)
                   for c, rc in zip(net.clocks, ref.clocks))
        assert all(c._path is None for c in net.clocks)   # lazy, never frozen


def test_barrier_timed_without_sync_reports_local_times_only():
    ref, _, net, _ = _pair(6, 8, 0.0)
    b = run_barrier_timed(net, make_op("bcast"), 256, 50, device=CPU,
                          barrier_exit_skew=10e-6)
    assert np.isnan(b.times_global).all()
    assert (b.times_local > 0).all() and b.start_true.shape == (50, 8)
    empty = run_barrier_timed(net, make_op("bcast"), 256, 0, device=CPU)
    assert empty.times_local.shape == (0,)


@pytest.mark.parametrize("library,skew", [(True, 40e-6), (True, 0.0),
                                          (False, 0.0)])
def test_probe_barrier_skew_exact(library, skew):
    """Host-only: one seed gives the reference's exit profile to the bit."""
    ref = RefNet(16, seed=12)
    net = net_from_reference(ref)
    a = ref_probe_barrier_skew(ref, 200, barrier_exit_skew=skew,
                               use_library_barrier=library)
    b = probe_barrier_skew(net, 200, barrier_exit_skew=skew,
                           use_library_barrier=library)
    assert np.array_equal(a, b)
    assert np.array_equal(ref.t, net.t) and ref.msg_count == net.msg_count
    if skew:
        means = b.mean(axis=0)
        assert means[1:].max() > 20e-6 and means[-5:].mean() > means[:5].mean()


@pytest.mark.parametrize("rw_sigma", [0.0, 1e-7])
def test_barrier_timed_matches_reference_statistically(rw_sigma):
    """Live op and network noise, the library barrier at a 20 us exit skew:
    local-max and global times are Wilcoxon-indistinguishable from the
    reference's, means within 3%. The epoch bias is drawn first in both,
    so both measure one launch epoch. The means need thousands of calls:
    about one barrier in twenty meets a network spike (25x a latency)."""
    p, nrep = 8, 4000
    ref = RefNet(p, seed=24, clocks=RefClockParams(rw_sigma=rw_sigma))
    ref_sync = ref_make_sync("hca", n_fitpts=60, n_exchanges=20).synchronize(ref)
    net = SimNet(p, seed=24, clocks=ClockParams(rw_sigma=rw_sigma))
    sync = make_sync("hca", n_fitpts=60, n_exchanges=20).synchronize(net)
    op_a, op_b = ref_make_op("allreduce"), make_op("allreduce")
    assert op_a._bias_for(ref) == op_b._bias_for(net)
    a = ref_run_barrier_timed(ref, op_a, 32768, nrep, sync=ref_sync,
                              barrier_exit_skew=20e-6)
    b = run_barrier_timed(net, op_b, 32768, nrep, sync=sync,
                          barrier_exit_skew=20e-6, device=CPU)
    for k in ("times_local", "times_global"):
        x, y = getattr(a, k), getattr(b, k)
        res = wilcoxon_rank_sum(x, y)
        assert res.p_value > 0.05, (k, res.p_value)
        assert abs(x.mean() - y.mean()) < 0.03 * x.mean(), k


def _same_state(ref, net, op_a, op_b):
    """The two nets and ops end in one state: clocks, generator, AR(1)."""
    assert np.array_equal(net.t, ref.t) and net.msg_count == ref.msg_count
    assert net.rng.bit_generator.state == ref.rng.bit_generator.state
    assert op_b._ar_state == op_a._ar_state
    assert all((c._rw_t, c._rw_x) == (rc._rw_t, rc._rw_x)
               for c, rc in zip(net.clocks, ref.clocks))


@pytest.mark.parametrize("rw_sigma", [0.0, 1e-7])
@pytest.mark.parametrize("library", [True, False])
@pytest.mark.parametrize("synced", [True, False])
@pytest.mark.parametrize("composite", [False, True])
def test_barrier_batch_equals_reference_bit_for_bit(rw_sigma, library, synced,
                                                    composite):
    """``engine="batch"`` under live op and network noise: every field of
    the run equal to the reference's bit for bit, on affine clocks (the
    durations and imbalance drawn first, then the barriers) and on walking
    clocks (one ``execute`` per observation, after its barrier), with and
    without sync, through both barriers; the nets, generators, AR(1)
    carries and walks end in the same state. No launch on the CPU."""
    ref, ref_sync, net, sync = _pair(7, 8, rw_sigma)
    if composite:
        from repro.core import make_composite_op as ref_make_composite_op
        op_a = ref_make_composite_op("allreduce + bcast*0.5")
    else:
        op_a = ref_make_op("allreduce")
    op_b = op_from_reference(op_a)
    launches = sim_durations_scan.launches
    kw = dict(barrier_exit_skew=20e-6, use_library_barrier=library)
    a = ref_run_barrier_timed(ref, op_a, 32768, 200,
                              sync=ref_sync if synced else None, **kw)
    b = run_barrier_timed(net, op_b, 32768, 200, sync=sync if synced else None,
                          device=CPU, engine="batch", **kw)
    assert sim_durations_scan.launches == launches
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k), err_msg=k)
    assert np.isnan(b.times_global).all() != synced
    terms = [(t, u) for (t, _, _), (u, _, _) in zip(op_a.terms, op_b.terms)] \
        if composite else [(op_a, op_b)]
    for ta, tb in terms:
        _same_state(ref, net, ta, tb)


def test_barrier_batch_figs_11_12_rows_equal_the_reference():
    """The Figs. 11-12 bench (``benchmarks/suite.py``) at its p 16 and
    nrep 300, in both packages from one seed: the window row (the numpy
    batch engine), the barrier row (``engine="batch"``) and both exit-skew
    rows equal to the bit, and Fig. 11's inequality holds."""
    op_kw = dict(rank_imbalance=0.01, noise_sigma=0.01, tail_prob=0.0)
    sync_kw = dict(n_fitpts=200, n_exchanges=40)
    rows = {}
    for pkg, (Net, mk_op, mk_sync, windowed, barrier, probe, dev) in {
        "ref": (RefNet, ref_make_op, ref_make_sync, ref_run_windowed,
                ref_run_barrier_timed, ref_probe_barrier_skew, {}),
        "port": (SimNet, make_op, make_sync, run_windowed, run_barrier_timed,
                 probe_barrier_skew, dict(device=CPU, engine="batch")),
    }.items():
        net = Net(16, seed=11)
        sync = mk_sync("hca", **sync_kw).synchronize(net)
        wr = windowed(net, sync, mk_op("allreduce", **op_kw), 32768, 300,
                      500e-6, **dev)
        br = barrier(Net(16, seed=11), mk_op("allreduce", **op_kw), 32768, 300,
                     barrier_exit_skew=40e-6, **dev)
        lib = probe(Net(16, seed=12), nrep=300, barrier_exit_skew=40e-6)
        dis = probe(Net(16, seed=12), nrep=300, use_library_barrier=False)
        rows[pkg] = (wr.valid_times.mean() * 1e6, np.mean(br.times_local) * 1e6,
                     lib.mean(axis=0).max() * 1e6, dis.mean(axis=0).max() * 1e6)
    assert rows["port"] == rows["ref"]
    window, barrier_mean, lib_skew, dis_skew = rows["port"]
    assert barrier_mean > window and lib_skew > dis_skew


def test_barrier_engine_rules(monkeypatch):
    """An unknown engine raises, and so does the reference's own ``jax``;
    ``batch`` on walking clocks refuses a CUDA device and names both ways
    out, before any draw; ``torch`` stays the default."""
    import inspect

    assert inspect.signature(run_barrier_timed).parameters["engine"].default == "torch"
    net = SimNet(4, seed=1, clocks=ClockParams(rw_sigma=1e-7))
    state = net.rng.bit_generator.state
    for engine in ("jax", "auto", "scalar", "numpy"):
        with pytest.raises(ValueError, match=f"unknown engine '{engine}'"):
            run_barrier_timed(net, make_op("bcast"), 256, 10, device=CPU,
                              engine=engine)
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match=r"device='cpu', or engine='torch'"):
        run_barrier_timed(net, make_op("bcast"), 256, 10, device="cuda",
                          engine="batch")
    assert net.rng.bit_generator.state == state
    monkeypatch.undo()
    # without a card, "cuda" raises as every entry point does
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_barrier_timed(SimNet(4, seed=1), make_op("bcast"), 256, 10,
                          engine="batch")
