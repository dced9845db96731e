"""The port's device engine (``repro_torch.simengine``) held against the
JAX package, on the CPU.

Three levels, at the reference's own bounds:

  * exact on injected inputs — the per-epoch window math against the
    reference jit engine's ``window`` core on the same durations and
    clock/sync arrays;
  * exact when noise-free — a whole measurement against the numpy
    ``batch`` engine from the same carried state
    (``tests/test_batch_equivalence.py``);
  * statistical when live — Philox/Mersenne draws against numpy draws.

The fused engine is held against the per-epoch port bit for bit (it runs
the per-epoch window on lanes drawn bit-identically), so a campaign's
records do not depend on how its epochs were scheduled. Random-walk clocks are
held against the reference's ``batch_rw`` engine the same two ways
(exact on frozen drift paths when noise-free, statistical when live).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ClockParams as RefClockParams
from repro.core import SimNet as RefNet
from repro.core import make_op as ref_make_op
from repro.core import make_sync as ref_make_sync
from repro.core import run_windowed, wilcoxon_rank_sum
from repro.simjax.engine import _cores
from repro_torch import simengine
from repro_torch.campaign import TorchSimBackend
from repro_torch.convert import (net_from_reference, op_from_reference,
                                 sync_from_reference)
from repro_torch.campaign import Campaign, CampaignSpec
from repro_torch.core import (ClockParams, ExperimentDesign, SimNet, TestCase,
                              make_composite_op, make_op, make_sync)
from repro_torch.core.clocks import SimClock
from repro_torch.simengine import (SimTorchUnavailable,
                                   run_windowed_epochs_torch,
                                   run_windowed_torch, sample_durations_torch)

NOISE_FREE = dict(noise_sigma=0.0, tail_prob=0.0, spike_prob=0.0,
                  rank_imbalance=0.0, epoch_bias_sigma=0.0, autocorr=0.0)
CPU = "cpu"


def _ref_synced(seed, p, n_fitpts=100, n_exchanges=20, rw_sigma=0.0):
    net = RefNet(p, seed=seed, clocks=RefClockParams(rw_sigma=rw_sigma))
    sync = ref_make_sync("hca", n_fitpts=n_fitpts,
                         n_exchanges=n_exchanges).synchronize(net)
    return net, sync


def _synced(seed, p, rw_sigma=0.0):
    net = SimNet(p, seed=seed, clocks=ClockParams(rw_sigma=rw_sigma))
    return net, make_sync("hca", n_fitpts=100, n_exchanges=20).synchronize(net)


def _epochs(E, p=8, seed0=7, op="allreduce", **op_kw):
    nets, syncs, ops = [], [], []
    for e in range(E):
        net = SimNet(p, seed=seed0 + 1000 * e)
        syncs.append(make_sync("hca", n_fitpts=60,
                               n_exchanges=20).synchronize(net))
        nets.append(net)
        ops.append(make_op(op, **op_kw))
    return nets, syncs, ops


# ---------------------------------------------------------------------------
# Per-epoch engine against the reference
# ---------------------------------------------------------------------------

def test_window_exact_on_injected_inputs():
    """The same durations and clock/sync coefficients through the port's
    float64 window and the reference's jit ``window`` core: equal times,
    global/true start and end stamps, and error flags. Durations around
    the window size make both flags fire."""
    net, sync = _ref_synced(3, p=8)
    ranks = range(net.p)
    arrays = dict(
        t0=net.t.copy(),
        off=np.array([net.clocks[r].offset for r in ranks]),
        skew=np.array([net.clocks[r].skew for r in ranks]),
        scale=np.array([net.clocks[r].scale_error for r in ranks]),
        slope=np.array([sync.models[r].slope for r in ranks]),
        intercept=np.array([sync.models[r].intercept for r in ranks]),
        init_t=np.array([sync.initial_times[r] for r in ranks]))
    win = 300e-6
    start = max(sync.global_time(net, r) for r in ranks) + win
    dur = np.random.default_rng(0).uniform(50e-6, 420e-6, 256)
    with jax.enable_x64(True):
        _, _, window = _cores()
        ref = window(jnp.asarray(dur), jax.random.PRNGKey(0),
                     *(jnp.asarray(arrays[k]) for k in arrays), 0.0, start, win)
        ref = [np.asarray(x) for x in ref]
    out = simengine._window(torch.from_numpy(dur), torch.Generator(),
                            *(torch.from_numpy(arrays[k]) for k in arrays),
                            0.0, start, win)
    out = [x.numpy() for x in out]
    assert np.array_equal(out[1], ref[1])
    assert 0 < np.count_nonzero(ref[1]) < dur.size
    for got, want in zip(out[:1] + out[2:], ref[:1] + ref[2:]):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_per_epoch_exact_against_numpy_batch_when_noise_free():
    """From the same carried state, a noise-free measurement is the same
    campaign in both engines: times, error flags, true and estimated
    stamps, and the simulator's final state."""
    net_a, sync_a = _ref_synced(5, p=16)
    op_a = ref_make_op("allreduce", **NOISE_FREE)
    net_b, sync_b = net_from_reference(net_a), sync_from_reference(sync_a)
    op_b = op_from_reference(op_a)
    a = run_windowed(net_a, sync_a, op_a, 4096, 400, 300e-6, engine="batch")
    b = run_windowed_torch(net_b, sync_b, op_b, 4096, 400, 300e-6, device=CPU)
    np.testing.assert_allclose(b.times, a.times, rtol=0, atol=1e-12)
    assert np.array_equal(a.errors, b.errors)
    for k in ("start_true", "end_true", "start_global_est"):
        np.testing.assert_allclose(getattr(b, k), getattr(a, k), rtol=0,
                                   atol=1e-12)
    np.testing.assert_allclose(net_b.t, net_a.t, rtol=0, atol=1e-12)


def test_per_epoch_matches_numpy_batch_statistically():
    net_a, sync_a = _ref_synced(7, p=16)
    net_b, sync_b = _synced(7, p=16)
    a = run_windowed(net_a, sync_a, ref_make_op("allreduce"), 4096, 3000,
                     300e-6, engine="batch")
    b = run_windowed_torch(net_b, sync_b, make_op("allreduce"), 4096, 3000,
                           300e-6, device=CPU)
    res = wilcoxon_rank_sum(a.valid_times, b.valid_times)
    assert res.p_value > 0.05, res.p_value
    assert abs(a.valid_times.mean() - b.valid_times.mean()) \
        < 0.02 * a.valid_times.mean()
    assert abs(a.invalid_fraction - b.invalid_fraction) < 0.05


def test_composite_chunking_and_ar_state():
    """Composite ops sample each term at its own size; consecutive chunks
    stay on one monotone timeline and advance each term's AR(1) state."""
    net, sync = _synced(11, p=4)
    op = make_composite_op("allreduce + bcast*0.5")
    w1 = run_windowed_torch(net, sync, op, 512, 40, 400e-6, device=CPU)
    states = [term._ar_state for term, _, _ in op.terms]
    w2 = run_windowed_torch(net, sync, op, 512, 37, 400e-6, device=CPU)
    assert w1.times.shape == (40,) and w2.times.shape == (37,)
    assert w2.start_true.min() > w1.end_true.max() - 1e-9
    assert all(s1 != s2 for s1, s2 in
               zip(states, [term._ar_state for term, _, _ in op.terms]))


@pytest.mark.parametrize("rw_sigma", [0.0, 1e-7], ids=["affine", "walking"])
def test_grids_read_after_the_next_window_are_unchanged(rw_sigma):
    """A window's grids stay on the device until read: read after a second
    window has run on the same net, they equal those of a twin that read
    them as soon as its first window returned, bit for bit, and so do the
    second windows and the nets."""
    net, sync = _synced(13, p=8, rw_sigma=rw_sigma)
    late = (net, sync, make_op("allreduce"))
    now = copy.deepcopy(late)
    grids = ("start_global_est", "end_global_est", "start_true", "end_true")
    n1 = run_windowed_torch(*now, 512, 300, 400e-6, device=CPU)
    eager = {k: getattr(n1, k).copy() for k in grids}
    n2 = run_windowed_torch(*now, 512, 280, 400e-6, device=CPU)
    l1 = run_windowed_torch(*late, 512, 300, 400e-6, device=CPU)
    l2 = run_windowed_torch(*late, 512, 280, 400e-6, device=CPU)
    for k in grids:
        assert np.array_equal(getattr(l1, k), eager[k]), k
        assert np.array_equal(getattr(l2, k), getattr(n2, k)), k
    for a, b in ((l1, n1), (l2, n2)):
        assert np.array_equal(a.times, b.times) and np.array_equal(a.errors, b.errors)
    assert np.array_equal(late[0].t, now[0].t)
    assert l2.start_true.min() > l1.end_true.max() - 1e-9


# ---------------------------------------------------------------------------
# Random-walk clocks against the reference's batch_rw engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frozen,win,p", [(True, 300e-6, 16), (False, 300e-6, 16),
                                          (True, 12e-6, 16), (False, 12e-6, 16),
                                          (False, 300e-6, 96)])
def test_per_epoch_rw_exact_against_batch_rw_when_noise_free(frozen, win, p):
    """Noise-free, the port on walking clocks computes the reference's
    ``batch_rw`` campaign: drift paths grown by the same sequence of calls
    (bit-equal nodes), the deadline inversion and forward reads on the
    device, identical flags (the 12 us window sets both) and ``net.t``.
    ``frozen`` activates the paths before the call, as the reference's
    test does; otherwise the engine activates them itself. A second call
    continues on the grown paths. At p = 96 the paths grow on threads."""
    net_a, sync_a = _ref_synced(5, p=p, rw_sigma=1e-7)
    if frozen:
        net_a.freeze_drift_paths(win)
    op_a = ref_make_op("allreduce", **NOISE_FREE)
    net_b, sync_b = net_from_reference(net_a), sync_from_reference(sync_a)
    op_b = op_from_reference(op_a)
    for nrep in (300, 1100):
        a = run_windowed(net_a, sync_a, op_a, 4096, nrep, win, engine="batch_rw")
        b = run_windowed_torch(net_b, sync_b, op_b, 4096, nrep, win, device=CPU)
        assert np.array_equal(a.errors, b.errors)
        np.testing.assert_allclose(b.times, a.times, rtol=0, atol=1e-12)
        for k in ("start_true", "end_true", "start_global_est",
                  "end_global_est"):
            np.testing.assert_allclose(getattr(b, k), getattr(a, k), rtol=0,
                                       atol=1e-12)
        np.testing.assert_allclose(net_b.t, net_a.t, rtol=0, atol=1e-12)
        for ca, cb in zip(net_a.clocks, net_b.clocks):
            assert np.array_equal(ca._path.t, cb._path.t)
            assert np.array_equal(ca._path.x, cb._path.x)
    if win < 100e-6:
        assert np.count_nonzero(a.errors & 1) and np.count_nonzero(a.errors & 2)
    else:
        assert not a.errors.any()


def test_drift_paths_cross_to_the_device_once(monkeypatch):
    """The device mirror of a net's paths is kept between calls and sent
    only the nodes appended since: once for the deadlines, and again in a
    call only when the forward reads outran them (a 12 us window)."""
    sent = []
    upload = simengine._DevicePaths.upload

    def counted(self):
        before = sum(self.sent)
        upload(self)
        sent.append(sum(self.sent) - before)

    monkeypatch.setattr(simengine._DevicePaths, "upload", counted)
    net, sync = _synced(5, p=8, rw_sigma=1e-7)
    op = make_op("allreduce", **NOISE_FREE)
    run_windowed_torch(net, sync, op, 4096, 300, 12e-6, device=CPU)
    mirror = simengine._MIRRORS[net]
    run_windowed_torch(net, sync, op, 4096, 1100, 12e-6, device=CPU)
    assert simengine._MIRRORS[net] is mirror
    assert len(sent) >= 3 and all(n > 0 for n in sent)
    assert sum(sent) == sum(c._path.t.size for c in net.clocks)
    assert mirror.sent == [c._path.t.size for c in net.clocks]


def test_per_epoch_rw_matches_batch_rw_statistically():
    """Live noise on walking clocks: the port's device draws against the
    reference's numpy draws, Wilcoxon-indistinguishable, means within 2%.

    Both measure the same launch epoch: the epoch bias (a per-epoch
    constant, ±2%) is drawn first in both, from the same stream position;
    left to the engines, the port would draw its window seed before it
    and so a different epoch's bias."""
    net_a, sync_a = _ref_synced(7, p=8, rw_sigma=1e-7)
    net_b, sync_b = _synced(7, p=8, rw_sigma=1e-7)
    op_a, op_b = ref_make_op("allreduce"), make_op("allreduce")
    assert op_a._bias_for(net_a) == op_b._bias_for(net_b)
    a = run_windowed(net_a, sync_a, op_a, 4096, 2500, 300e-6,
                     engine="batch_rw")
    b = run_windowed_torch(net_b, sync_b, op_b, 4096, 2500, 300e-6,
                           device=CPU)
    res = wilcoxon_rank_sum(a.valid_times, b.valid_times)
    assert res.p_value > 0.05, res.p_value
    assert abs(a.valid_times.mean() - b.valid_times.mean()) \
        < 0.02 * a.valid_times.mean()


def test_walking_clock_campaign_measures_per_epoch():
    """``TorchSimBackend`` on walking clocks: the fused capability steps
    aside, ``Campaign`` measures each epoch through the per-epoch engine,
    and every record says so."""
    backend = TorchSimBackend(p=4, device=CPU, clock_kw=dict(rw_sigma=1e-7),
                              sync_kw=dict(n_fitpts=20, n_exchanges=5))
    design = ExperimentDesign(n_launch_epochs=3, nrep=30, seed=2)
    cases = [TestCase("allreduce", 512), TestCase("bcast", 4096)]
    assert backend.measure_epochs({0: cases}, design) is None
    res = Campaign(CampaignSpec(cases, design), backend).run()
    assert len(res.records) == 6
    for r in res.records:
        assert r.meta["engine"] == "torch" and r.meta["device"] == "cpu"
        assert r.meta["fused"] is False
        assert r.times.size and np.isfinite(r.times).all() and (r.times > 0).all()
    epoch = backend.make_epoch(0)
    assert epoch.net.clocks[0].rw_sigma == 1e-7


def test_sample_durations_draws_in_the_engine_order():
    """``sample_durations_torch``: the window seed, then each term's bias,
    from ``net.rng``; each term through ``_sample`` with its AR(1) carry;
    the imbalance from the (seed, number of terms) generator."""
    net_a, _ = _synced(4, p=6)
    net_b = copy.deepcopy(net_a)
    op_a = make_composite_op("allreduce + bcast*0.5")
    op_b = copy.deepcopy(op_a)
    dur, fac = sample_durations_torch(net_a, op_a, 4096, 700, device=CPU)
    assert dur.shape == (700,) and fac.shape == (700, 6)
    n = simengine._bucket(700)
    seed = int(net_b.rng.integers(2**31))
    terms = simengine._terms(op_b, 6, 4096)
    want = sum(simengine._sample([seed], j, [sub], [net_b], tp, tm, n, 700, CPU)[0]
               for j, (sub, tp, tm) in enumerate(terms))
    fac_want = simengine._imbalance(simengine._generator(CPU, seed, len(terms)),
                                    n, 6, op_b.rank_imbalance, CPU)
    assert torch.equal(dur, want[:700]) and torch.equal(fac, fac_want[:700])
    assert net_a.rng.bit_generator.state == net_b.rng.bit_generator.state
    assert [t._ar_state for t, _, _ in op_a.terms] == \
        [t._ar_state for t, _, _ in op_b.terms]
    assert (fac >= 0.25).all() and fac.std() > 0
    empty_d, empty_f = sample_durations_torch(net_a, op_a, 4096, 0, device=CPU)
    assert empty_d.shape == (0,) and empty_f.shape == (0, 6)


# ---------------------------------------------------------------------------
# Fused engine against the per-epoch port
# ---------------------------------------------------------------------------

def test_fused_lanes_draw_per_epoch_durations_bitwise():
    """One batched draw for E epochs equals E single-epoch draws lane by
    lane (durations and AR(1) carry-out), and the full engines leave the
    same AR(1) state and the same simulator state."""
    E, nrep = 3, 2000
    n = simengine._bucket(nrep)
    nets, _, ops = _epochs(E)
    seeds = [11, 22, 33]
    batched = simengine._sample(seeds, 0, ops, nets, 8, 4096, n, nrep, CPU)
    carries = [op._ar_state for op in ops]
    nets1, _, ops1 = _epochs(E)
    for e in range(E):
        single = simengine._sample([seeds[e]], 0, [ops1[e]], [nets1[e]], 8,
                                   4096, n, nrep, CPU)
        assert torch.equal(batched[e], single[0])
        assert ops1[e]._ar_state == carries[e]

    nets_u, syncs_u, ops_u = _epochs(E)
    nets_f, syncs_f, ops_f = _epochs(E)
    unfused = [run_windowed_torch(nets_u[e], syncs_u[e], ops_u[e], 4096, nrep,
                                  400e-6, device=CPU) for e in range(E)]
    fused = run_windowed_epochs_torch(nets_f, syncs_f, ops_f, 4096, nrep,
                                      400e-6, device=CPU)
    for e in range(E):
        assert ops_u[e]._ar_state == ops_f[e]._ar_state
        np.testing.assert_array_equal(fused[e].times, unfused[e].times)
        np.testing.assert_array_equal(fused[e].errors, unfused[e].errors)
        np.testing.assert_array_equal(nets_f[e].t, nets_u[e].t)


def test_fused_exact_when_noise_free():
    """No noise, no imbalance: the fused engine equals the per-epoch one,
    with the same flags."""
    E, nrep = 2, 300
    nets_u, syncs_u, ops_u = _epochs(E, seed0=11, **NOISE_FREE)
    nets_f, syncs_f, ops_f = _epochs(E, seed0=11, **NOISE_FREE)
    unfused = [run_windowed_torch(nets_u[e], syncs_u[e], ops_u[e], 4096, nrep,
                                  400e-6, device=CPU) for e in range(E)]
    fused = run_windowed_epochs_torch(nets_f, syncs_f, ops_f, 4096, nrep,
                                      400e-6, device=CPU)
    for e in range(E):
        np.testing.assert_array_equal(fused[e].times, unfused[e].times)
        assert np.array_equal(fused[e].errors, unfused[e].errors)
        np.testing.assert_array_equal(nets_f[e].t, nets_u[e].t)


def test_fused_chunking_does_not_change_results():
    """How epochs are grouped into fused calls only splits the work: three
    epochs in one call equal each epoch in a call of its own, bit for bit
    (live noise, a composite op of two terms)."""
    op = "reduce+bcast"
    nets_a, syncs_a, ops_a = _epochs(3, seed0=5)
    nets_b, syncs_b, ops_b = _epochs(3, seed0=5)
    ops_a = [make_composite_op(op) for _ in range(3)]
    ops_b = [make_composite_op(op) for _ in range(3)]
    together = run_windowed_epochs_torch(nets_a, syncs_a, ops_a, 4096, 500,
                                         400e-6, device=CPU)
    alone = [run_windowed_epochs_torch([nets_b[e]], [syncs_b[e]], [ops_b[e]],
                                       4096, 500, 400e-6, device=CPU)[0]
             for e in range(3)]
    for a, b, na, nb in zip(together, alone, nets_a, nets_b):
        np.testing.assert_array_equal(a.times, b.times)
        np.testing.assert_array_equal(a.errors, b.errors)
        np.testing.assert_array_equal(na.t, nb.t)


def test_fused_campaign_equals_per_epoch_campaign_bitwise():
    """A campaign measured fused and the same campaign measured epoch by
    epoch (what a fleet attempt under a fault plan runs) store the same
    times, bit for bit, top-ups included (50 us windows discard most
    calls at p = 16)."""
    spec = CampaignSpec([TestCase("allreduce", 4096), TestCase("bcast", 512),
                         TestCase("reduce+bcast", 1024)],
                        ExperimentDesign(n_launch_epochs=4, nrep=300, seed=2))
    kw = dict(p=16, seed0=3, device=CPU, win_size=50e-6,
              sync_kw=dict(n_fitpts=40, n_exchanges=10))
    fused = Campaign(spec, TorchSimBackend(**kw)).run()
    per_epoch = Campaign(spec, TorchSimBackend(fuse_epochs=False, **kw)).run()
    assert all(r.meta["fused"] for r in fused.records)
    assert not any(r.meta["fused"] for r in per_epoch.records)
    assert len(fused.records) == len(per_epoch.records) == 12
    for a, b in zip(fused.records, per_epoch.records):
        assert (a.case, a.epoch) == (b.case, b.epoch)
        np.testing.assert_array_equal(a.times, b.times)


def test_chunk_and_bucket_rules():
    assert simengine._bucket(1) == 32 and simengine._bucket(33) == 64
    assert simengine._bucket(1023) == 1024 and simengine._bucket(1025) == 1025


# ---------------------------------------------------------------------------
# No fallback hides the device
# ---------------------------------------------------------------------------

def test_random_walk_clocks_raise():
    """The fused engine's window rests on affine clocks: it refuses a
    walking clock (and measures nothing), while the clock itself, the
    per-epoch engine and the backend accept it."""
    net, sync = _synced(3, p=4)
    net.clocks[0].rw_sigma = 1e-7
    state = net.t.copy()
    with pytest.raises(SimTorchUnavailable):
        run_windowed_epochs_torch([net], [sync], [make_op("bcast")], 256, 10,
                                  400e-6, device=CPU)
    assert np.array_equal(net.t, state)
    clk = SimClock(rw_sigma=1e-7)
    assert clk.rw_sigma == 1e-7 and clk.read(1.0) != 1.0


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchSimBackend()
    net, sync = _synced(3, p=4)
    state = copy.deepcopy(net.t)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_windowed_torch(net, sync, make_op("bcast"), 256, 10, 400e-6)
    assert np.array_equal(net.t, state)
