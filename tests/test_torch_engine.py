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

The fused engine is held against the per-epoch port as the reference
holds its own (``tests/test_simjax_fused.py``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SimNet as RefNet
from repro.core import make_op as ref_make_op
from repro.core import make_sync as ref_make_sync
from repro.core import run_windowed, wilcoxon_rank_sum
from repro.simjax.engine import _cores
from repro_torch import simengine
from repro_torch.campaign import TorchSimBackend
from repro_torch.convert import (net_from_reference, op_from_reference,
                                 sync_from_reference)
from repro_torch.core import SimNet, make_composite_op, make_op, make_sync
from repro_torch.core.clocks import SimClock
from repro_torch.simengine import (SimTorchUnavailable,
                                   run_windowed_epochs_torch,
                                   run_windowed_torch)

NOISE_FREE = dict(noise_sigma=0.0, tail_prob=0.0, spike_prob=0.0,
                  rank_imbalance=0.0, epoch_bias_sigma=0.0, autocorr=0.0)
CPU = "cpu"


def _ref_synced(seed, p, n_fitpts=100, n_exchanges=20):
    net = RefNet(p, seed=seed)
    sync = ref_make_sync("hca", n_fitpts=n_fitpts,
                         n_exchanges=n_exchanges).synchronize(net)
    return net, sync


def _synced(seed, p):
    net = SimNet(p, seed=seed)
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
        res = wilcoxon_rank_sum(unfused[e].valid_times, fused[e].valid_times)
        assert res.p_value > 0.01, (e, res.p_value)
        np.testing.assert_allclose(nets_u[e].t, nets_f[e].t, rtol=1e-5)


def test_fused_exact_when_noise_free():
    """No noise, no imbalance: the float32 relative-frame window equals the
    float64 per-epoch window to float32 resolution, with the same flags."""
    E, nrep = 2, 300
    nets_u, syncs_u, ops_u = _epochs(E, seed0=11, **NOISE_FREE)
    nets_f, syncs_f, ops_f = _epochs(E, seed0=11, **NOISE_FREE)
    unfused = [run_windowed_torch(nets_u[e], syncs_u[e], ops_u[e], 4096, nrep,
                                  400e-6, device=CPU) for e in range(E)]
    fused = run_windowed_epochs_torch(nets_f, syncs_f, ops_f, 4096, nrep,
                                      400e-6, device=CPU)
    for e in range(E):
        np.testing.assert_allclose(fused[e].times, unfused[e].times, rtol=1e-5)
        assert np.array_equal(fused[e].errors, unfused[e].errors)
        np.testing.assert_allclose(nets_f[e].t, nets_u[e].t, rtol=1e-5)


def test_fused_chunking_does_not_change_results(monkeypatch):
    """The chunk length only splits the work: with the imbalance draw off,
    chunks of 64 give the single-chunk results to float32 resolution."""
    nets_a, syncs_a, ops_a = _epochs(1, seed0=5, rank_imbalance=0.0)
    nets_b, syncs_b, ops_b = _epochs(1, seed0=5, rank_imbalance=0.0)
    a = run_windowed_epochs_torch(nets_a, syncs_a, ops_a, 4096, 500, 400e-6,
                                  device=CPU)[0]
    monkeypatch.setattr(simengine, "_chunk_for", lambda p, n: 64)
    b = run_windowed_epochs_torch(nets_b, syncs_b, ops_b, 4096, 500, 400e-6,
                                  device=CPU)[0]
    np.testing.assert_allclose(b.times, a.times, rtol=1e-5)
    assert np.array_equal(a.errors, b.errors)
    np.testing.assert_allclose(nets_b[0].t, nets_a[0].t, rtol=1e-6)


def test_chunk_and_bucket_rules():
    assert simengine._bucket(1) == 32 and simengine._bucket(33) == 64
    assert simengine._bucket(1023) == 1024 and simengine._bucket(1025) == 1025
    assert simengine._chunk_for(512, 10**5) == 32768
    assert simengine._chunk_for(16, 300) == 300


# ---------------------------------------------------------------------------
# No fallback hides the device
# ---------------------------------------------------------------------------

def test_random_walk_clocks_raise():
    net, sync = _synced(3, p=4)
    net.clocks[0].rw_sigma = 1e-7
    with pytest.raises(SimTorchUnavailable):
        run_windowed_torch(net, sync, make_op("bcast"), 256, 10, 400e-6,
                           device=CPU)
    with pytest.raises(SimTorchUnavailable):
        run_windowed_epochs_torch([net], [sync], [make_op("bcast")], 256, 10,
                                  400e-6, device=CPU)
    backend = TorchSimBackend(p=4, device=CPU, clock_kw=dict(rw_sigma=1e-7))
    with pytest.raises(SimTorchUnavailable):
        backend.make_epoch(0)
    with pytest.raises(ValueError, match="random-walk"):
        SimClock(rw_sigma=1e-7)


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchSimBackend()
    net, sync = _synced(3, p=4)
    state = copy.deepcopy(net.t)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_windowed_torch(net, sync, make_op("bcast"), 256, 10, 400e-6)
    assert np.array_equal(net.t, state)
