"""The port's clocks (``repro_torch.core.clocks``) and the simulator's
clock-facing methods held against the JAX package's, on the CPU.

Both packages draw the walk from numpy streams derived from the clock's
seed, so one seed and one sequence of calls give the same bits: drift-path
nodes, lazy reads, the deadline inversion and the sync probes.
"""

import numpy as np
import pytest

from repro.core import ClockParams as RefClockParams
from repro.core import SimNet as RefNet
from repro.core import make_sync as ref_make_sync
from repro.core.clocks import DriftPath as RefDriftPath
from repro.core.clocks import SimClock as RefClock
from repro.core.clocks import derive_stream as ref_derive_stream
from repro.core.sync import probe_offsets as ref_probe_offsets
from repro.core.sync import true_offsets as ref_true_offsets
from repro_torch.convert import net_from_reference, sync_from_reference
from repro_torch.core import (IDENTITY_MODEL, AdjustedClock, LinearModel,
                              PerfClock, SimNet, probe_offsets, true_offsets)
from repro_torch.core.clocks import DriftPath, SimClock, derive_stream

CLOCK = dict(offset=0.01, skew=3e-6, rw_sigma=1e-7, scale_error=2e-6, seed=5)


def _ensure_sequence(rng):
    """Targets of ``DriftPath.ensure`` calls: growing, repeated and
    shrinking (a no-op), with steps below and above one 256-node chunk."""
    t = np.cumsum(rng.uniform(0.0, 0.4, 12))
    return np.concatenate([t[:3], t[1:2], t[3:], [t[-1] + 5.0]])


@pytest.mark.parametrize("sigma", [1e-7, 1e-3, 0.0])
def test_drift_path_nodes_bitwise(sigma):
    """One seed and one sequence of ``ensure`` calls: the same nodes, bit
    for bit (the ±0.45·dt clip fires at sigma 1e-3), and the same values
    interpolated between them."""
    dt = 400e-6 if sigma < 1e-4 else 1e-4
    a = RefDriftPath.start(sigma, dt, 0.2, 1e-8, ref_derive_stream(9, "drift-path"))
    b = DriftPath.start(sigma, dt, 0.2, 1e-8, derive_stream(9, "drift-path"))
    for t_max in 0.2 + _ensure_sequence(np.random.default_rng(4)):
        a.ensure(t_max)
        b.ensure(t_max)
        assert a.version == b.version
        assert np.array_equal(a.t, b.t) and np.array_equal(a.x, b.x)
    q = np.random.default_rng(5).uniform(0.2, a.t[-1] + 1.0, 500)
    assert np.array_equal(a.value(q), b.value(q))
    assert np.array_equal(a.t, b.t) and np.array_equal(a.x, b.x)
    if sigma == 1e-3:
        assert np.abs(np.diff(b.x)).max() == pytest.approx(0.45 * dt)


def test_lazy_reads_bitwise():
    """Lazy walk: the same sequence of reads (forward, repeated and
    backward in time) gives the same readings and walk state."""
    a, b = RefClock(**CLOCK), SimClock(**CLOCK)
    times = np.concatenate([np.cumsum(np.random.default_rng(1).exponential(0.05, 200)),
                            [0.1, 3.0, 3.0]])
    for t in times:
        assert a.read(float(t)) == b.read(float(t))
        assert a.true_at_local(a.read(float(t))) == b.true_at_local(b.read(float(t)))
    assert (a._rw_t, a._rw_x) == (b._rw_t, b._rw_x)
    assert np.array_equal(a.read_affine(times), b.read_affine(times))
    other_a, other_b = RefClock(seed=8, skew=-1e-6), SimClock(seed=8, skew=-1e-6)
    assert a.true_offset_to(other_a, 12.0) == b.true_offset_to(other_b, 12.0)


def test_path_mode_reads_and_inversion_bitwise():
    """After ``drift_path``: array reads and the deadline inversion (binary
    search plus the in-segment solve, with its ``while`` growth) match."""
    a, b = RefClock(**CLOCK), SimClock(**CLOCK)
    for clk in (a, b):
        clk.read(0.3)                  # a lazy sample before the path anchors
        clk.drift_path(400e-6)
    t = np.linspace(0.3, 2.0, 3000)
    assert np.array_equal(a.read(t), b.read(t))
    ends = [(clk.read(0.3), clk.read(2.5)) for clk in (a, b)]
    assert ends[0] == ends[1]
    local = np.linspace(*ends[0], 2000)
    assert np.array_equal(a.true_at_local(local), b.true_at_local(local))
    assert np.array_equal(a._path.x, b._path.x)


def test_true_at_local_roundtrip():
    """``true_at_local(read(t)) == t`` on an active drift path."""
    clk = SimClock(offset=0.01, skew=3e-6, rw_sigma=1e-7, seed=5)
    clk.drift_path(400e-6)
    t = np.linspace(0.0, 2.0, 5000)
    local = clk.read(t)
    assert np.all(np.diff(local) > 0)   # monotone, hence invertible
    np.testing.assert_allclose(clk.true_at_local(local), t, rtol=0, atol=1e-9)


def test_adjusted_and_perf_clocks():
    base = SimClock(offset=0.5, skew=1e-5)
    adj = AdjustedClock(base, initial_time=base.read(1.0))
    assert adj.read(1.0) == 0.0 and adj.read(2.0) > 0.0
    assert PerfClock().read() > 0.0
    assert IDENTITY_MODEL == LinearModel(0.0, 0.0)
    assert IDENTITY_MODEL.normalize(3.25) == 3.25


def _walking_pair(seed, p=8):
    ref = RefNet(p, seed=seed, clocks=RefClockParams(rw_sigma=1e-7))
    return ref, net_from_reference(ref)


def test_simnet_scalar_ops_bitwise():
    """pingpong, transfer, advance, waits and barriers advance both
    simulators identically and read the same (walking) clocks."""
    a, b = _walking_pair(3)
    for net in (a, b):
        net.advance(1, 2e-5)
        net.advance(2, -1.0)          # negative compute is clamped to 0
    for _ in range(20):
        pa, pb = a.pingpong(0, 3), b.pingpong(0, 3)
        assert (pa.t_send_client, pa.t_server, pa.t_recv_client) == \
            (pb.t_send_client, pb.t_server, pb.t_recv_client)
    deadline = a.local_time(4) + 1e-4
    assert a.wait_until_local(4, deadline) == b.wait_until_local(4, deadline)
    assert a.wait_until_local(4, deadline - 1.0) is b.wait_until_local(4, deadline - 1.0) is False
    assert np.array_equal(a.dissemination_barrier(), b.dissemination_barrier())
    assert np.array_equal(a._dissemination_barrier_scalar(),
                          b._dissemination_barrier_scalar())
    assert np.array_equal(a.library_barrier(40e-6), b.library_barrier(40e-6))
    assert np.array_equal(a.library_barrier(0.0, ranks=[1, 2, 5]),
                          b.library_barrier(0.0, ranks=[1, 2, 5]))
    a.sleep_all(5e-6)
    b.sleep_all(5e-6)
    assert np.array_equal(a.t, b.t) and a.msg_count == b.msg_count
    assert a.true_time(2) == b.true_time(2)
    assert a.true_offset(5, 1) == b.true_offset(5, 1)
    assert a.true_time_at_local(6, 0.2) == b.true_time_at_local(6, 0.2)
    assert all(np.array_equal(pa.x, pb.x) for pa, pb in
               zip(a.freeze_drift_paths(1e-3), b.freeze_drift_paths(1e-3)))


@pytest.mark.parametrize("algorithm", ["skampi", "netgauge", "jk", "hca", "hca2"])
@pytest.mark.parametrize("rw_sigma", [0.0, 1e-7])
def test_sync_probes_bitwise(algorithm, rw_sigma):
    """``true_offsets`` and ``probe_offsets`` after each sync algorithm
    equal the reference's exactly, on affine and on walking clocks."""
    ref = RefNet(16, seed=11, clocks=RefClockParams(rw_sigma=rw_sigma))
    ref_sync = ref_make_sync(algorithm).synchronize(ref)
    net, sync = net_from_reference(ref), sync_from_reference(ref_sync)
    assert np.array_equal(ref_true_offsets(ref, ref_sync), true_offsets(net, sync))
    assert np.array_equal(ref_probe_offsets(ref, ref_sync, n_rounds=5),
                          probe_offsets(net, sync, n_rounds=5))
    assert np.array_equal(ref.t, net.t)
    assert ref_sync.local_deadline(3, 0.5) == sync.local_deadline(3, 0.5)
    assert ref_sync.adjusted_local(3, 0.5) == sync.adjusted_local(3, 0.5)


def test_port_sync_on_walking_clocks_matches_reference():
    """The port's own sync over walking clocks (lazy reads inside HCA,
    affine reads in the ping-pong batches) draws the reference's models."""
    ref = RefNet(8, seed=2, clocks=RefClockParams(rw_sigma=1e-7))
    ref_sync = ref_make_sync("hca", n_fitpts=40, n_exchanges=10).synchronize(ref)
    from repro_torch.core import ClockParams, make_sync

    net = SimNet(8, seed=2, clocks=ClockParams(rw_sigma=1e-7))
    sync = make_sync("hca", n_fitpts=40, n_exchanges=10).synchronize(net)
    assert [(m.slope, m.intercept) for m in sync.models] == \
        [(m.slope, m.intercept) for m in ref_sync.models]
    assert sync.initial_times == ref_sync.initial_times
    assert all((c._rw_t, c._rw_x) == (rc._rw_t, rc._rw_x)
               for c, rc in zip(net.clocks, ref.clocks))
