"""HCA's tree run one round at a time on a torch device
(``repro_torch.core.sync.hca_device``) held against the host path.

On the CPU the device path runs on CPU tensors (the ``hca_timeline``
kernel's plain version): from identical nets it must leave the generator
where the host path leaves it, the same message count and initial times,
true times within 1e-12 and models within 1e-9, at p 2, 8, 12 (a
non-power-of-two last round), 100 and 512 (200 x 40, the benchmark's
size), on a subset of ranks and on walking clocks. An epoch on the CPU
never takes the device path.

Marked ``cuda``: the kernel against its plain version on the card, and a
``device="cuda"`` epoch at p 512, whose sync must count 511 pairs on the
device and agree with the host path within 1e-9. They skip, with the
reason, where there is no GPU. This file imports neither JAX nor the JAX
package; on the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_hca_device.py
"""

import numpy as np
import pytest
import torch

from repro_torch.campaign import TorchSimBackend
from repro_torch.core import SimNet, make_sync, telemetry
from repro_torch.core.simnet import ClockParams
from repro_torch.core.stats import tukey_filter
from repro_torch.core.sync.base import compute_rtt
from repro_torch.core.sync.base import RTT_PINGPONGS as COUNTED
from repro_torch.core.sync.base import RTT_WARMUP as WARMUP
from repro_torch.core.sync.hca_device import _tukey_mean
from repro_torch.kernels.hca_timeline import (hca_timeline, hca_timeline_ref, row_edges,
                                              row_length)


def _rel(a, b) -> float:
    """Largest gap relative to the value or the median magnitude."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    scale = np.maximum(np.abs(b), np.median(np.abs(b)))
    return float(np.max(np.abs(a - b) / np.where(scale > 0, scale, 1.0)))


def _t_gap(a, b) -> float:
    """Largest gap of true times relative to the latest of them."""
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _both(p, seed, n_fitpts, n_exchanges, ranks=None, clock_kw=None):
    """The host path and the device path (on CPU tensors) on two identical
    nets: ``(host_net, host_sync, dev_net, dev_sync)``."""
    nets = [SimNet(p, seed=seed, clocks=ClockParams(**clock_kw) if clock_kw else None)
            for _ in range(2)]
    sync = make_sync("hca", n_fitpts=n_fitpts, n_exchanges=n_exchanges)
    host = sync.synchronize(nets[0], ranks)
    dev = sync._synchronize(nets[1], ranks, "cpu")
    return nets[0], host, nets[1], dev


def _assert_agree(host_net, host, dev_net, dev):
    assert dev.initial_times == host.initial_times
    assert _rel([m.slope for m in dev.models], [m.slope for m in host.models]) <= 1e-9
    assert _rel([m.intercept for m in dev.models],
                [m.intercept for m in host.models]) <= 1e-9
    assert _t_gap(dev_net.t, host_net.t) <= 1e-12
    assert dev_net.msg_count == host_net.msg_count
    assert dev.n_messages == host.n_messages
    assert dev_net.rng.random() == host_net.rng.random()


@pytest.mark.parametrize("p,n_fitpts,n_exchanges", [
    (2, 10, 5), (8, 20, 5), (12, 30, 10), (100, 20, 5), (512, 200, 40)])
def test_device_tree_matches_host_path(p, n_fitpts, n_exchanges):
    _assert_agree(*_both(p, 1000 + p, n_fitpts, n_exchanges))


@pytest.mark.parametrize("ranks", [[3, 0, 5, 7, 9], [11, 2, 4, 6, 8, 10, 1, 0]])
def test_device_tree_on_a_subset_of_ranks(ranks):
    host_net, host, dev_net, dev = _both(12, 7, 20, 5, ranks=ranks)
    _assert_agree(host_net, host, dev_net, dev)
    others = [r for r in range(12) if r not in ranks]
    assert np.array_equal(dev_net.t[others], host_net.t[others])


def test_device_tree_on_walking_clocks():
    _assert_agree(*_both(12, 3, 30, 10, clock_kw=dict(rw_sigma=1e-7)))


def test_device_tree_counts_its_pairs_and_uploads():
    with telemetry.recording():
        _both(12, 5, 20, 5)
    counters = telemetry.snapshot()["counters"]
    assert counters["sync.hca.pairs_on_device"] == 11
    row = row_length(WARMUP, COUNTED, 20, 5)
    assert counters["sync.hca.h2d_bytes"] == 2 * 11 * row * 8


def test_lognormal_consumes_the_standard_normal_stream():
    """The device path draws ``lognormal(0, s, n)`` as ``standard_normal(n)``
    and applies ``exp(s * z)`` on the device: numpy's generator must leave
    both in one state."""
    a, b = np.random.default_rng(17), np.random.default_rng(17)
    for n in (1, 10, 100, 8000, 100_000):
        x = a.lognormal(0.0, 0.25, n)
        z = b.standard_normal(n)
        assert np.allclose(np.exp(0.25 * z), x, rtol=1e-15, atol=0)
    a.lognormal(0.0, 0.25)
    b.standard_normal()
    assert a.bit_generator.state == b.bit_generator.state
    assert a.random() == b.random()


def test_cpu_epoch_keeps_the_host_path():
    backend = TorchSimBackend(p=8, seed0=2, device="cpu",
                              sync_kw=dict(n_fitpts=20, n_exchanges=5))
    with telemetry.recording():
        ctx = backend.make_epoch(0)
    assert "sync.hca.pairs_on_device" not in telemetry.snapshot()["counters"]
    net = SimNet(8, seed=2)
    ref = make_sync("hca", n_fitpts=20, n_exchanges=5).synchronize(net)
    assert [(m.slope, m.intercept) for m in ctx.sync.models] \
        == [(m.slope, m.intercept) for m in ref.models]
    assert np.array_equal(ctx.net.t, net.t)


def test_hca2_and_cpu_devices_keep_the_host_path():
    for name, device in (("hca2", "cpu"), ("hca", "cpu"), ("hca", None)):
        with telemetry.recording():
            make_sync(name, n_fitpts=20, n_exchanges=5).synchronize(SimNet(8, seed=1),
                                                                    device=device)
        assert "sync.hca.pairs_on_device" not in telemetry.snapshot()["counters"]


def test_a_row_holds_a_pairs_draws_in_the_host_paths_order():
    """Warm-up and counted ping-pongs (``compute_rtt``'s defaults) each way,
    the sweep each way, the transfer: one latency a message."""
    defaults = compute_rtt.__defaults__
    assert defaults == (COUNTED, WARMUP)
    assert row_edges(WARMUP, COUNTED, 200, 40) == [
        0, 10, 20, 120, 220, 8220, 16220, 16221]
    assert row_length(WARMUP, COUNTED, 200, 40) == 16221


@pytest.mark.parametrize("n", [4, 5, 100])
def test_tukey_mean_is_the_host_paths(n):
    """Per row, the mean of what ``tukey_filter`` keeps, spikes included."""
    rng = np.random.default_rng(n)
    x = 1e-5 * rng.lognormal(0.0, 0.25, (64, n))
    x[rng.random(x.shape) < 0.05] *= 40.0
    got = _tukey_mean(torch.from_numpy(x)).numpy()
    want = [np.mean(tukey_filter(row)) for row in x]
    assert _rel(got, want) <= 1e-15


def test_timeline_refuses_what_it_does_not_take():
    lat = torch.ones(3, row_length(WARMUP, COUNTED, 4, 2), dtype=torch.float64)
    t = torch.zeros(3, dtype=torch.float64)
    kw = dict(warmup=WARMUP, counted=COUNTED, nseg=4, nx=2, oh=3e-7)
    with pytest.raises(ValueError, match="must be"):
        hca_timeline(lat[:, :-1], t, t, **kw)
    with pytest.raises(TypeError, match="float64"):
        hca_timeline(lat.float(), t, t, **kw)
    with pytest.raises(ValueError, match="t_cli"):
        hca_timeline(lat, t, t[:2], **kw)
    with pytest.raises(ValueError, match="at least"):
        hca_timeline(lat, t, t, **dict(kw, nx=0))
    assert all(torch.equal(a, b) for a, b in zip(hca_timeline(lat, t, t, **kw),
                                                 hca_timeline_ref(lat, t, t, **kw)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hca_timeline CUDA kernel only runs "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_timeline_kernel_matches_plain_version(card):
    """Same latencies, same sums in the same order: equal to the bit."""
    g = torch.Generator().manual_seed(3)
    for K, nseg, nx in ((256, 200, 40), (5, 7, 1), (1, 0, 3)):
        lat = 8e-6 * torch.exp(0.25 * torch.randn(K, row_length(WARMUP, COUNTED, nseg, nx),
                                                  generator=g, dtype=torch.float64))
        t_ref = torch.rand(K, generator=g, dtype=torch.float64)
        t_cli = torch.rand(K, generator=g, dtype=torch.float64)
        kw = dict(warmup=WARMUP, counted=COUNTED, nseg=nseg, nx=nx, oh=3e-7)
        launches = hca_timeline.launches
        got = hca_timeline(lat.to(card), t_ref.to(card), t_cli.to(card), **kw)
        torch.cuda.synchronize()
        assert hca_timeline.launches == launches + 1
        want = hca_timeline_ref(lat, t_ref, t_cli, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b), (K, nseg, nx)


@pytest.mark.cuda
def test_cuda_epoch_runs_the_tree_on_the_card(card):
    seed0 = 2**31 + 12345
    with telemetry.recording():
        ctx = TorchSimBackend(p=512, seed0=seed0, device="cuda").make_epoch(0)
    assert telemetry.snapshot()["counters"]["sync.hca.pairs_on_device"] == 511
    net = SimNet(512, seed=seed0)
    host = make_sync("hca", n_fitpts=200, n_exchanges=40).synchronize(net)
    assert ctx.sync.initial_times == host.initial_times
    assert _rel([m.slope for m in ctx.sync.models], [m.slope for m in host.models]) <= 1e-9
    assert _rel([m.intercept for m in ctx.sync.models],
                [m.intercept for m in host.models]) <= 1e-9
    assert _t_gap(ctx.net.t, net.t) <= 1e-12
    assert ctx.net.msg_count == net.msg_count
    assert ctx.net.rng.random() == net.rng.random()
