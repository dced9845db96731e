"""The port's numpy engines (``engine="scalar" | "batch" | "batch_rw" |
"auto"``) held against the JAX package's, on the CPU, bit for bit
(``np.array_equal``) from the same seeds: the AR(1) filter, the scalar and
batched duration samplers with the AR(1) state and the generator's state
after them, ``execute`` / ``execute_batch`` with ``net.t``, every engine of
``run_windowed`` on affine and random-walk clocks, ``resolve_engine``,
``collect_fitpoint``, and ``TorchSimBackend`` campaigns, the archived
reference run among them, all 72 of its records.

Then the reference's own engine checks (``tests/test_batch_equivalence.py``)
on the port's engines, the port's ``"torch"`` engine against its own
``batch`` engine, and the link to the card: ``scan_host_draws``, which
runs the batch engines' scan through ``sim_scan`` on the card, here on CPU
tensors (the kernel's plain version) against the reference's numpy
sampler, within 1e-12.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from repro.campaign import Campaign as RefCampaign
from repro.campaign import CampaignSpec as RefSpec
from repro.campaign import ResultStore as RefStore
from repro.campaign import SimBackend
from repro.core import ClockParams as RefClockParams
from repro.core import ExperimentDesign as RefDesign
from repro.core import SimNet as RefNet
from repro.core import TestCase as RefCase
from repro.core import make_composite_op as ref_make_composite_op
from repro.core import make_sync as ref_make_sync
from repro.core.mpi_ops import _ar1_filter as ref_ar1_filter
from repro.core.sync.jk import collect_fitpoint as ref_collect_fitpoint
from repro.core.window import resolve_engine as ref_resolve_engine
from repro.core.window import run_windowed as ref_run_windowed
from repro_torch.campaign import Campaign, CampaignSpec, TorchSimBackend
from repro_torch.core import (OP_LIBRARY, BatchExecution, ClockParams,
                              CollectiveExecution, ExperimentDesign, SimNet,
                              TestCase, make_composite_op, make_op, make_sync,
                              resolve_engine, run_windowed, run_windowed_rw_batch,
                              run_windowed_scalar, wilcoxon_rank_sum)
from repro_torch.core.mpi_ops import _ar1_filter
from repro_torch.core.sync import collect_fitpoint
from repro_torch.simengine import scan_host_draws

ARCHIVE = Path(__file__).resolve().parents[1] / "benchmarks" \
    / "reference_archive" / "run-000.jsonl"
AUDIT_CASES = [TestCase(op, m) for op in ("allreduce", "bcast", "alltoall")
               for m in (512, 4096)]
NOISE_FREE = dict(noise_sigma=0.0, tail_prob=0.0, spike_prob=0.0,
                  rank_imbalance=0.0, epoch_bias_sigma=0.0, autocorr=0.0)
SYNC_KW = dict(n_fitpts=100, n_exchanges=20)
FIELDS = ("times", "errors", "start_global_est", "end_global_est",
          "start_true", "end_true")
OPS = list(OP_LIBRARY) + ["allreduce@half+allreduce@half", "bcast*2+scan"]
RW = dict(rw_sigma=1e-7)


def _pair(seed, p=8, clock_kw=None, sync=True, sync_kw=None):
    """The same seeded cluster in both packages, synchronized by hca."""
    sync_kw = dict(n_fitpts=30, n_exchanges=10) if sync_kw is None else sync_kw
    ref = RefNet(p, seed=seed, clocks=RefClockParams(**clock_kw) if clock_kw else None)
    net = SimNet(p, seed=seed, clocks=ClockParams(**clock_kw) if clock_kw else None)
    if not sync:
        return ref, net
    return (ref, ref_make_sync("hca", **sync_kw).synchronize(ref),
            net, make_sync("hca", **sync_kw).synchronize(net))


def _terms(op):
    return [t for t, _, _ in op.terms] if getattr(op, "terms", None) else [op]


def _same_rng(ref, net):
    return ref.rng.bit_generator.state == net.rng.bit_generator.state


def _same_run(a, b):
    return all(np.array_equal(getattr(a, k), getattr(b, k)) for k in FIELDS)


# ---------------------------------------------------------------------------
# the pieces, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coeff", [0.0, 0.35, -0.35, 0.999, -0.999, 1.0])
def test_ar1_filter_equals_reference(coeff):
    """Every branch: the copy (0), the chunked closed form (|a| < 1, a
    chunk of ~1400 elements at 0.35 and ~500 000 at 0.999) and the plain
    loop (|a| >= 1)."""
    eps = np.random.default_rng(3).normal(0.0, 0.04, size=5000)
    for state in (0.0, 0.7):
        assert np.array_equal(_ar1_filter(eps, coeff, state),
                              ref_ar1_filter(eps, coeff, state))
    assert _ar1_filter(eps[:0], coeff, 0.7).size == 0


@pytest.mark.parametrize("nrep", [0, 1, 37, 1000])
@pytest.mark.parametrize("warm", [True, False])
@pytest.mark.parametrize("name", OPS)
def test_sample_durations_equal_reference(name, warm, nrep):
    """Scalar draws, then a batch, then scalar again: the durations, each
    term's AR(1) state and the generator's state equal the reference's."""
    ref_net, net = _pair(11, sync=False)
    ref_op, op = ref_make_composite_op(name), make_composite_op(name)
    for p in (8, 5):
        a = [ref_op.sample_duration(ref_net, p, 4096, warm) for _ in range(3)]
        b = [op.sample_duration(net, p, 4096, warm) for _ in range(3)]
        assert a == b
        a = ref_op.sample_durations(ref_net, p, 4096, nrep, warm)
        b = op.sample_durations(net, p, 4096, nrep, warm, device="cpu")
        assert np.array_equal(a, b) and b.shape == (nrep,)
        assert ref_op.sample_duration(ref_net, p, 512, warm) \
            == op.sample_duration(net, p, 512, warm)
        assert [t._ar_state for t in _terms(ref_op)] == [t._ar_state for t in _terms(op)]
        assert _same_rng(ref_net, net)
    # device=None is the numpy path too
    assert np.array_equal(ref_op.sample_durations(ref_net, 8, 64, nrep, warm),
                          op.sample_durations(net, 8, 64, nrep, warm))


@pytest.mark.parametrize("min_start", [False, True])
@pytest.mark.parametrize("name", ["allreduce", "alltoall", "bcast*2+scan"])
def test_execute_and_execute_batch_equal_reference(name, min_start):
    ref_net, net = _pair(4, sync=False)
    ref_op, op = ref_make_composite_op(name), make_composite_op(name)
    ranks = [0, 2, 3, 5]
    for _ in range(5):
        a, b = ref_op.execute(ref_net, 2048), op.execute(net, 2048)
        assert isinstance(b, CollectiveExecution)
        assert np.array_equal(a.start_true, b.start_true) \
            and np.array_equal(a.end_true, b.end_true)
    a, b = ref_op.execute(ref_net, 2048, ranks), op.execute(net, 2048, ranks)
    assert np.array_equal(a.end_true, b.end_true)
    for nrep, rk in ((300, None), (41, ranks), (0, ranks)):
        p = 8 if rk is None else len(rk)
        deadlines = None
        if min_start and nrep:
            deadlines = float(net.t.max()) + 30e-6 * np.arange(nrep)[:, None] \
                + np.random.default_rng(nrep).uniform(0, 5e-6, (nrep, p))
        a = ref_op.execute_batch(ref_net, 2048, nrep, rk, warm=nrep != 41,
                                 min_start_true=deadlines)
        b = op.execute_batch(net, 2048, nrep, rk, warm=nrep != 41,
                             min_start_true=deadlines, device="cpu")
        assert isinstance(b, BatchExecution)
        for k in ("start_true", "end_true", "durations"):
            assert np.array_equal(getattr(a, k), getattr(b, k)), k
        assert np.array_equal(ref_net.t, net.t)
    assert [t._ar_state for t in _terms(ref_op)] == [t._ar_state for t in _terms(op)]
    assert _same_rng(ref_net, net)


@pytest.mark.parametrize("engine", ["batch", "batch_rw", "scalar", "auto"])
@pytest.mark.parametrize("clocks", ["affine", "walking"])
@pytest.mark.parametrize("name", ["allreduce", "allreduce@half+allreduce@half"])
def test_run_windowed_equals_reference(engine, clocks, name):
    """Two consecutive windows (the AR(1) carry, the drift paths and
    ``net.t`` carried between them), then a subset of ranks: all six
    ``WindowRun`` fields, ``net.t`` and the next draw. ``batch`` on walking
    clocks raises in both packages."""
    ref, ref_sync, net, sync = _pair(7, clock_kw=RW if clocks == "walking" else None)
    ref_op, op = ref_make_composite_op(name), make_composite_op(name)
    if engine == "batch" and clocks == "walking":
        with pytest.raises(ValueError, match="affine"):
            ref_run_windowed(ref, ref_sync, ref_op, 4096, 50, 300e-6, engine=engine)
        with pytest.raises(ValueError, match="affine"):
            run_windowed(net, sync, op, 4096, 50, 300e-6, device="cpu", engine=engine)
        return
    invalid = []
    for nrep, win, ranks in ((120, 300e-6, None), (80, 12e-6, None), (50, 400e-6, [1, 4, 6])):
        a = ref_run_windowed(ref, ref_sync, ref_op, 4096, nrep, win, ranks, engine=engine)
        b = run_windowed(net, sync, op, 4096, nrep, win, ranks, device="cpu", engine=engine)
        assert _same_run(a, b), (nrep, win)
        assert np.array_equal(ref.t, net.t)
        invalid.append(b.invalid_fraction)
    assert invalid[1] > 0.0           # the flags were exercised
    assert ref.rng.random() == net.rng.random()


def test_run_windowed_helpers_equal_reference():
    """The public engine functions called directly, as the reference's are."""
    from repro.core.window import run_windowed_rw_batch as ref_rw
    from repro.core.window import run_windowed_scalar as ref_scalar

    ref, ref_sync, net, sync = _pair(9, clock_kw=RW)
    a = ref_rw(ref, ref_sync, ref_make_composite_op("bcast"), 512, 90, 300e-6)
    b = run_windowed_rw_batch(net, sync, make_op("bcast"), 512, 90, 300e-6, device="cpu")
    assert _same_run(a, b)
    a = ref_scalar(ref, ref_sync, ref_make_composite_op("bcast"), 512, 20, 300e-6)
    b = run_windowed_scalar(net, sync, make_op("bcast"), 512, 20, 300e-6)
    assert _same_run(a, b) and np.array_equal(ref.t, net.t)


@pytest.mark.parametrize("clocks", ["affine", "walking"])
def test_resolve_engine_follows_reference_table(clocks):
    """The reference's table for every engine both packages have (where it
    adds no fallback note, which is everywhere but its ``jax``);
    ``"torch"`` resolves to itself, ``"jax"`` and unknown names raise."""
    ref, net = _pair(3, clock_kw=RW if clocks == "walking" else None, sync=False)
    for engine in ("auto", "batch", "batch_rw", "scalar"):
        for ranks in (None, [0, 2]):
            assert (resolve_engine(engine, net, ranks), None) \
                == ref_resolve_engine(engine, ref, ranks)
    assert resolve_engine("torch", net) == "torch"
    with pytest.raises(ValueError, match="'torch'"):
        resolve_engine("jax", net)
    with pytest.raises(ValueError, match="unknown engine"):
        resolve_engine("nope", net)


def test_collect_fitpoint_equals_reference():
    ref, net = _pair(21, p=6, sync=False)
    for client, server, rtt, n, inits in ((1, 0, 2e-5, 30, (0.0, 0.0)),
                                         (5, 0, 3.1e-5, 1, (0.5, 0.25)),
                                         (3, 2, 1e-5, 40, (1.0, -2.0))):
        a = ref_collect_fitpoint(ref, client, server, rtt, n, *inits)
        b = collect_fitpoint(net, client, server, rtt, n, *inits)
        assert a == b and all(type(x) is float for x in b)
        assert np.array_equal(ref.t, net.t) and ref.msg_count == net.msg_count
    assert _same_rng(ref, net)


# ---------------------------------------------------------------------------
# campaigns: the archive and the reference's SimBackend
# ---------------------------------------------------------------------------

def _records(records):
    return {(r.case.op, r.case.msize, r.epoch): r.times for r in records}


@pytest.mark.parametrize("engine", ["batch", "auto"])
def test_backend_reproduces_the_archived_reference_run(engine):
    """``benchmarks/reference_archive/run-000.jsonl`` (written by the
    reference's ``SimBackend(engine="auto")``: p 8, hca 60 x 20, 12
    epochs, nrep 40) regenerated by the port, all 72 records bit for bit."""
    archive = _records(RefStore(ARCHIVE).records())
    backend = TorchSimBackend(p=8, seed0=0, sync_kw=dict(n_fitpts=60, n_exchanges=20),
                              engine=engine, device="cpu")
    res = Campaign(CampaignSpec(AUDIT_CASES, ExperimentDesign(n_launch_epochs=12, nrep=40,
                                                              seed=0), name="repro-audit"),
                   backend).run()
    ours = _records(res.records)
    assert len(archive) == len(ours) == 72 and set(archive) == set(ours)
    assert all(np.array_equal(ours[k], archive[k]) for k in archive)
    assert all(r.meta["engine"] == "batch" and r.meta["device"] == "cpu"
               and not r.meta["fused"] for r in res.records)
    assert dict(backend.factors(ExperimentDesign(n_launch_epochs=12, nrep=40,
                                                 seed=0)).extra)["engine"] == engine


@pytest.mark.parametrize("engine,kw", [
    ("auto", dict(clock_kw=RW)),                              # batch_rw
    ("scalar", dict(p=4)),
    ("batch", dict(epoch_isolation="none", buffer_policy="cold")),
    ("batch_rw", dict(clock_kw=RW, per_op_kw={"bcast": dict(alpha=1e-5)},
                      win_size=60e-6)),                       # top-ups
])
def test_backend_campaigns_equal_reference_sim_backend(engine, kw):
    """Walking clocks under ``auto``, the scalar engine, one cluster shared
    by every epoch with cold buffers, and a window small enough to need
    top-ups: the port's records are the reference ``SimBackend``'s."""
    kw = dict(dict(p=8, seed0=3, sync_kw=dict(n_fitpts=30, n_exchanges=10)), **kw)
    cases = [TestCase("allreduce", 512), TestCase("bcast", 4096),
             TestCase("allreduce@half+allreduce@half", 1024)]
    design = ExperimentDesign(n_launch_epochs=3, nrep=30 if engine != "scalar" else 12, seed=5)
    ours = Campaign(CampaignSpec(cases, design),
                    TorchSimBackend(engine=engine, device="cpu", **kw)).run()
    ref = RefCampaign(RefSpec([RefCase(c.op, c.msize) for c in cases],
                              RefDesign(n_launch_epochs=3, nrep=design.nrep, seed=5)),
                      SimBackend(engine=engine, **kw)).run()
    a, b = _records(ref.records), _records(ours.records)
    assert len(a) == len(b) == 9 and set(a) == set(b)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert [r.meta["engine"] for r in ref.records] == [r.meta["engine"] for r in ours.records]


def test_backend_engine_rules():
    """``scalar`` wants the CPU (checked before the device, so it raises
    here too), the reference's ``jax`` engine is not the port's, the numpy
    engines never fuse epochs, and the card's engines want a card."""
    with pytest.raises(ValueError, match="scalar"):
        TorchSimBackend(engine="scalar", device="cuda")
    with pytest.raises(ValueError, match="engine"):
        TorchSimBackend(engine="jax", device="cpu")
    design = ExperimentDesign(n_launch_epochs=2, nrep=10, seed=0)
    work = {0: [TestCase("allreduce", 512)], 1: [TestCase("allreduce", 512)]}
    for engine in ("auto", "batch", "batch_rw", "scalar"):
        assert TorchSimBackend(engine=engine, device="cpu", p=4).measure_epochs(work, design) is None
    assert TorchSimBackend(device="cpu", p=4, sync_kw=dict(n_fitpts=10, n_exchanges=5)) \
        .measure_epochs(work, design) is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchSimBackend(engine="batch")


def test_run_windowed_engine_rules():
    """``scalar`` on the card raises ``ValueError`` before any device is
    resolved; ``jax`` and unknown names raise; without a card the batch
    engines' default ``device="cuda"`` raises rather than running on the
    CPU, and so does a duration draw asked for the card."""
    net = SimNet(4, seed=2)
    sync = make_sync("hca", n_fitpts=20, n_exchanges=5).synchronize(net)
    op = make_op("bcast")
    with pytest.raises(ValueError, match="device='cpu'"):
        run_windowed(net, sync, op, 256, 10, 300e-6, device="cuda", engine="scalar")
    with pytest.raises(ValueError, match="'torch'"):
        run_windowed(net, sync, op, 256, 10, 300e-6, device="cpu", engine="jax")
    with pytest.raises(ValueError, match="unknown engine"):
        run_windowed(net, sync, op, 256, 10, 300e-6, device="cpu", engine="nope")
    if not torch.cuda.is_available():
        t, state = net.t.copy(), net.rng.bit_generator.state
        for engine in ("batch", "batch_rw", "auto"):
            with pytest.raises(RuntimeError, match="CUDA"):
                run_windowed(net, sync, op, 256, 10, 300e-6, engine=engine)
        with pytest.raises(RuntimeError, match="CUDA"):
            op.execute_batch(net, 256, 10, device="cuda")
        assert np.array_equal(net.t, t)
    assert run_windowed(net, sync, op, 256, 10, 300e-6, device="cpu",
                        engine="scalar").times.shape == (10,)


# ---------------------------------------------------------------------------
# the reference's engine checks (tests/test_batch_equivalence.py), on the
# port's engines
# ---------------------------------------------------------------------------

def _synced(seed, p=8, clock_kw=None):
    net = SimNet(p, seed=seed, clocks=ClockParams(**clock_kw) if clock_kw else None)
    return net, make_sync("hca", **SYNC_KW).synchronize(net)


@pytest.mark.parametrize("coeff", [0.0, 0.35, 0.9, -0.5, 0.999])
def test_ar1_filter_matches_scalar_recurrence(coeff):
    rng = np.random.default_rng(3)
    eps = rng.normal(0.0, 0.04, size=4000)
    state = 0.7
    ref = np.empty(eps.size)
    s = state
    for i in range(eps.size):
        s = coeff * s + eps[i]
        ref[i] = s
    np.testing.assert_allclose(_ar1_filter(eps, coeff, state), ref, rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("engine,clock_kw", [("batch", None), ("batch_rw", RW)])
def test_windowed_batch_exact_when_noise_free(engine, clock_kw):
    """Deterministic noise: the scalar and batched engines compute the same
    campaign (walking clocks over the same frozen drift paths) — times,
    flags, ground truth, global estimates, final ``net.t``."""
    win = 300e-6
    net_a, sync_a = _synced(5, p=16, clock_kw=clock_kw)
    net_b, sync_b = _synced(5, p=16, clock_kw=clock_kw)
    if clock_kw:
        net_a.freeze_drift_paths(win)
        net_b.freeze_drift_paths(win)
    a = run_windowed_scalar(net_a, sync_a, make_op("allreduce", **NOISE_FREE), 4096, 300, win)
    b = run_windowed(net_b, sync_b, make_op("allreduce", **NOISE_FREE), 4096, 300, win,
                     device="cpu", engine=engine)
    assert np.array_equal(a.errors, b.errors)
    for k in ("times", "start_true", "end_true", "start_global_est"):
        np.testing.assert_allclose(getattr(a, k), getattr(b, k), rtol=0, atol=1e-12)
    np.testing.assert_allclose(net_a.t, net_b.t, rtol=0, atol=1e-12)


def test_windowed_batch_exact_with_tight_windows():
    """Noise-free with a window too small for the op: both engines flag the
    same observations START_LATE / TOOK_TOO_LONG."""
    base = make_op("alltoall", **NOISE_FREE).base_time(16, 32768)
    for win in (0.9 * base, 1.2 * base, 3.0 * base):
        net_a, sync_a = _synced(11, p=16)
        net_b, sync_b = _synced(11, p=16)
        a = run_windowed_scalar(net_a, sync_a, make_op("alltoall", **NOISE_FREE),
                                32768, 200, win)
        b = run_windowed(net_b, sync_b, make_op("alltoall", **NOISE_FREE), 32768, 200, win,
                         device="cpu", engine="batch")
        assert np.array_equal(a.errors, b.errors), f"win={win}"
        np.testing.assert_allclose(a.times, b.times, rtol=0, atol=1e-12)


@pytest.mark.parametrize("engine,clock_kw,p,nrep", [("batch", None, 16, 3000),
                                                    ("batch_rw", RW, 8, 2500)])
def test_windowed_batch_matches_scalar_statistically(engine, clock_kw, p, nrep):
    """Live RNG: batched draws reorder the stream (and a pre-sampled path
    is another draw of the walk), so the campaigns are different samples of
    one distribution — Wilcoxon must not tell them apart, means within 2%."""
    net_a, sync_a = _synced(7, p=p, clock_kw=clock_kw)
    net_b, sync_b = _synced(7, p=p, clock_kw=clock_kw)
    a = run_windowed_scalar(net_a, sync_a, make_op("allreduce"), 4096, nrep, 300e-6)
    b = run_windowed(net_b, sync_b, make_op("allreduce"), 4096, nrep, 300e-6,
                     device="cpu", engine=engine)
    res = wilcoxon_rank_sum(a.valid_times, b.valid_times)
    assert res.p_value > 0.05, res.p_value
    assert abs(a.valid_times.mean() - b.valid_times.mean()) < 0.02 * a.valid_times.mean()


def test_windowed_batch_invalid_fraction_tracks_scalar():
    """Fig. 21's regime (the window barely fits the op): comparable invalid
    fractions at every window size."""
    for win, tol in ((40e-6, 0.10), (100e-6, 0.05)):
        net_a, sync_a = _synced(1, p=16)
        net_b, sync_b = _synced(1, p=16)
        a = run_windowed_scalar(net_a, sync_a, make_op("alltoall"), 8192, 1500, win)
        b = run_windowed(net_b, sync_b, make_op("alltoall"), 8192, 1500, win,
                         device="cpu", engine="batch")
        assert abs(a.invalid_fraction - b.invalid_fraction) < tol, win


def test_windowed_engine_dispatch():
    net, sync = _synced(2, p=4)
    wr = run_windowed(net, sync, make_op("bcast"), 256, 50, 300e-6, device="cpu",
                      engine="auto")
    assert wr.times.size == 50          # auto -> batch on affine clocks
    with pytest.raises(ValueError):
        run_windowed(net, sync, make_op("bcast"), 256, 10, 300e-6, device="cpu",
                     engine="nope")


def test_windowed_auto_never_scalar_for_random_walk_clocks():
    """``auto`` resolves to ``batch_rw`` on random-walk clocks, and the
    strict ``batch`` engine refuses them."""
    net = SimNet(4, seed=3, clocks=ClockParams(**RW))
    assert resolve_engine("auto", net) == "batch_rw"
    sync = make_sync("hca", **SYNC_KW).synchronize(net)
    wr = run_windowed(net, sync, make_op("bcast"), 256, 30, 400e-6, device="cpu",
                      engine="auto")
    assert wr.times.size == 30
    with pytest.raises(ValueError):
        run_windowed(net, sync, make_op("bcast"), 256, 10, 400e-6, device="cpu",
                     engine="batch")


def test_execute_batch_exact_when_noise_free():
    net_a, net_b = SimNet(8, seed=9), SimNet(8, seed=9)
    op_a, op_b = make_op("scan", **NOISE_FREE), make_op("scan", **NOISE_FREE)
    ends_a = [op_a.execute(net_a, 1024).end_true for _ in range(50)]
    ex = op_b.execute_batch(net_b, 1024, 50, device="cpu")
    np.testing.assert_allclose(np.asarray(ends_a), ex.end_true, rtol=0, atol=1e-12)
    np.testing.assert_allclose(net_a.t, net_b.t, rtol=0, atol=1e-12)


def test_execute_batch_matches_execute_statistically():
    net_a, net_b = SimNet(8, seed=4), SimNet(8, seed=4)
    op_a, op_b = make_op("allreduce"), make_op("allreduce")
    dur_a = np.empty(2500)
    for i in range(2500):
        start = net_a.t.copy()
        ex = op_a.execute(net_a, 4096)
        dur_a[i] = np.max(ex.end_true) - np.max(start)
    ex_b = op_b.execute_batch(net_b, 4096, 2500, device="cpu")
    dur_b = np.max(ex_b.end_true, axis=1) - np.max(ex_b.start_true, axis=1)
    res = wilcoxon_rank_sum(dur_a, dur_b)
    assert res.p_value > 0.05, res.p_value
    assert abs(dur_a.mean() - dur_b.mean()) < 0.02 * dur_a.mean()


def test_execute_batch_respects_ar_state_across_boundary():
    net = SimNet(4, seed=8)
    op = make_op("bcast", autocorr=0.9, tail_prob=0.0, spike_prob=0.0)
    op.execute(net, 256)
    state_before = op._ar_state
    op.execute_batch(net, 256, 10, device="cpu")
    assert op._ar_state != state_before  # advanced, not reset


def test_torch_engine_matches_batch_engine_statistically():
    """The port's device engine (its own draws, here the plain version on
    the CPU) against the reference's batch engine from the same state: two
    samples of one distribution."""
    net_a, sync_a = _synced(7, p=16)
    net_b, sync_b = _synced(7, p=16)
    a = run_windowed(net_a, sync_a, make_op("allreduce"), 4096, 3000, 300e-6,
                     device="cpu", engine="batch")
    b = run_windowed(net_b, sync_b, make_op("allreduce"), 4096, 3000, 300e-6,
                     device="cpu", engine="torch")
    res = wilcoxon_rank_sum(a.valid_times, b.valid_times)
    assert res.p_value > 0.05, res.p_value
    assert abs(a.valid_times.mean() - b.valid_times.mean()) < 0.02 * a.valid_times.mean()
    assert abs(a.invalid_fraction - b.invalid_fraction) < 0.05


# ---------------------------------------------------------------------------
# the card's scan on the reference's draws (its plain version, CPU tensors)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nrep", [1, 1000, 100_000])
@pytest.mark.parametrize("coeff", [0.35, 0.9, -0.999])
def test_scan_host_draws_matches_reference_sampler(coeff, nrep):
    """``scan_host_draws`` on CPU tensors, fed ``net.rng``, against the
    reference's ``sample_durations`` from the same state: durations within
    1e-12 of max, the AR(1) carry within 1e-12, the generator in the same
    state, the op untouched. Twice in a row, so the carry chains."""
    ref_net, net = _pair(13 + nrep, sync=False)
    kw = dict(autocorr=coeff, tail_prob=0.3, spike_prob=0.05)
    ref_op, op = ref_make_composite_op("alltoall", **kw), make_op("alltoall", **kw)
    ref_op._ar_state = op._ar_state = 0.05
    for warm in (True, False):
        want = ref_op.sample_durations(ref_net, 8, 4096, nrep, warm)
        t0 = op.base_time(8, 4096) * op._bias_for(net)
        t0 = t0 if warm else t0 * (1.0 + op.warm_cache_discount)
        state = op._ar_state
        got, carry = scan_host_draws(op, net.rng, nrep, t0, device="cpu")
        assert op._ar_state == state and got.dtype == np.float64 and got.shape == (nrep,)
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
        assert abs(carry - ref_op._ar_state) <= 1e-12
        assert _same_rng(ref_net, net)
        op._ar_state = carry
