"""The kernel A/B path of the PyTorch port on the CPU: the timing meter,
the operations-under-test factory against the JAX package's (bit-equal
inputs, equal plain outputs), ``TorchKernelBackend`` campaigns whose
store the reference loads, the kernel guideline family, and the copied
statistics against the reference's on random inputs."""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.campaign as ref_campaign
import repro.core.compare as ref_compare
import repro.core.runtime_meter as ref_meter
import repro.core.stats as ref_stats
import repro.guidelines as ref_guidelines
from repro.kernels.ops import make_benchmark_op as jax_benchmark_op
from repro_torch.campaign import (Campaign, CampaignSpec, ResultStore,
                                  TorchKernelBackend)
from repro_torch.convert import tensors_from_reference
from repro_torch.core import ExperimentDesign, TestCase
from repro_torch.core import compare, stats
from repro_torch.core.runtime_meter import (MeterConfig, TorchEpochContext,
                                            make_torch_measure, timed_calls)
from repro_torch.guidelines import (KERNEL_GUIDELINES, SIM_GUIDELINES,
                                    default_guidelines, format_report,
                                    verify_guidelines)
from repro_torch.kernels.ops import BENCHMARK_OPS, make_benchmark_op

SMALL = dict(batch=1, heads=2, kv_heads=1, head_dim=16, state_dim=16)
DESIGN = ExperimentDesign(n_launch_epochs=3, nrep=4, seed=5)


def _counter():
    calls = []

    def fn():
        calls.append(1)
        return torch.zeros(2)
    return fn, calls


# ---------------------------------------------------------------------------
# meter
# ---------------------------------------------------------------------------

def test_timed_calls_warms_up_then_times_each_call():
    fn, calls = _counter()
    out = timed_calls(fn, 5, warmup=2)
    assert out.shape == (5,) and (out > 0).all() and np.isfinite(out).all()
    assert len(calls) == 7


def test_meter_config_matches_reference():
    ours = {f.name: f.default for f in dataclasses.fields(MeterConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(ref_meter.MeterConfig)}
    assert ours == theirs


def test_epoch_context_warms_each_callable_once():
    fn, calls = _counter()
    ctx = TorchEpochContext(lambda e: {"a": fn}, 0, MeterConfig(warmup=3))
    assert ctx.measure("a", 4).size == 4 and len(calls) == 7
    assert ctx.measure("a", 2).size == 2 and len(calls) == 9    # no re-warm


@pytest.mark.parametrize("isolation,released", [("clear_caches", True),
                                                ("none", False)])
def test_epoch_isolation_releases_previous_epoch(isolation, released):
    cfg = MeterConfig(epoch_isolation=isolation)
    first = TorchEpochContext(lambda e: {"a": lambda: torch.ones(3)}, 0, cfg)
    TorchEpochContext(lambda e: {"a": lambda: torch.ones(3)}, 1, cfg,
                      previous=first)
    assert (not first.callables) == released


def test_epoch_isolation_must_be_known():
    with pytest.raises(ValueError, match="epoch_isolation"):
        TorchEpochContext(lambda e: {}, 0, MeterConfig(epoch_isolation="process"))


def test_make_torch_measure_runs_a_case():
    fn, calls = _counter()
    epoch_factory, measure = make_torch_measure(lambda e: {"op@8": fn},
                                                MeterConfig(warmup=1))
    ctx = epoch_factory(0)
    assert measure(ctx, TestCase("op", 8), 3).size == 3 and len(calls) == 4
    ctx2 = epoch_factory(1)
    assert not ctx.callables and "op@8" in ctx2.callables


# ---------------------------------------------------------------------------
# operations under test
# ---------------------------------------------------------------------------

def _reference_inputs(fn) -> list[np.ndarray]:
    """The arrays a reference benchmark op closes over, in draw order."""
    env = inspect.getclosurevars(fn).nonlocals
    names = ("q", "k", "v") if "q" in env else ("x", "dta", "B", "C")
    return [np.asarray(env[n]) for n in names]


@pytest.mark.parametrize("op", BENCHMARK_OPS)
@pytest.mark.parametrize("seq,seed", [(64, 0), (256, 3)])
def test_benchmark_inputs_bit_equal_and_plain_output_equal(op, seq, seed):
    kw = dict(SMALL, seq=seq, seed=seed)
    if op == "ssd_scan":
        kw["kv_heads"] = None
    ref_fn = jax_benchmark_op(op, "ref", **kw)
    ours = make_benchmark_op(op, "ref", **kw, device="cpu")
    for a, t in zip(_reference_inputs(ref_fn), ours.inputs, strict=True):
        assert a.dtype == np.float32 and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), a)
    y, yr = ours().numpy(), np.asarray(ref_fn())
    assert y.shape == yr.shape
    assert np.abs(y - yr).max() <= 1e-5 * np.abs(yr).max()
    # the cuda side of the A/B runs the same function (its plain version
    # on the CPU)
    np.testing.assert_array_equal(make_benchmark_op(op, "cuda", **kw,
                                                    device="cpu")().numpy(), y)


@pytest.mark.parametrize("op", BENCHMARK_OPS)
def test_benchmark_inputs_in_bf16_are_the_reference_draws_cast(op):
    """``dtype=torch.bfloat16`` casts the draws as the reference's factory
    does with ``dtype=jnp.bfloat16``; dta stays in f32, which the kernels
    take, holding the same bf16 values."""
    kw = dict(SMALL, seq=64, seed=1)
    if op == "ssd_scan":
        kw["kv_heads"] = None
    ref_fn = jax_benchmark_op(op, "ref", **kw, dtype=jnp.bfloat16)
    ours = make_benchmark_op(op, "ref", **kw, dtype=torch.bfloat16, device="cpu")
    names = ("q", "k", "v") if op == "flash_attention" else ("x", "dta", "B", "C")
    for name, a, t in zip(names, _reference_inputs(ref_fn), ours.inputs, strict=True):
        assert t.dtype == (torch.float32 if name == "dta" else torch.bfloat16), name
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(a, np.float32))


def test_tensors_from_reference_carry_values_exactly():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 4)).astype(np.float32)
    jb = jnp.asarray(a, jnp.bfloat16)
    out = tensors_from_reference({"a": a, "b": jb}, "cpu")
    assert out["a"].dtype == torch.float32 and out["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["a"].numpy(), a)
    np.testing.assert_array_equal(out["b"].float().numpy(),
                                  np.asarray(jb, np.float32))
    t, = tensors_from_reference((a,), "cpu", dtype=torch.float64)
    assert t.dtype == torch.float64 and np.array_equal(t.numpy(), a)


@pytest.mark.parametrize("op,impl", [("flash_attention", "pallas"),
                                     ("flash_attention", "triton"),
                                     ("matmul", "ref")])
def test_benchmark_op_refuses_unknown(op, impl):
    with pytest.raises(ValueError):
        make_benchmark_op(op, impl, seq=16, device="cpu")


# ---------------------------------------------------------------------------
# backend and campaign
# ---------------------------------------------------------------------------

def _cpu_backend(**kw):
    return TorchKernelBackend(device="cpu", **SMALL, **kw)


def test_kernel_campaign_store_loads_in_reference(tmp_path):
    cases = [TestCase("flash_attention#cuda", 32), TestCase("ssd_scan#ref", 64),
             TestCase("flash_attention+ssd_scan", 32)]
    store = ResultStore(tmp_path / "k.jsonl")
    res = Campaign(CampaignSpec(cases, DESIGN, name="kab"), _cpu_backend(),
                   store).run()
    assert len(res.records) == len(cases) * DESIGN.n_launch_epochs
    assert all(r.times.size == DESIGN.nrep and (r.times > 0).all()
               and r.meta["device"] == "cpu" for r in res.records)
    # the host time of drawing each record's inputs, outside the timed calls
    assert all(r.meta["build_s"] > 0 for r in res.records)
    theirs = ref_campaign.ResultStore(tmp_path / "k.jsonl")
    loaded = theirs.records(res.fingerprint)
    assert len(loaded) == len(res.records)
    for a, b in zip(res.records, loaded):
        assert (a.case.op, a.case.msize, a.epoch) == (b.case.op, b.case.msize, b.epoch)
        np.testing.assert_array_equal(a.times, b.times)
    # resume: nothing is measured again
    again = Campaign(CampaignSpec(cases, DESIGN, name="kab"), _cpu_backend(),
                     ResultStore(tmp_path / "k.jsonl")).run()
    assert again.n_measured == 0 and again.n_resumed == len(res.records)


def test_factors_name_the_port_and_separate_impls():
    f = _cpu_backend().factors(DESIGN)
    extra = dict(f.extra)
    assert f.sync_method == "cuda_synchronize" and f.measurement_backend == "kernel"
    assert extra["impl"] == "cuda" and extra["device"] == "cpu"
    assert (extra["heads"], extra["head_dim"], extra["seed0"]) == (2, 16, 0)
    assert f.fingerprint() != _cpu_backend(impl="ref").factors(DESIGN).fingerprint()
    ref_f = ref_campaign.KernelBackend(heads=2, kv_heads=1, head_dim=16,
                                       state_dim=16).factors(DESIGN)
    assert f.fingerprint() != ref_f.fingerprint()


def test_factors_carry_the_inputs_type():
    """The inputs' type is the factor set's ``dtype``: f32 campaigns keep
    the reference's default (and so their fingerprint), bf16 ones differ."""
    f32 = _cpu_backend().factors(DESIGN)
    bf16 = _cpu_backend(dtype="bfloat16").factors(DESIGN)
    assert f32.dtype == "float32" and bf16.dtype == "bfloat16"
    assert f32.fingerprint() == _cpu_backend(dtype="float32").factors(DESIGN).fingerprint()
    assert bf16.fingerprint() != f32.fingerprint()
    with pytest.raises(ValueError, match="dtype"):
        _cpu_backend(dtype="float16")


def test_half_is_refused():
    backend = _cpu_backend()
    ctx = backend.make_epoch(0)
    with pytest.raises(ValueError, match="@half"):
        backend.measure(ctx, TestCase("flash_attention@half", 32), 2)


def test_backend_refuses_unknown_impl_and_missing_gpu():
    with pytest.raises(ValueError, match="impl"):
        _cpu_backend(impl="pallas")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: a CUDA backend is legitimate here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchKernelBackend()


def test_epochs_release_their_inputs():
    backend = _cpu_backend()
    ctx0 = backend.make_epoch(0)
    backend.measure(ctx0, TestCase("flash_attention", 32), 2)
    assert ctx0.callables
    backend.make_epoch(1)
    assert not ctx0.callables


# ---------------------------------------------------------------------------
# guidelines
# ---------------------------------------------------------------------------

def test_kernel_family_compares_kernel_with_plain_version():
    assert default_guidelines("kernel") is KERNEL_GUIDELINES
    assert [(g.lhs, g.rhs) for g in KERNEL_GUIDELINES] == [
        ("flash_attention#cuda", "flash_attention#ref"),
        ("ssd_scan#cuda", "ssd_scan#ref")]
    assert [(g.name, g.msizes) for g in KERNEL_GUIDELINES] == [
        (g.name, g.msizes) for g in ref_guidelines.KERNEL_GUIDELINES]
    assert [dataclasses.astuple(g) for g in SIM_GUIDELINES] == [
        dataclasses.astuple(g) for g in ref_guidelines.SIM_GUIDELINES]
    with pytest.raises(ValueError):
        default_guidelines("collective")


def test_verify_kernel_guidelines_on_cpu(tmp_path):
    family = [dataclasses.replace(g, msizes=(32, 64)) for g in KERNEL_GUIDELINES]
    design = ExperimentDesign(n_launch_epochs=4, nrep_min=4, nrep_max=8,
                              rel_ci_target=0.2, seed=1)
    store = ResultStore(tmp_path / "g.jsonl")
    report = verify_guidelines(family, _cpu_backend(), design=design, store=store)
    assert len(report.verdicts) == 4 and report.n_measured == 8 * 4   # cases x epochs
    assert all(v.n_epochs == 4 and v.lhs_us > 0 and v.rhs_us > 0
               for v in report.verdicts)
    assert "flash_attention_vs_ref" in format_report(report)
    # both sides run the plain version on the CPU: the family reads the
    # store back through the reference's verdict procedure identically
    table = ref_campaign.ResultStore(tmp_path / "g.jsonl").to_table()
    theirs = ref_guidelines.verdicts_from_table(
        [ref_guidelines.Guideline(g.name, g.lhs, g.rhs, msizes=g.msizes)
         for g in family], table)
    assert [(v.p_violated, v.p_holm) for v in report.verdicts] == [
        (v.p_violated, v.p_holm) for v in theirs]


# ---------------------------------------------------------------------------
# statistics copied from the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("alternative", ["two-sided", "less", "greater"])
def test_wilcoxon_equals_reference(seed, alternative):
    rng = np.random.default_rng(seed)
    a = rng.lognormal(0.0, 0.3, 12 + seed)
    b = np.round(rng.lognormal(0.1, 0.3, 9 + 2 * seed), 2)   # with ties
    assert dataclasses.astuple(stats.wilcoxon_rank_sum(a, b, alternative)) == \
        dataclasses.astuple(ref_stats.wilcoxon_rank_sum(a, b, alternative))


@pytest.mark.parametrize("seed", range(3))
def test_holm_and_stars_equal_reference(seed):
    p = np.random.default_rng(seed).random(7) ** 3
    np.testing.assert_array_equal(stats.holm_bonferroni(p),
                                  ref_stats.holm_bonferroni(p))
    assert [stats.significance_stars(x) for x in p] == \
        [ref_stats.significance_stars(x) for x in p]


def test_compare_tables_equals_reference(tmp_path):
    cases = [TestCase("flash_attention", 32), TestCase("ssd_scan", 32)]
    tables = []
    for impl in ("cuda", "ref"):
        res = Campaign(CampaignSpec(cases, DESIGN), _cpu_backend(impl=impl)).run()
        tables.append(res.table)
    ours = compare.compare_tables(*tables)
    theirs = ref_compare.compare_tables(*tables)
    assert compare.format_comparison(ours) == ref_compare.format_comparison(theirs)
