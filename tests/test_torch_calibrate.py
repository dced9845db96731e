"""The port's sim calibration (``repro_torch.calibrate``), held against
the JAX package on the CPU.

Exact: the parameter surface (``CalibrationParam.clip``,
``CalibrationSpace.start``, ``clip`` and ``manifest``) equals the
reference's, and calib stores cross between the packages. Live: the
reference's sim-target spec (``benchmarks/reference_calibration.json``:
``op.alpha``, 6 rounds, 24 epochs x nrep 30, p = 8) fits ``op.alpha``
within 10% of the reference's 6.25e-06 with no held-out cell DRIFTED, and
a killed fit replays its persisted rounds to the same result.
"""

import json
from pathlib import Path

import pytest

import repro.calibrate as ref_calibrate
from repro.campaign import ResultStore as RefStore
from repro.campaign import SimBackend
from repro.history import RunArchive as RefArchive
from repro_torch.calibrate import (CALIBRATED_TAG, CalibrationParam,
                                   CalibrationSpace, calibrate, certify_heldout,
                                   default_space)
from repro_torch.campaign import Campaign, CampaignSpec, ResultStore, TorchSimBackend
from repro_torch.core import NREP_SPENT, ExperimentDesign, TestCase
from repro_torch.history import RunArchive

ROOT = Path(__file__).resolve().parents[1]
REFERENCE_FIT = json.loads((ROOT / "benchmarks" / "reference_calibration.json").read_text())
FAST_SYNC = dict(n_fitpts=60, n_exchanges=20)        # benchmarks/run.py calibrate
SPEC_CASES = [TestCase(op, m) for op in ("allreduce", "bcast") for m in (512, 4096)]


def _base(**kw):
    return TorchSimBackend(p=8, seed0=0, sync_kw=dict(FAST_SYNC), device="cpu", **kw)


def _truth():
    """The sim target of ``benchmarks/run.py calibrate --target sim``."""
    return TorchSimBackend(p=8, seed0=7919, sync_kw=dict(FAST_SYNC), device="cpu",
                           op_kw=dict(alpha=6e-6, noise_sigma=0.09, tail_prob=0.16))


def _spec_fit(store, archive=None):
    return calibrate(default_space(base=_base(), names=["op.alpha"]), _truth(),
                     cases=SPEC_CASES,
                     design=ExperimentDesign(n_launch_epochs=24, nrep=30, seed=0),
                     store=store, archive=archive, seed=0, max_rounds=6)


@pytest.fixture(scope="module")
def spec_fit(tmp_path_factory):
    root = tmp_path_factory.mktemp("calib")
    archive = RunArchive(root / "archive")
    store = ResultStore(archive.new_store_path(stem="calib"))
    return _spec_fit(store, archive), store, archive


# ---------------------------------------------------------------------------
# Exact: the parameter surface
# ---------------------------------------------------------------------------

NAMES = (["op.alpha"], ["op.alpha", "op.noise_sigma", "clock.rw_sigma"], None)


@pytest.mark.parametrize("names", NAMES)
@pytest.mark.parametrize("latency_scale", [1.0, 100.0])
def test_space_start_clip_and_manifest_equal_reference(names, latency_scale):
    space = default_space(base=_base(), names=names, latency_scale=latency_scale)
    ref = ref_calibrate.default_space(
        base=SimBackend(p=8, seed0=0, sync_kw=dict(FAST_SYNC)), names=names,
        latency_scale=latency_scale)
    assert space.names() == ref.names()
    assert space.start() == ref.start()
    probes = [{p.name: p.lo + f * (p.hi - p.lo) for p in space.params}
              for f in (-0.5, 0.0, 0.123456789, 0.5, 0.987654321, 1.5)]
    for v in probes:
        assert space.clip(v) == ref.clip(v)
    manifest, ref_manifest = space.manifest(), ref.manifest()
    # the base backend's engine is the one field that differs by design
    assert (manifest["base"].pop("engine"), ref_manifest["base"].pop("engine")) \
        == ("torch", "auto")
    assert manifest == ref_manifest
    assert "device" not in manifest["base"] and "fuse_epochs" not in manifest["base"]


@pytest.mark.parametrize("name,lo,hi,res,value", [
    ("op.noise_sigma", 0.0, 1.0, 0.01, 0.123456),
    ("op.alpha", 0.5e-6, 12e-6, 1e-9, 6.2500004e-6),
    ("clock.rw_sigma", 0.0, 1e-6, 1e-9, 3.3e-7),
    ("per_op.bcast.gamma", 1e-7, 1e-5, 0.0, 2.5e-6),
])
def test_param_clip_equals_reference(name, lo, hi, res, value):
    p = CalibrationParam(name, lo, hi, resolution=res)
    r = ref_calibrate.CalibrationParam(name, lo, hi, resolution=res)
    for v in (value, lo - 1.0, hi + 1.0, lo, hi):
        assert p.clip(v) == r.clip(v)
    assert p.start == r.start


def test_param_and_space_validation():
    with pytest.raises(ValueError, match="not a SimCollective field"):
        CalibrationParam("op.noise_sgima", 0.0, 1.0)
    with pytest.raises(ValueError, match="not a ClockParams field"):
        CalibrationParam("clock.rw_sgima", 0.0, 1.0)
    with pytest.raises(ValueError, match="name must be"):
        CalibrationParam("noise_sigma", 0.0, 1.0)
    with pytest.raises(ValueError, match="lo < hi"):
        CalibrationParam("op.alpha", 1.0, 1.0)
    with pytest.raises(ValueError, match="no parameters"):
        CalibrationSpace(params=(), base=_base())
    with pytest.raises(KeyError, match="unknown params"):
        default_space(base=_base(), names=["op.alpha"]).clip({"op.beta": 1.0})


def test_materialize_routes_all_three_kinds_and_fingerprints():
    space = CalibrationSpace(
        params=(CalibrationParam("op.noise_sigma", 0.0, 0.5),
                CalibrationParam("per_op.bcast.alpha", 1e-6, 9e-6),
                CalibrationParam("clock.rw_sigma", 0.0, 1e-6)),
        base=_base())
    b = space.materialize({"op.noise_sigma": 0.1, "per_op.bcast.alpha": 4e-6,
                           "clock.rw_sigma": 2e-7})
    assert (b.op_kw["noise_sigma"], b.per_op_kw["bcast"]["alpha"],
            b.clock_kw["rw_sigma"]) == (0.1, 4e-6, 2e-7)
    assert b.device == "cpu" and b._shared_epoch is None
    assert "noise_sigma" not in space.base.op_kw
    design = ExperimentDesign(n_launch_epochs=4, nrep=5)
    one = default_space(base=_base(), names=["op.noise_sigma"])
    fp = lambda v: one.materialize({"op.noise_sigma": v}).factors(design).fingerprint()  # noqa: E731
    assert fp(0.05) != fp(0.06) and fp(0.05) == fp(0.05 + 1e-13)


# ---------------------------------------------------------------------------
# Live: the reference's sim-target spec
# ---------------------------------------------------------------------------

def test_spec_fit_recovers_the_reference_value_and_certifies(spec_fit):
    res, store, archive = spec_fit
    want = REFERENCE_FIT["params"]["op.alpha"]
    assert res.params["op.alpha"] == pytest.approx(want, rel=0.10)
    assert res.ok and not res.report.drifted()
    assert res.n_fit_epochs == 16 and res.n_heldout_epochs == 8
    objs = [r["objective"] for r in res.rounds]
    assert all(b <= a + 1e-12 for a, b in zip(objs, objs[1:]))
    assert res.run_entry.tag == CALIBRATED_TAG
    (logged,) = archive.calibrations(res.run_entry.run_id)
    assert logged["report"]["params"] == res.params
    assert store.meta()["calibration"]["calib"] == res.calib_id


def test_spec_fit_replays_every_round_and_measures_nothing(spec_fit, tmp_path):
    res, store, _ = spec_fit
    copy = ResultStore(tmp_path / "copy.jsonl")
    copy.path.write_bytes(store.path.read_bytes())
    spent = NREP_SPENT.read()
    again = _spec_fit(copy)
    assert NREP_SPENT.read() == spent
    assert again.n_rounds_resumed == len(again.rounds) == len(res.rounds)
    assert (again.params, again.objective, again.verdict) \
        == (res.params, res.objective, res.verdict)


def test_killed_fit_resumes_on_the_same_trajectory(spec_fit, tmp_path):
    """Killed right after its first persisted round, the fit replays the
    round and converges to the same parameters; its non-meta lines equal
    the uninterrupted store's."""
    res, store, _ = spec_fit
    lines = store.path.read_text().splitlines(keepends=True)
    first = next(i for i, ln in enumerate(lines) if json.loads(ln)["kind"] == "calib-round")
    killed = ResultStore(tmp_path / "killed.jsonl")
    killed.path.write_text("".join(lines[:first + 1]))
    again = _spec_fit(killed)
    assert again.n_rounds_resumed == 1
    assert (again.params, again.objective) == (res.params, res.objective)
    content = lambda p: [ln for ln in p.read_text().splitlines()  # noqa: E731
                         if json.loads(ln)["kind"] != "meta"]
    assert content(killed.path) == content(store.path)


def test_calib_store_loads_in_reference(spec_fit, tmp_path):
    """The fit's store and archive read in the reference: the manifest,
    the rounds and the registered run."""
    res, store, archive = spec_fit
    ref = RefStore(store.path)
    assert ref.calib_manifest(res.calib_id) == store.calib_manifest(res.calib_id)
    assert ref.calib_rounds(res.calib_id) == store.calib_rounds(res.calib_id)
    assert [r["round"] for r in ref.calib_rounds(res.calib_id)] == list(range(len(res.rounds)))
    assert ref.meta()["calibration"]["params"] == res.params
    (entry,) = RefArchive(archive.root).runs(tag=CALIBRATED_TAG)
    assert entry.run_id == res.run_entry.run_id
    assert RefArchive(archive.root).calibrations(entry.run_id) \
        == archive.calibrations(entry.run_id)


def test_frozen_misfit_is_drifted(tmp_path):
    """The positive control: a mis-tuned frozen candidate certified on
    the held-out epochs comes back DRIFTED."""
    design = ExperimentDesign(n_launch_epochs=24, nrep=30, seed=0)
    store = ResultStore(tmp_path / "ctl.jsonl")
    target = Campaign(CampaignSpec(SPEC_CASES, design, name="ctl/target"), _truth(),
                      store).run()
    misfit = Campaign(CampaignSpec(SPEC_CASES, design, name="ctl/misfit"),
                      _base(op_kw=dict(alpha=12e-6, gamma=6e-6)), store).run()
    report = certify_heldout(target.records, misfit.records, n_fit_epochs=16,
                             design=design, seed=0)
    assert not report.ok and report.drifted()


def test_calibrate_guards(tmp_path):
    space = default_space(base=_base(), names=["op.alpha"])
    with pytest.raises(ValueError, match="store is required"):
        calibrate(space, _truth())
    with pytest.raises(ValueError, match="share seed0"):
        calibrate(space, _base(), store=ResultStore(tmp_path / "s.jsonl"))
    with pytest.raises(ValueError, match="held-out"):
        calibrate(space, _truth(), store=ResultStore(tmp_path / "h.jsonl"),
                  design=ExperimentDesign(n_launch_epochs=3, nrep=5), n_fit_epochs=2)
