"""The port's campaign layer (``repro_torch.campaign``) held against the
JAX package, on the CPU: identical host state from one seed, stores the
reference reads and resumes, record provenance, and the slice gate — the
archived reference audit campaign re-run through ``TorchSimBackend`` and
certified by the reference's own TOST audit engine.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from repro.campaign import ResultStore as RefStore
from repro.campaign import SimBackend
from repro.core import SimNet as RefNet
from repro.core import make_op as ref_make_op
from repro.core import make_sync as ref_make_sync
from repro.history import audit_tables
from repro_torch.campaign import (Campaign, CampaignSpec, ResultStore,
                                  TorchSimBackend)
from repro_torch.core import (ExperimentDesign, SimNet, TestCase, make_op,
                              make_sync)

ARCHIVE = Path(__file__).resolve().parents[1] / "benchmarks" \
    / "reference_archive" / "run-000.jsonl"
AUDIT_CASES = [TestCase(op, m) for op in ("allreduce", "bcast", "alltoall")
               for m in (512, 4096)]


def _audit_backend(**kw):
    """The archived run's spec (``benchmarks/run.py audit``): p=8, hca
    with 60 fitpoints x 20 exchanges, seed 0."""
    return TorchSimBackend(p=8, seed0=0, device="cpu",
                           sync_kw=dict(n_fitpts=60, n_exchanges=20), **kw)


def _audit_spec():
    return CampaignSpec(AUDIT_CASES,
                        ExperimentDesign(n_launch_epochs=12, nrep=40, seed=0),
                        name="repro-audit")


@pytest.mark.parametrize("sync_name,sync_kw", [
    ("hca", dict(n_fitpts=60, n_exchanges=20)),
    ("jk", dict(n_fitpts=20, n_exchanges=10)),
    ("skampi", {}),
    ("netgauge", {}),
])
def test_host_state_identical_to_reference(sync_name, sync_kw):
    """One seed, both packages: bit-identical clocks, sync models, true
    times, RNG position and epoch biases (window seed first, then the
    bias, the order both engines draw them in)."""
    ref_net, net = RefNet(12, seed=41), SimNet(12, seed=41)
    ref_sync = ref_make_sync(sync_name, **sync_kw).synchronize(ref_net)
    sync = make_sync(sync_name, **sync_kw).synchronize(net)
    for a, b in zip(ref_net.clocks, net.clocks):
        assert (a.offset, a.skew, a.scale_error, a.seed) \
            == (b.offset, b.skew, b.scale_error, b.seed)
    assert [(m.slope, m.intercept) for m in ref_sync.models] \
        == [(m.slope, m.intercept) for m in sync.models]
    assert ref_sync.initial_times == sync.initial_times
    assert ref_sync.duration == sync.duration
    assert np.array_equal(ref_net.t, net.t)
    assert ref_net.msg_count == net.msg_count
    assert ref_net.rng.integers(2**31) == net.rng.integers(2**31)
    for name in ("allreduce", "alltoall"):
        assert ref_make_op(name)._bias_for(ref_net) \
            == make_op(name)._bias_for(net)


def test_factors_match_reference_sim_backend():
    """Same factor fields and values as the reference's SimBackend, except
    the capture: no JAX fields, the torch environment in ``extra``."""
    design = ExperimentDesign(n_launch_epochs=3, nrep=20, seed=2)
    ref = SimBackend(p=8, seed0=4, per_op_kw={"bcast": dict(alpha=1e-5)})
    ours = TorchSimBackend(p=8, seed0=4, per_op_kw={"bcast": dict(alpha=1e-5)},
                           device="cpu")
    a, b = ref.factors(design).to_dict(), ours.factors(design).to_dict()
    assert set(a) == set(b)
    for k in a:
        if k not in ("jax_version", "xla_flags", "extra"):
            assert a[k] == b[k], k
    assert b["jax_version"] == "" and b["xla_flags"] == ""
    ref_extra = dict(a["extra"])
    ref_extra["engine"] = "torch"
    extra = dict(b["extra"])
    assert {k: extra[k] for k in ref_extra} == ref_extra
    assert set(extra) - set(ref_extra) \
        == {"torch", "cuda", "capability", "device_name"}
    assert extra["device_name"] == "cpu"


def test_store_loads_in_reference_and_resumes_byte_identically(tmp_path):
    """A port store is a reference store: same fingerprint, factors and
    records through ``repro.campaign.ResultStore``. Killed at an epoch
    boundary and resumed, it ends byte-identical to an uninterrupted run."""
    spec = CampaignSpec([TestCase("allreduce", 512), TestCase("bcast", 4096)],
                        ExperimentDesign(n_launch_epochs=4, nrep=30, seed=3))
    full = tmp_path / "full.jsonl"
    res = Campaign(spec, _audit_backend(), ResultStore(full)).run()

    ref = RefStore(full)
    assert ref.fingerprints() == [res.fingerprint]
    assert ref.factors(res.fingerprint) \
        == json.loads(json.dumps(res.factors.to_dict()))
    got = {(r.case.op, r.case.msize, r.epoch): r.times
           for r in ref.records(res.fingerprint)}
    assert len(got) == len(res.records) == 8
    for r in res.records:
        assert np.array_equal(got[(r.case.op, r.case.msize, r.epoch)], r.times)

    # kill after epoch 1: keep the header, the declaration and 2 epochs
    lines = full.read_text().splitlines(keepends=True)
    kept = [ln for ln in lines
            if json.loads(ln).get("kind") != "record"
            or json.loads(ln)["epoch"] < 2]
    killed = tmp_path / "killed.jsonl"
    killed.write_text("".join(kept))
    resumed = Campaign(spec, _audit_backend(), ResultStore(killed)).run()
    assert (resumed.n_resumed, resumed.n_measured) == (4, 4)
    assert killed.read_bytes() == full.read_bytes()


def test_record_provenance_and_fuse_gating():
    """Fused records say so; ``fuse_epochs`` and shared-cluster isolation
    gate the fused path off, and ``fuse_epochs`` is no factor."""
    design = ExperimentDesign(n_launch_epochs=2, nrep=10, seed=5)
    spec = CampaignSpec([TestCase("bcast", 256)], design)
    fused = Campaign(spec, _audit_backend()).run()
    assert all(r.meta["engine"] == "torch" and r.meta["device"] == "cpu"
               and r.meta["fused"] for r in fused.records)
    assert fused.meta["dispatch"]["n_dispatches"] > 0
    for backend in (_audit_backend(fuse_epochs=False),
                    _audit_backend(epoch_isolation="none")):
        assert backend.measure_epochs({0: spec.cases}, design) is None
        res = Campaign(spec, backend).run()
        assert len(res.records) == 2
        assert all(r.meta["engine"] == "torch" and not r.meta["fused"]
                   for r in res.records)
    a = _audit_backend(fuse_epochs=True).factors(design)
    b = _audit_backend(fuse_epochs=False).factors(design)
    assert a.fingerprint() == b.fingerprint()
    assert "fuse" not in repr(sorted(a.extra))


def test_slice_gate_certifies_against_reference_archive():
    """The archived reference run's spec through the port: 6/6 EQUIVALENT
    under the reference's TOST audit (±10%, Holm). Positive control: a
    mis-tuned bcast drifts exactly the bcast cells."""
    ref = RefStore(ARCHIVE).to_table()
    report = audit_tables(ref, Campaign(_audit_spec(), _audit_backend()).run().table)
    assert len(report.cells) == 6
    assert [c.verdict for c in report.cells] == ["EQUIVALENT"] * 6, \
        [(c.op, c.msize, c.verdict, c.ratio) for c in report.cells]

    control = _audit_backend(per_op_kw={"bcast": dict(alpha=12e-6, gamma=6e-6)})
    report = audit_tables(ref, Campaign(_audit_spec(), control).run().table)
    assert {(c.op, c.msize) for c in report.drifted()} \
        == {("bcast", 512), ("bcast", 4096)}
