"""The port's drift audit (``repro_torch.history``), held against the JAX
package on the CPU.

Exact on the same inputs: two identical copies of
``benchmarks/reference_archive/``, the same added store in each, and each
package's ``RunArchive`` / ``audit_runs`` on its own copy give the same run
ids, every ``CellVerdict`` field and the same report text; the archives
and audit logs one package writes, the other reads. Live: phase 5's spec
(``chip_smoke.py``) through ``TorchSimBackend(device="cpu")`` audits 6/6
EQUIVALENT through the port's ``history`` and, as a second check, through
``repro.history.audit_tables``; the mis-tuned bcast control drifts exactly
its own cells.
"""

import dataclasses
import shutil
from pathlib import Path

import pytest

import repro.history as ref_history
from repro.campaign import ResultStore as RefStore
from repro.core import EpochSummary as RefSummary
from repro.core import ResultTable as RefTable
from repro.core import TestCase as RefCase
from repro_torch.campaign import Campaign, CampaignSpec, ResultStore, TorchSimBackend
from repro_torch.core import EpochSummary, ExperimentDesign, ResultTable, TestCase
from repro_torch.history import (CONTROL_TAG, DEFAULT_MARGIN, RunArchive,
                                 audit_runs, audit_tables, format_audit_report,
                                 format_drift)

ARCHIVE = Path(__file__).resolve().parents[1] / "benchmarks" / "reference_archive"
AUDIT_CASES = [TestCase(op, m) for op in ("allreduce", "bcast", "alltoall")
               for m in (512, 4096)]
MISTUNED_BCAST = {"bcast": dict(alpha=12e-6, gamma=6e-6)}


def _gate_backend(**kw):
    """Phase 5's spec (``benchmarks/run.py audit``): p = 8, hca 60 x 20."""
    return TorchSimBackend(p=8, seed0=0, sync_kw=dict(n_fitpts=60, n_exchanges=20),
                           device="cpu", **kw)


def _gate_spec():
    return CampaignSpec(AUDIT_CASES, ExperimentDesign(n_launch_epochs=12, nrep=40, seed=0),
                        name="repro-audit")


def _entry_view(e):
    d = dataclasses.asdict(e)
    d.pop("timestamp")
    return d


@pytest.fixture(scope="module")
def twin_archives(tmp_path_factory):
    """Two copies of the reference archive; phase 5's campaign and its
    bcast control, measured once by the port, copied into both."""
    root = tmp_path_factory.mktemp("twins")
    port_root, ref_root = root / "port", root / "ref"
    shutil.copytree(ARCHIVE, port_root)
    shutil.copytree(ARCHIVE, ref_root)
    port, ref = RunArchive(port_root), ref_history.RunArchive(ref_root)
    entries = {}
    for name, kw, tag in (("run", {}, None),
                          ("control", dict(per_op_kw=MISTUNED_BCAST), CONTROL_TAG)):
        path = port.new_store_path()
        Campaign(_gate_spec(), _gate_backend(**kw), ResultStore(path)).run()
        shutil.copy(path, ref_root / path.name)
        entries[name] = (port.register(path, tag=tag),
                         ref.register(ref_root / path.name, tag=tag))
    return port, ref, entries


def test_registration_gives_the_same_entries(twin_archives):
    port, ref, entries = twin_archives
    for name, (a, b) in entries.items():
        assert _entry_view(a) == _entry_view(b), name
    assert [_entry_view(e) for e in port.runs()] == [_entry_view(e) for e in ref.runs()]
    ((base_p, base_r),) = [(port.entry(e.run_id), ref.entry(e.run_id))
                           for e in ref.runs(tag="reference")]
    assert _entry_view(base_p) == _entry_view(base_r)
    # a control never becomes the default baseline
    cand = entries["run"][0]
    assert port.baseline_for(cand).tag != CONTROL_TAG


@pytest.mark.parametrize("name", ["run", "control"])
def test_audit_runs_equals_reference_field_by_field(twin_archives, name):
    port, ref, entries = twin_archives
    a = audit_runs(port, entries[name][0].run_id, baseline_tag="reference", log=False)
    b = ref_history.audit_runs(ref, entries[name][1].run_id, baseline_tag="reference",
                               log=False)
    assert [dataclasses.asdict(c) for c in a.cells] == [dataclasses.asdict(c) for c in b.cells]
    assert (a.margin, a.alpha, a.statistic, a.audit_id, a.factor_diffs) \
        == (b.margin, b.alpha, b.statistic, b.audit_id, b.factor_diffs)
    assert [c.verdict for c in a.cells] == [c.verdict for c in b.cells]
    assert format_audit_report(a, title=name) == ref_history.format_audit_report(b, title=name)
    assert format_drift(a) == ref_history.format_drift(b)


def test_slice_gate_through_the_ports_history(twin_archives):
    """Phase 5's spec: 6/6 EQUIVALENT against the archived reference run
    through the port's own audit, and through the reference's
    ``audit_tables`` as a second check; the control drifts exactly bcast."""
    port, _, entries = twin_archives
    report = audit_runs(port, entries["run"][0], baseline_tag="reference", log=False)
    assert [c.verdict for c in report.cells] == ["EQUIVALENT"] * 6, \
        [(c.op, c.msize, c.verdict, c.ratio) for c in report.cells]
    assert report.ok and report.all_equivalent
    base = RefStore(ARCHIVE / "run-000.jsonl").to_table()
    second = ref_history.audit_tables(base, RefStore(port.open_store(entries["run"][0]).path)
                                      .to_table())
    assert [c.verdict for c in second.cells] == ["EQUIVALENT"] * 6

    control = audit_runs(port, entries["control"][0], baseline_tag="reference", log=False)
    assert {(c.op, c.msize) for c in control.drifted()} == {("bcast", 512), ("bcast", 4096)}
    assert not control.ok
    assert "bcast @ msize=512: candidate slower" in format_drift(control)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_audit_logs_resume_across_packages(twin_archives, tmp_path, writer):
    """An audit log one package wrote resumes in the other: every cell is
    read back, none recomputed, the same verdicts."""
    port, _, entries = twin_archives
    root = tmp_path / "arch"
    shutil.copytree(port.root, root)
    packages = {"port": (RunArchive, audit_runs),
                "reference": (ref_history.RunArchive, ref_history.audit_runs)}
    reader = "reference" if writer == "port" else "port"
    run_id = entries["run"][0].run_id
    make, audit = packages[writer]
    first = audit(make(root), run_id, baseline_tag="reference")
    make, audit = packages[reader]
    again = audit(make(root), run_id, baseline_tag="reference")
    assert (first.n_computed, first.n_resumed) == (6, 0)
    assert (again.n_computed, again.n_resumed) == (0, 6)
    assert [dataclasses.asdict(c) for c in again.cells] \
        == [dataclasses.asdict(c) for c in first.cells]


def test_content_hash_ignores_meta_and_matches_reference(tmp_path):
    """Run identity is path + non-meta lines in both packages: stamping a
    store does not change it, growing it does."""
    path = tmp_path / "arch" / "run-000.jsonl"
    store = ResultStore(path)
    Campaign(CampaignSpec([TestCase("bcast", 512)],
                          ExperimentDesign(n_launch_epochs=2, nrep=5)),
             _gate_backend(), store).run()
    port, ref = RunArchive(tmp_path / "arch"), ref_history.RunArchive(tmp_path / "arch")
    a = port.register(path, stamp=True)
    assert port.register(path).run_id == a.run_id        # the stamp is a meta line
    b = ref.register(path, stamp=False)
    assert b.run_id == a.run_id
    store.append_meta(note="x")
    assert ref.register(path).run_id == port.register(path).run_id == a.run_id
    Campaign(CampaignSpec([TestCase("bcast", 512), TestCase("allreduce", 512)],
                          ExperimentDesign(n_launch_epochs=2, nrep=5)),
             _gate_backend(), store).run()
    grown = port.register(path)
    assert grown.run_id != a.run_id and ref.register(path).run_id == grown.run_id
    assert port.new_store_path().name == "run-001.jsonl"


def _tables(cells):
    """The same per-epoch medians as a port and a reference ResultTable."""
    port = ResultTable(summaries=[
        EpochSummary(case=TestCase(op, m), epoch=e, mean=v, median=v, n_kept=1, n_raw=1)
        for (op, m), vals in cells.items() for e, v in enumerate(vals)])
    ref = RefTable(summaries=[
        RefSummary(case=RefCase(op, m), epoch=e, mean=v, median=v, n_kept=1, n_raw=1)
        for (op, m), vals in cells.items() for e, v in enumerate(vals)])
    return port, ref


@pytest.mark.parametrize("shift,n", [(1.0, 12), (1.3, 12), (1.02, 4), (0.85, 20)])
def test_audit_tables_equal_reference_on_synthetic_tables(shift, n):
    import numpy as np

    rng = np.random.default_rng(7)
    base = {("allreduce", 512): 10.0 + rng.normal(0, 0.2, n).round(6),
            ("bcast", 64): 5.0 + rng.normal(0, 0.1, n).round(6)}
    cand = {k: (v * (shift if k[0] == "bcast" else 1.0)).tolist() for k, v in base.items()}
    base = {k: v.tolist() for k, v in base.items()}
    (pb, rb), (pc, rc) = _tables(base), _tables(cand)
    a = audit_tables(pb, pc, seed=3)
    b = ref_history.audit_tables(rb, rc, seed=3)
    assert [dataclasses.asdict(c) for c in a.cells] == [dataclasses.asdict(c) for c in b.cells]
    assert format_audit_report(a) == ref_history.format_audit_report(b)
    assert DEFAULT_MARGIN == ref_history.DEFAULT_MARGIN


def test_audit_without_baseline_raises(tmp_path):
    path = tmp_path / "arch" / "run-000.jsonl"
    Campaign(CampaignSpec([TestCase("bcast", 512)], ExperimentDesign(n_launch_epochs=2, nrep=5)),
             _gate_backend(), ResultStore(path)).run()
    archive = RunArchive(tmp_path / "arch")
    with pytest.raises(LookupError, match="no baseline"):
        audit_runs(archive, archive.register(path))
