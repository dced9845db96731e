"""The port's factor grid, store lines and campaign windows, held against
the JAX package on the CPU: grid cells equal to the reference's, every
stock axis fingerprinted, sweep and calib lines that cross between the two
packages' stores both ways, and windowed campaigns bit-equal to the same
epochs of a full run.
"""

import json
from dataclasses import asdict

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.sweeps as ref_sweeps
from repro.campaign import ResultStore as RefStore
from repro.campaign import SimBackend
from repro_torch.campaign import (Campaign, CampaignSpec, ResultStore,
                                  SweepScheduler, SweepSpec, TorchSimBackend)
from repro_torch.campaign import backends as port_backends
from repro_torch.core import (ExperimentDesign, FactorAxis, FactorGrid,
                              TestCase, assert_comparable)
from repro_torch.core import factors as port_factors
from repro_torch.sweeps import MISTUNED_PER_OP_KW, default_sim_sweep, sim_axes

FAST_SYNC = dict(n_fitpts=60, n_exchanges=20)
CPU_AXES = tuple(ax.name for ax in sim_axes() if ax.name != "engine")


def _cell_view(cell):
    return (cell.index, cell.coords, cell.levels(),
            cell.overrides("backend"), cell.overrides("design"))


# ---------------------------------------------------------------------------
# Factor grid: exact against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fraction,design_seed", [(1.0, 0), (0.5, 3), (0.25, 3),
                                                  (0.3, 11)])
def test_grid_cells_equal_reference(fraction, design_seed):
    """Same axes, fraction and seed: the same cell indices (the seeded
    fractional sample included), coordinates, level labels and overrides.
    The engine axis is left out: its levels differ by design."""
    port = FactorGrid(sim_axes(CPU_AXES), design_seed=design_seed,
                      fraction=fraction)
    ref = ref_core.FactorGrid(ref_sweeps.sim_axes(CPU_AXES),
                              design_seed=design_seed, fraction=fraction)
    assert port.n_full() == ref.n_full() == 2 ** len(CPU_AXES)
    assert port.cell_indices() == ref.cell_indices()
    assert [_cell_view(c) for c in port.cells()] \
        == [_cell_view(c) for c in ref.cells()]
    assert port.manifest() == ref.manifest()


def test_axis_and_grid_validation():
    with pytest.raises(ValueError, match="at least 2 levels"):
        FactorAxis("a", (1,))
    with pytest.raises(ValueError, match="target"):
        FactorAxis("a", (1, 2), target="nowhere")
    with pytest.raises(ValueError, match="labels"):
        FactorAxis("a", (1, 2), labels=("x",))
    with pytest.raises(ValueError, match="distinct"):
        FactorAxis("a", ({}, {}), labels=("x", "x"))
    with pytest.raises(ValueError, match="same constructor field"):
        FactorGrid((FactorAxis("a", (1, 2), key="p"),
                    FactorAxis("b", (3, 4), key="p")))
    with pytest.raises(ValueError, match="fraction"):
        FactorGrid(sim_axes(("dtype",)), fraction=0.0)
    with pytest.raises(ValueError, match="unknown factor axes"):
        sim_axes(("dtype", "no_such_axis"))


def test_grid_cell_materializes_backend_and_design():
    grid = FactorGrid(sim_axes(("tuning", "shuffle")))
    base = TorchSimBackend(p=4, seed0=1, sync_kw=dict(FAST_SYNC), device="cpu")
    design = ExperimentDesign(n_launch_epochs=2, nrep=5, seed=1)
    backend, dsn = grid.cells()[-1].materialize(base, design)
    assert backend.per_op_kw == MISTUNED_PER_OP_KW and backend.device == "cpu"
    assert dsn.shuffle is False and design.shuffle is True
    assert base.per_op_kw == {}
    with pytest.raises(TypeError, match="no_such_field"):
        FactorGrid((FactorAxis("bogus", (1, 2), key="no_such_field"),
                    FactorAxis("dtype", ("float32", "float64")))
                   ).cells()[0].materialize(base, design)


@pytest.mark.parametrize("axis", CPU_AXES)
def test_each_stock_axis_reaches_the_fingerprint(axis):
    """Each stock axis's two levels give two fingerprints: per_op_kw and
    sync_kw through ``extra``, win_size as window_size_us, buffer_policy,
    epoch_isolation and dtype directly, shuffle through the design."""
    spec = SweepSpec(FactorGrid(sim_axes((axis,))), [TestCase("allreduce", 512)],
                     ExperimentDesign(n_launch_epochs=2, nrep=5))
    base = TorchSimBackend(p=4, sync_kw=dict(FAST_SYNC), device="cpu")
    fps = [fp for *_, fp in SweepScheduler(spec, base).compile()]
    assert len(fps) == len(set(fps)) == 2


def test_all_cpu_stock_axes_yield_distinct_fingerprints():
    spec, backend = default_sim_sweep(seed=0, axes=CPU_AXES, msizes=(512,),
                                      n_launch_epochs=3, nrep=20, device="cpu")
    fps = [fp for *_, fp in SweepScheduler(spec, backend).compile()]
    assert len(fps) == len(set(fps)) == 2 ** len(CPU_AXES)


def test_engine_axis_is_the_device_and_reaches_the_fingerprint(monkeypatch):
    """The engine axis runs the kernel (``device="cuda"``) against its
    plain version (``"cpu"``); the two levels differ in the device name
    and capability ``capture_torch_factors`` records. The card's side is
    stood in for here, where there is none."""
    (axis,) = sim_axes(("engine",))
    assert (axis.kwarg(), axis.levels, axis.labels) \
        == ("device", ("cuda", "cpu"), ("kernel", "plain"))
    assert "engine" not in ref_sweeps.DEFAULT_SWEEP_AXES
    monkeypatch.setattr(port_backends, "resolve_device", torch.device)
    monkeypatch.setattr(port_factors.torch.cuda, "get_device_capability",
                        lambda dev=None: (9, 0))
    monkeypatch.setattr(port_factors.torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    spec = SweepSpec(FactorGrid((axis,)), [TestCase("allreduce", 512)],
                     ExperimentDesign(n_launch_epochs=2, nrep=5))
    compiled = SweepScheduler(spec, TorchSimBackend(p=4, device="cpu")).compile()
    assert [b.device for _, b, *_ in compiled] == ["cuda", "cpu"]
    extras = [dict(f.extra) for *_, f, _ in compiled]
    assert [e["device_name"] for e in extras] == ["NVIDIA H100 80GB HBM3", "cpu"]
    assert len({fp for *_, fp in compiled}) == 2


def test_scheduler_rejects_fingerprint_collisions():
    """``fuse_epochs`` is an execution knob, not a factor: sweeping it
    would merge two cells under one store key, so compile refuses."""
    grid = FactorGrid((FactorAxis("fuse", (True, False), key="fuse_epochs"),
                       FactorAxis("dtype", ("float32", "float64"))))
    spec = SweepSpec(grid, [TestCase("allreduce", 256)], ExperimentDesign(2, 5))
    with pytest.raises(ValueError, match="share fingerprint"):
        SweepScheduler(spec, TorchSimBackend(p=4, device="cpu")).compile()


def test_assert_comparable_names_exactly_the_differing_factors():
    design = ExperimentDesign(n_launch_epochs=2, nrep=5)
    a = TorchSimBackend(p=4, device="cpu").factors(design)
    b = TorchSimBackend(p=4, device="cpu", dtype="float64").factors(design)
    assert_comparable(a, b, ("dtype",))
    with pytest.raises(ValueError, match="dtype"):
        assert_comparable(a, b, ("sync_method",))


# ---------------------------------------------------------------------------
# Store lines: the two packages read each other's sweep and calib lines
# ---------------------------------------------------------------------------

def _write_lines(store):
    """Sweep, allocation, quarantine and calibration lines through one
    package's store API; returns the ids."""
    sid = store.append_sweep(dict(axes=[dict(name="dtype")], cells=[[0, "f0", {}]]))
    assert store.append_sweep(dict(axes=[dict(name="dtype")],
                                   cells=[[0, "f0", {}]])) == sid
    store.append_sweep_cell(sid, 0, "f0")
    store.append_sweep_cell_failed(sid, 1, "f1", 3, "boom")
    store.append_sweep_alloc(sid, 0, [0, 1], (0, 1),
                             {"dtype": dict(verdict="null")}, 80, "racing")
    store.append_sweep_alloc(sid, 1, [0], (1, 2), {}, 120, "racing")
    store.append_sweep_alloc(sid, 1, [9], (1, 2), {}, 999, "racing")   # torn dup
    cid = store.append_calib(dict(name="x", space={"p": 1}))
    store.append_calib_round(cid, 0, {"op.alpha": np.float64(2e-6)}, 0.5, 0.25,
                             [[{"op.alpha": 2e-6}, 0.5]], 100)
    store.append_calib_round(cid, 1, {"op.alpha": 3e-6}, 0.3, 0.125, [], 200)
    store.append_calib_round(cid, 1, {"op.alpha": 9e-6}, 9.9, 0.9, [], 999)
    return sid, cid


def _read_lines(store, sid, cid):
    snap = store.snapshot()
    return dict(
        schema=store.schema_version(), sweeps=store.sweeps(),
        manifest=store.sweep_manifest(sid), last=store.sweep_manifest(),
        cells=store.sweep_cells(sid), failed=store.sweep_cells_failed(sid),
        allocs=store.sweep_allocs(sid), calib=store.calib_manifest(cid),
        rounds=store.calib_rounds(cid),
        snap=(snap.sweeps, snap.manifests, snap.sweep_cells_by_id,
              snap.sweep_failed_by_id, snap.sweep_alloc_by_id, snap.calibs,
              snap.calib_manifests, snap.calib_rounds_by_id))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_sweep_and_calib_lines_cross_between_packages(tmp_path, writer):
    path = tmp_path / "lines.jsonl"
    make = ResultStore if writer == "port" else RefStore
    sid, cid = _write_lines(make(path))
    port, ref = _read_lines(ResultStore(path), sid, cid), _read_lines(RefStore(path), sid, cid)
    assert port == ref
    assert [r["round"] for r in port["allocs"]] == [0, 1]
    assert port["allocs"][1]["spent_nrep"] == 120        # the first line wins
    assert port["rounds"][1]["objective"] == 0.3
    assert port["failed"] == {1: dict(fingerprint="f1", attempts=3, error="boom")}


def test_port_sweep_store_loads_in_reference(tmp_path):
    """A whole racing sweep written by the port: the reference reads its
    manifest, completed cells, allocation rounds and records."""
    path = tmp_path / "race.jsonl"
    spec, backend = default_sim_sweep(seed=0, axes=("tuning", "dtype"),
                                      n_launch_epochs=4, nrep=20, device="cpu")
    res = SweepScheduler(spec, backend, ResultStore(path), policy="racing").run()
    port, ref = ResultStore(path), RefStore(path)
    sid = res.sweep_id
    assert ref.sweeps() == port.sweeps() == [sid]
    assert ref.sweep_manifest(sid) == port.sweep_manifest(sid)
    assert ref.sweep_cells(sid) == port.sweep_cells(sid) \
        == {c.cell.index: c.fingerprint for c in res.cells}
    assert ref.sweep_allocs(sid) == port.sweep_allocs(sid)
    for c in res.cells:
        a, b = ref.records(c.fingerprint), port.records(c.fingerprint)
        assert [(r.case.key(), r.epoch) for r in a] == [(r.case.key(), r.epoch) for r in b]
        assert all(np.array_equal(x.times, y.times) for x, y in zip(a, b))


def test_snapshot_completed_and_schema(tmp_path):
    store = ResultStore(tmp_path / "c.jsonl")
    assert store.schema_version() == 1
    res = Campaign(CampaignSpec([TestCase("bcast", 512)],
                                ExperimentDesign(n_launch_epochs=2, nrep=5)),
                   TorchSimBackend(p=4, sync_kw=dict(FAST_SYNC), device="cpu"),
                   store).run()
    assert store.snapshot().completed(res.fingerprint) \
        == store.completed(res.fingerprint) == {("bcast", 512, 0), ("bcast", 512, 1)}
    first = json.loads(store.path.read_text().splitlines()[0])
    assert first == {"kind": "schema", "version": 1}


# ---------------------------------------------------------------------------
# Campaign windows
# ---------------------------------------------------------------------------

def _window_spec():
    return CampaignSpec([TestCase("allreduce", 512), TestCase("bcast", 4096)],
                        ExperimentDesign(n_launch_epochs=6, nrep=30, seed=4))


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("windows", [[(0, 1), (1, 3), (3, 6)], [(2, 5), (0, 2), (5, 6)]])
def test_windowed_campaign_equals_full_run_bit_for_bit(fuse, windows):
    """Epochs ``[lo, hi)`` measured as a window give the same records as
    those epochs of a full run, bit for bit, in any window order; the
    fused path gets only the window's work."""
    def backend():
        return TorchSimBackend(p=8, seed0=2, sync_kw=dict(FAST_SYNC), device="cpu",
                               fuse_epochs=fuse)

    full = {(r.case, r.epoch): r for r in Campaign(_window_spec(), backend()).run().records}
    got = {}
    for lo, hi in windows:
        seen = []
        b = backend()
        if fuse:
            measure_epochs = b.measure_epochs
            b.measure_epochs = lambda work, design: (seen.append(sorted(work)),
                                                     measure_epochs(work, design))[1]
        res = Campaign(_window_spec(), b).run(epochs=range(lo, hi))
        assert sorted({r.epoch for r in res.records}) == list(range(lo, hi))
        assert seen == ([list(range(lo, hi))] if fuse else [])
        got.update({(r.case, r.epoch): r for r in res.records})
    assert got.keys() == full.keys()
    for key, rec in full.items():
        assert np.array_equal(got[key].times, rec.times), key
        assert got[key].meta["fused"] == rec.meta["fused"] == fuse


def test_windowed_runs_through_a_store_resume_into_the_full_run(tmp_path):
    """Window by window into one store, then the full campaign resumes
    every record and the file equals an uninterrupted run's byte for byte."""
    backend = TorchSimBackend(p=8, seed0=2, sync_kw=dict(FAST_SYNC), device="cpu")
    whole = tmp_path / "whole.jsonl"
    Campaign(_window_spec(), backend, ResultStore(whole)).run()
    parts = tmp_path / "parts.jsonl"
    fired = []
    for lo, hi in ((0, 2), (2, 6)):
        Campaign(_window_spec(), backend, ResultStore(parts)).run(
            epochs=range(lo, hi), on_record=fired.append)
    assert len(fired) == 12
    assert sorted({r.epoch for r in fired}) == list(range(6))
    res = Campaign(_window_spec(), backend, ResultStore(parts)).run(on_record=fired.append)
    assert (res.n_measured, res.n_resumed, len(fired)) == (0, 12, 12)
    assert parts.read_bytes() == whole.read_bytes()


def test_campaign_window_outside_the_design_raises():
    backend = TorchSimBackend(p=4, sync_kw=dict(FAST_SYNC), device="cpu")
    with pytest.raises(ValueError, match="outside the design"):
        Campaign(_window_spec(), backend).run(epochs=[5, 6])


def test_reference_backend_fields_still_match():
    """The stock sweep's base backend has the reference's fields and
    knobs (p, seed0, sync and op overrides), with the device beside them."""
    spec, backend = default_sim_sweep(seed=5, p=6, device="cpu")
    ref_spec, ref_backend = ref_sweeps.default_sim_sweep(seed=5, p=6)
    assert isinstance(ref_backend, SimBackend)
    for f in ("p", "seed0", "op_kw", "per_op_kw", "sync_name", "sync_kw", "win_size"):
        assert getattr(backend, f) == getattr(ref_backend, f), f
    assert backend.device == "cpu"
    assert [(c.op, c.msize) for c in spec.cases] \
        == [(c.op, c.msize) for c in ref_spec.cases]
    assert asdict(spec.design) == asdict(ref_spec.design)
    assert spec.name == ref_spec.name
    assert spec.grid.manifest() == ref_spec.grid.manifest()
