"""The port's factor sweeps and budgeted allocation, held against the JAX
package on the CPU.

Exact where both packages get the same numbers in: effects, decisions,
interaction screens and reports computed from one store read by each
package's loader, and allocation states, plans and decisions replayed
from a racing sweep the reference wrote. Live runs are held as verdicts:
the racing smoke sweep reproduces ``benchmarks/reference_sweep_verdicts.json``,
survives a kill at every round boundary, and equals itself on two
spawned workers.

Run as a script, it prints both packages' stock-sweep rankings at a
chosen width (``python tests/test_torch_sweeps.py --p 512 --nrep 2000``).
"""

import json
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

import repro.sweeps as ref_sweeps
import repro.sweeps.alloc as ref_alloc
import repro_torch.sweeps as port_sweeps
from repro.campaign import ResultStore as RefStore
from repro.campaign import SweepScheduler as RefScheduler
from repro_torch.campaign import ResultStore, SweepScheduler
from repro_torch.core import NREP_SPENT
from repro_torch.sweeps import (alpha_spending, axis_decisions,
                                cells_from_result, cells_from_store,
                                default_sim_sweep, format_factor_report,
                                interaction_screen, main_effects, make_policy,
                                quantile_distance)
from repro_torch.sweeps.alloc import build_state

ROOT = Path(__file__).resolve().parents[1]
SMOKE_AXES = ("tuning", "dtype")
REFERENCE_VERDICTS = json.loads(
    (ROOT / "benchmarks" / "reference_sweep_verdicts.json").read_text())["axes"]


def _cells_view(cells):
    return [(c.index, c.levels, {k: v.tolist() for k, v in c.medians.items()})
            for c in cells]


def _tables(res):
    return {c.cell.index: sorted((s.case.op, s.case.msize, s.epoch, s.mean, s.median,
                                  s.n_kept, s.n_raw) for s in c.table.summaries)
            for c in res.cells}


@pytest.fixture(scope="module")
def port_sweep_store(tmp_path_factory):
    """A uniform port sweep over three axes, persisted."""
    path = tmp_path_factory.mktemp("sweep") / "sweep.jsonl"
    spec, backend = default_sim_sweep(seed=1, axes=("tuning", "sync_method", "dtype"),
                                      n_launch_epochs=4, nrep=20, device="cpu")
    res = SweepScheduler(spec, backend, ResultStore(path)).run()
    return path, res


# ---------------------------------------------------------------------------
# Exact against the reference on the same inputs
# ---------------------------------------------------------------------------

def test_cells_from_store_equal_reference(port_sweep_store):
    path, res = port_sweep_store
    port = cells_from_store(ResultStore(path))
    assert _cells_view(port) == _cells_view(ref_sweeps.cells_from_store(RefStore(path)))
    assert _cells_view(port) == _cells_view(cells_from_result(res))


def test_effects_interactions_and_report_equal_reference(port_sweep_store):
    path, _ = port_sweep_store
    port_cells = cells_from_store(ResultStore(path))
    ref_cells = ref_sweeps.cells_from_store(RefStore(path))
    effects, ref_effects = main_effects(port_cells), ref_sweeps.main_effects(ref_cells)
    assert [asdict(e) for e in effects] == [asdict(e) for e in ref_effects]
    inter = interaction_screen(port_cells)
    ref_inter = ref_sweeps.interaction_screen(ref_cells)
    assert [asdict(e) for e in inter] == [asdict(e) for e in ref_inter]
    assert format_factor_report(effects, inter, title="t") \
        == ref_sweeps.format_factor_report(ref_effects, ref_inter, title="t")
    assert effects[0].axis == "tuning" and effects[0].significant


@pytest.mark.parametrize("look", [0, 1, 2, 4])
def test_axis_decisions_equal_reference(port_sweep_store, look):
    path, _ = port_sweep_store
    port = axis_decisions(cells_from_store(ResultStore(path)), look=look, n_min_null=12)
    ref = ref_sweeps.axis_decisions(ref_sweeps.cells_from_store(RefStore(path)),
                                    look=look, n_min_null=12)
    assert {k: asdict(v) for k, v in port.items()} == {k: asdict(v) for k, v in ref.items()}
    assert alpha_spending(0.05, look) == ref_sweeps.alpha_spending(0.05, look)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantile_distance_equal_reference(seed):
    rng = np.random.default_rng(seed)
    a, b = rng.lognormal(0, 0.3, 17), rng.lognormal(0.1, 0.2, 23)
    for q in (ref_sweeps.DEFAULT_QUANTILES, (0.5,), (0.05, 0.95)):
        assert quantile_distance(a, b, q) == ref_sweeps.quantile_distance(a, b, q)
    with pytest.raises(ValueError, match="positive"):
        quantile_distance(a, -b)
    with pytest.raises(ValueError, match="empty"):
        quantile_distance(a, np.empty(0))


@pytest.mark.parametrize("name,kw", [("uniform", {}), ("racing", {}),
                                     ("racing", dict(nrep_budget=500)),
                                     ("successive_halving", dict(n_min_null=6))])
def test_policy_manifests_equal_reference(name, kw):
    assert make_policy(name, **kw).manifest() == ref_sweeps.make_policy(name, **kw).manifest()


def _state_view(state):
    return (state.axes, state.cell_levels, _cells_view(state.cells), state.decided,
            state.round, state.spent_nrep, state.n_epochs_max, state.active_cells())


@pytest.fixture(scope="module", params=["racing", "successive_halving"])
def reference_race_store(request, tmp_path_factory):
    """A budgeted sweep the reference wrote with its own engine at p = 4."""
    path = tmp_path_factory.mktemp("ref_race") / f"{request.param}.jsonl"
    spec, backend = ref_sweeps.default_sim_sweep(seed=0, axes=SMOKE_AXES, p=4,
                                                 n_launch_epochs=6, nrep=30)
    assert backend.engine == "auto"
    res = RefScheduler(spec, backend, RefStore(path), policy=request.param).run()
    return request.param, path, res


def test_allocation_replays_a_reference_racing_store(reference_race_store, tmp_path):
    """At every line boundary around each persisted round, the port's
    ``build_state`` equals the reference's on the same truncated store, and
    so do ``plan_round`` and ``decide``; the decisions equal the ones the
    reference persisted."""
    name, path, res = reference_race_store
    policy, ref_policy = make_policy(name), ref_sweeps.make_policy(name)
    sid = res.sweep_id
    lines = path.read_text().splitlines(keepends=True)
    allocs = [i for i, ln in enumerate(lines) if json.loads(ln)["kind"] == "sweep-alloc"]
    assert len(allocs) == res.meta["alloc"]["n_rounds"] >= 2
    manifest = RefStore(path).sweep_manifest(sid)
    n_max = 6                           # the design's n_launch_epochs
    for cut in sorted({i for a in allocs for i in (a, a + 1)}):
        part = tmp_path / f"cut{cut}.jsonl"
        part.write_text("".join(lines[:cut]))
        state = build_state(manifest, ResultStore(part).snapshot(), sid, n_max)
        ref_state = ref_alloc.build_state(manifest, RefStore(part).snapshot(), sid, n_max)
        assert _state_view(state) == _state_view(ref_state), cut
        plan, ref_plan = policy.plan_round(state), ref_policy.plan_round(ref_state)
        assert (asdict(plan) if plan else None) == (asdict(ref_plan) if ref_plan else None)
        decisions = {k: asdict(v) for k, v in policy.decide(state).items()}
        assert decisions == {k: asdict(v) for k, v in ref_policy.decide(ref_state).items()}
        if cut in allocs:               # the round's records are in, its line not yet
            persisted = json.loads(lines[cut])["decisions"]
            assert json.loads(json.dumps(decisions)) == persisted, cut


# ---------------------------------------------------------------------------
# Live on the CPU: verdicts, resume, workers
# ---------------------------------------------------------------------------

def _race(path, **kw):
    spec, backend = default_sim_sweep(seed=0, axes=SMOKE_AXES, device="cpu")
    return SweepScheduler(spec, backend, ResultStore(path), policy="racing", **kw).run()


@pytest.fixture(scope="module")
def racing_smoke(tmp_path_factory):
    path = tmp_path_factory.mktemp("race") / "race.jsonl"
    return path, _race(path)


def test_racing_smoke_sweep_reproduces_the_reference_verdicts(racing_smoke):
    """The reference's smoke spec (``sweep --axes tuning,dtype --policy
    racing``, seed 0, p = 8) on ``TorchSimBackend(device="cpu")``."""
    path, res = racing_smoke
    alloc = res.meta["alloc"]
    assert alloc["decisions"] == REFERENCE_VERDICTS
    assert alloc["undecided"] == []
    assert alloc["savings"] >= 1.4 and alloc["spent_nrep"] < alloc["uniform_nrep"]
    lines = ResultStore(path).sweep_allocs(res.sweep_id)
    assert [ln["round"] for ln in lines] == list(range(alloc["n_rounds"]))
    assert lines[-1]["spent_nrep"] == alloc["spent_nrep"]


def test_racing_replay_from_the_store_measures_nothing(racing_smoke, tmp_path):
    path, res = racing_smoke
    copy = tmp_path / "copy.jsonl"
    copy.write_bytes(path.read_bytes())
    spent = NREP_SPENT.read()
    again = _race(copy)
    assert NREP_SPENT.read() == spent and again.n_cells_measured == 0
    assert again.meta["alloc"]["decisions"] == res.meta["alloc"]["decisions"]
    assert _tables(again) == _tables(res)
    assert copy.read_bytes() == path.read_bytes()


@pytest.mark.parametrize("after_round", [0, 1])
def test_racing_kill_resume_lands_on_the_same_sweep(racing_smoke, tmp_path, after_round):
    """Killed right after round k's allocation line, the resumed sweep
    replays the persisted verdicts and ends byte-identical to the
    uninterrupted store."""
    path, res = racing_smoke
    lines = path.read_text().splitlines(keepends=True)
    allocs = [i for i, ln in enumerate(lines) if json.loads(ln)["kind"] == "sweep-alloc"]
    killed = tmp_path / "killed.jsonl"
    killed.write_text("".join(lines[:allocs[after_round] + 1]))
    resumed = _race(killed)
    assert resumed.meta["alloc"]["decisions"] == REFERENCE_VERDICTS
    assert _tables(resumed) == _tables(res)
    assert killed.read_bytes() == path.read_bytes()


def test_sharded_sweep_equals_serial_bit_for_bit(tmp_path):
    """Two spawned workers measure whole cells; the parent persists them.
    Per-cell tables equal the serial run's, bit for bit."""
    spec, backend = default_sim_sweep(seed=2, axes=("tuning",), msizes=(512,),
                                      n_launch_epochs=3, nrep=20, device="cpu")
    serial = SweepScheduler(spec, backend, ResultStore(tmp_path / "s.jsonl")).run()
    sharded = SweepScheduler(spec, backend, ResultStore(tmp_path / "p.jsonl"),
                             n_workers=2).run()
    assert sharded.meta["n_workers"] == 2 and sharded.n_cells_measured == 2
    assert _tables(sharded) == _tables(serial)
    assert ResultStore(tmp_path / "p.jsonl").sweep_cells(sharded.sweep_id) \
        == ResultStore(tmp_path / "s.jsonl").sweep_cells(serial.sweep_id)


def test_uniform_sweep_resume_measures_nothing(port_sweep_store, tmp_path):
    path, res = port_sweep_store
    copy = tmp_path / "copy.jsonl"
    copy.write_bytes(path.read_bytes())
    spec, backend = default_sim_sweep(seed=1, axes=("tuning", "sync_method", "dtype"),
                                      n_launch_epochs=4, nrep=20, device="cpu")
    spent = NREP_SPENT.read()
    again = SweepScheduler(spec, backend, ResultStore(copy)).run()
    assert NREP_SPENT.read() == spent
    assert (again.n_cells_measured, again.n_cells_resumed) == (0, len(res.cells))
    assert _tables(again) == _tables(res)


def test_stock_sweep_ranks_the_injected_defect_first_and_dtype_null():
    """The default four axes at the stock p = 8: the seeded mis-tuning
    ranks first; dtype, a label, draws the same numbers at both levels."""
    spec, backend = default_sim_sweep(seed=0, device="cpu")
    effects = main_effects(cells_from_result(SweepScheduler(spec, backend).run()))
    assert effects[0].axis == "tuning" and effects[0].significant
    (dtype,) = [e for e in effects if e.axis == "dtype"]
    assert not dtype.significant and dtype.p_holm == 1.0 and dtype.effect_size == 0.0


def test_budgeted_sweep_requires_a_store_and_cases():
    spec, backend = default_sim_sweep(seed=0, axes=SMOKE_AXES, device="cpu")
    with pytest.raises(ValueError, match="store"):
        SweepScheduler(spec, backend, policy="racing").run()


if __name__ == "__main__":
    import argparse
    import time
    import warnings

    ap = argparse.ArgumentParser(description="both packages' stock-sweep "
                                 "factor reports at one width, on the CPU")
    ap.add_argument("--p", type=int, default=512)
    ap.add_argument("--nrep", type=int, default=2000)
    args = ap.parse_args()
    warnings.simplefilter("ignore")
    for name, mod, scheduler, kw in (
            ("reference", ref_sweeps, RefScheduler, {}),
            ("port", port_sweeps, SweepScheduler, dict(device="cpu"))):
        t = time.perf_counter()
        spec, backend = mod.default_sim_sweep(seed=0, p=args.p, nrep=args.nrep, **kw)
        res = scheduler(spec, backend).run()
        print(mod.format_factor_report(mod.main_effects(mod.cells_from_result(res)),
                                       title=f"{name} p={args.p} nrep={args.nrep}"))
        print(f"# {name}: {time.perf_counter() - t:.1f} s")
