"""The PGMPI guideline family on the port's simulated campaign
(``SIM_GUIDELINES`` through ``TorchSimBackend(device="cpu")``), held
against the JAX package's ``SimBackend`` on the reference's own specs
(``tests/test_guidelines.py``): an honest library holds all ten cells
``holds(<)``, each seeded mis-tuning is flagged by exactly its
guideline, and a verification resumes from its store.

Verdict strings must equal the reference's on every spec. The ratios are
held statistically: the port draws its noise from torch generators, not
JAX's or numpy's, so a cell's ratio of per-epoch medians must lie within
±10% of the reference's (the audit's TOST margin), not equal it.

Run as a script, it prints both packages' verdicts on the three specs at
a chosen width, with the stock sync settings the card's smoke run uses
(``python tests/test_torch_sim_guidelines.py --p 512 --nrep 10000``).
"""

import pytest

from repro.campaign import SimBackend
from repro.core import ExperimentDesign as RefDesign
from repro.guidelines import SIM_GUIDELINES as REF_SIM_GUIDELINES
from repro.guidelines import Guideline as RefGuideline
from repro.guidelines import verify_guidelines as ref_verify
from repro_torch.campaign import ResultStore, TorchSimBackend
from repro_torch.core import ExperimentDesign
from repro_torch.guidelines import (SIM_GUIDELINES, Guideline, format_report,
                                    format_violations, verify_guidelines)

FAST_SYNC = dict(n_fitpts=100, n_exchanges=20)
RATIO_BOUND = 0.10        # |port ratio / reference ratio - 1|

MOCK = dict(name="alltoall_mock_bound", lhs="alltoall",
            rhs="allreduce*2+bcast*2",
            description="mock-up bound: alltoall ⪯ allreduce(2m)+bcast(2m)")
INFLATED_ALLTOALL = {"alltoall": dict(alpha=12e-6, gamma=10e-6)}
INFLATED_ALLGATHER = {"allgather": dict(alpha=9e-6, gamma=8e-6)}


def _sim(seed0=0, p=8, **kw):
    kw.setdefault("sync_kw", dict(FAST_SYNC))
    return TorchSimBackend(p=p, seed0=seed0, device="cpu", **kw)


def _design(cls=ExperimentDesign):
    return cls(n_launch_epochs=8, nrep=25, seed=5)


def _both(seed0, msizes, per_op_kw=None, mock=False, p=8, nrep=25, seed=5,
          sync_kw=FAST_SYNC):
    """The same spec through the port and through the reference."""
    per_op_kw = per_op_kw or {}
    port_gls = list(SIM_GUIDELINES) + ([Guideline(**MOCK)] if mock else [])
    ref_gls = list(REF_SIM_GUIDELINES) + ([RefGuideline(**MOCK)] if mock else [])
    design = dict(n_launch_epochs=8, nrep=nrep, seed=seed)
    kw = dict(p=p, seed0=seed0, per_op_kw=per_op_kw)
    if sync_kw is not None:
        kw["sync_kw"] = dict(sync_kw)
    port = verify_guidelines(port_gls, TorchSimBackend(device="cpu", **kw),
                             design=ExperimentDesign(**design), msizes=msizes)
    ref = ref_verify(ref_gls, SimBackend(**kw), design=RefDesign(**design),
                     msizes=msizes)
    return port, ref


def _held_against_reference(port, ref):
    assert [(v.guideline.name, v.msize) for v in port.verdicts] \
        == [(v.guideline.name, v.msize) for v in ref.verdicts]
    assert [v.verdict for v in port.verdicts] == [v.verdict for v in ref.verdicts]
    for a, b in zip(port.verdicts, ref.verdicts):
        assert abs(a.ratio / b.ratio - 1.0) <= RATIO_BOUND, \
            (a.guideline.name, a.msize, a.ratio, b.ratio)


def test_honest_sim_library_passes_all_guidelines():
    port, ref = _both(seed0=2, msizes=(1024, 8192))
    assert len(port.verdicts) == 10
    assert port.ok and not port.violations()
    # every family holds with positive evidence, not mere non-refutation
    assert all(v.verdict == "holds(<)" for v in port.verdicts)
    assert "all 10 cells hold" in format_report(port)
    assert format_violations(port) == ""
    _held_against_reference(port, ref)


def test_seeded_violation_inflated_alltoall_is_flagged():
    """An inflated alltoall breaks the mock-up guideline that bounds
    alltoall from above, and only that guideline."""
    honest, honest_ref = _both(seed0=4, msizes=(1024,), mock=True)
    assert honest.ok
    _held_against_reference(honest, honest_ref)

    seeded, seeded_ref = _both(seed0=4, msizes=(1024,),
                               per_op_kw=INFLATED_ALLTOALL, mock=True)
    bad = seeded.violations()
    assert [v.guideline.name for v in bad] == ["alltoall_mock_bound"]
    v = bad[0]
    assert v.verdict == "VIOLATED" and v.ratio > 1.0
    assert v.p_violated <= v.p_holm <= 0.05
    assert "alltoall_mock_bound" in format_violations(seeded)
    _held_against_reference(seeded, seeded_ref)


def test_seeded_violation_inflated_allgather_breaks_pattern_containment():
    port, ref = _both(seed0=6, msizes=(1024,), per_op_kw=INFLATED_ALLGATHER)
    assert {v.guideline.name for v in port.violations()} \
        == {"allgather_pat_alltoall"}
    _held_against_reference(port, ref)


def test_guideline_campaign_resumes_from_store(tmp_path):
    store = ResultStore(tmp_path / "g.jsonl")
    first = verify_guidelines(SIM_GUIDELINES, _sim(seed0=8),
                              design=_design(), msizes=(1024,), store=store)
    assert first.n_measured > 0 and first.n_resumed == 0
    again = verify_guidelines(SIM_GUIDELINES, _sim(seed0=8),
                              design=_design(), msizes=(1024,), store=store)
    assert again.n_measured == 0
    assert again.n_resumed == first.n_measured
    assert [v.verdict for v in again.verdicts] == \
        [v.verdict for v in first.verdicts]
    for a, b in zip(first.verdicts, again.verdicts):
        assert a.lhs_us == b.lhs_us and a.ratio == b.ratio
        assert a.p_violated == b.p_violated


def test_killed_guideline_campaign_resumes_missing_cells_only(tmp_path):
    """A campaign killed mid-write: half the record lines plus a torn tail.
    Resume warns about the torn line, re-measures only the missing cells,
    and reaches the uninterrupted run's verdicts (the epoch cut in half is
    measured afresh, so its numbers differ)."""
    path = tmp_path / "g.jsonl"
    full = verify_guidelines(SIM_GUIDELINES, _sim(seed0=9),
                             design=_design(), msizes=(1024,),
                             store=ResultStore(path))
    lines = path.read_text().splitlines()
    n_keep = 2 + (len(lines) - 2) // 2      # schema + declaration + half
    killed = tmp_path / "killed.jsonl"
    killed.write_text("\n".join(lines[:n_keep]) + "\n"
                      + '{"kind": "record", "fingerprint": "'[:40])
    with pytest.warns(RuntimeWarning, match="undecodable"):
        resumed = verify_guidelines(SIM_GUIDELINES, _sim(seed0=9),
                                    design=_design(), msizes=(1024,),
                                    store=ResultStore(killed))
    assert resumed.n_resumed == n_keep - 2
    assert resumed.n_resumed + resumed.n_measured == full.n_measured
    assert resumed.ok
    assert [v.verdict for v in resumed.verdicts] == \
        [v.verdict for v in full.verdicts]


if __name__ == "__main__":
    import argparse
    import time

    ap = argparse.ArgumentParser(description="both packages' guideline "
                                 "verdicts at one width, on the CPU")
    ap.add_argument("--p", type=int, default=512)
    ap.add_argument("--nrep", type=int, default=10_000)
    args = ap.parse_args()
    for name, msizes, per_op_kw, mock in (
            ("honest", (1024, 8192), {}, False),
            ("alltoall", (1024,), INFLATED_ALLTOALL, True),
            ("allgather", (1024,), INFLATED_ALLGATHER, False)):
        t = time.perf_counter()
        port, ref = _both(0, msizes, per_op_kw, mock, p=args.p, nrep=args.nrep,
                          seed=0, sync_kw=None)
        print(f"# {name} p={args.p} nrep={args.nrep}: "
              f"{time.perf_counter() - t:.1f} s for both")
        for a, b in zip(port.verdicts, ref.verdicts):
            print(f"{name:9s} {a.guideline.name:28s} {a.msize:5d}  port "
                  f"{a.verdict:8s} ratio {a.ratio:.4f} Holm p {a.p_holm:.3g} "
                  f"p(<) {a.p_confirmed:.3g}  reference {b.verdict:8s} ratio "
                  f"{b.ratio:.4f} Holm p {b.p_holm:.3g} p(<) {b.p_confirmed:.3g}")
