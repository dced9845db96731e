"""The port's public window call, op names, and the five reference
walkthroughs (``examples/*_torch.py``) held against the JAX package on
the CPU.

``repro_torch.core.run_windowed`` is the public face of the device engine:
bit-equal to ``run_windowed_torch`` from the same state, and, noise-free,
the reference's ``batch`` campaign on affine clocks and its ``batch_rw``
campaign on walking clocks at ``tests/test_batch_equivalence.py``'s
bounds. ``format_opexpr`` and ``OP_LIBRARY`` equal the reference's.

Each simulated walkthrough runs in this process with ``device="cpu"``, at
the reference's own sizes (no cut: each takes seconds), against the
reference script run as a subprocess. The clocks and the sync run in
numpy in both packages, so quickstart's two HCA lines are equal to the
printed digit; the durations are drawn with Philox in the port and with
numpy in the reference, so the rest is held by verdict, not by value.
``examples/compare_impls.py`` is not run (it jits Pallas in interpret
mode for minutes): the port's ``compare_impls_torch`` runs both arms'
plain version here and is held to two rows under the reference's table
header.
"""

import copy
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import OP_LIBRARY as REF_OP_LIBRARY
from repro.core import ClockParams as RefClockParams
from repro.core import SimNet as RefNet
from repro.core import format_comparison as ref_format_comparison
from repro.core import format_opexpr as ref_format_opexpr
from repro.core import make_op as ref_make_op
from repro.core import make_sync as ref_make_sync
from repro.core import parse_opexpr as ref_parse_opexpr
from repro.core import run_windowed as ref_run_windowed
from repro.guidelines import KERNEL_GUIDELINES as REF_KERNEL_GUIDELINES
from repro.guidelines import SIM_GUIDELINES as REF_SIM_GUIDELINES
from repro_torch.convert import (net_from_reference, op_from_reference,
                                 sync_from_reference)
from repro_torch.core import (OP_LIBRARY, ClockParams, SimNet, format_opexpr,
                              make_op, make_sync, parse_opexpr, run_windowed)
from repro_torch.simengine import run_windowed_torch

ROOT = Path(__file__).resolve().parents[1]
NOISE_FREE = dict(noise_sigma=0.0, tail_prob=0.0, spike_prob=0.0,
                  rank_imbalance=0.0, epoch_bias_sigma=0.0, autocorr=0.0)
RUN_FIELDS = ("times", "errors", "start_global_est", "end_global_est",
              "start_true", "end_true")


def _load(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reference(name: str) -> str:
    """``examples/<name>.py``'s standard output."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / f"{name}.py")],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


def _rows(text: str, verdicts: str) -> list:
    """(first column, second column, verdict) of each table row whose last
    column matches ``verdicts``."""
    out = []
    for line in text.splitlines():
        cols = line.split()
        if len(cols) > 3 and not line.startswith("#") and re.fullmatch(verdicts, cols[-1]):
            out.append((cols[0], cols[1], cols[-1]))
    return out


def _line(text: str, prefix: str) -> str:
    (line,) = [ln for ln in text.splitlines() if ln.startswith(prefix)]
    return line


def _ref_synced(seed, p, rw_sigma=0.0):
    net = RefNet(p, seed=seed, clocks=RefClockParams(rw_sigma=rw_sigma))
    return net, ref_make_sync("hca", n_fitpts=100, n_exchanges=20).synchronize(net)


# ---------------------------------------------------------------------------
# run_windowed, format_opexpr, OP_LIBRARY
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rw_sigma", [0.0, 1e-7])
def test_run_windowed_is_the_engine_bit_for_bit(rw_sigma):
    """From the same state, with live noise, the public call and the engine
    give the same run and leave the same simulator state."""
    net = SimNet(8, seed=3, clocks=ClockParams(rw_sigma=rw_sigma))
    sync = make_sync("hca", n_fitpts=100, n_exchanges=20).synchronize(net)
    op = make_op("alltoall")
    net2, sync2, op2 = copy.deepcopy((net, sync, op))
    a = run_windowed(net, sync, op, 4096, 300, 300e-6, device="cpu")
    b = run_windowed_torch(net2, sync2, op2, 4096, 300, 300e-6, device="cpu")
    for k in RUN_FIELDS:
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert np.array_equal(net.t, net2.t)
    assert a.times.size == 300 and np.isfinite(a.times).all()


@pytest.mark.parametrize("rw_sigma,engine,win", [(0.0, "batch", 300e-6),
                                                 (1e-7, "batch_rw", 300e-6),
                                                 (1e-7, "batch_rw", 12e-6)])
def test_run_windowed_exact_against_reference_when_noise_free(rw_sigma, engine, win):
    """Noise-free, the port's public call computes the reference's
    ``run_windowed`` campaign from the same carried state (affine clocks
    against ``batch``, walking clocks against ``batch_rw`` on frozen drift
    paths), at ``tests/test_batch_equivalence.py``'s bounds: equal flags,
    times and stamps within 1e-12, the same ``net.t``. The 12 us window
    sets both flags."""
    net_a, sync_a = _ref_synced(5, 16, rw_sigma)
    if rw_sigma:
        net_a.freeze_drift_paths(win)
    op_a = ref_make_op("allreduce", **NOISE_FREE)
    net_b, sync_b = net_from_reference(net_a), sync_from_reference(sync_a)
    op_b = op_from_reference(op_a)
    nrep = 300 if rw_sigma else 400
    a = ref_run_windowed(net_a, sync_a, op_a, 4096, nrep, win, engine=engine)
    b = run_windowed(net_b, sync_b, op_b, 4096, nrep, win, device="cpu")
    assert np.array_equal(a.errors, b.errors)
    for k in RUN_FIELDS[2:] + ("times",):
        np.testing.assert_allclose(getattr(b, k), getattr(a, k), rtol=0, atol=1e-12)
    np.testing.assert_allclose(net_b.t, net_a.t, rtol=0, atol=1e-12)
    if win < 100e-6:
        assert np.count_nonzero(a.errors & 1) and np.count_nonzero(a.errors & 2)


def test_run_windowed_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = SimNet(4, seed=3)
    sync = make_sync("hca", n_fitpts=60, n_exchanges=20).synchronize(net)
    state = net.t.copy()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_windowed(net, sync, make_op("bcast"), 256, 10, 400e-6)
    assert np.array_equal(net.t, state)


def _expressions():
    exprs = {"bcast", "alltoall*4", "allreduce@half+allreduce@half",
             "flash_attention#cuda+ssd_scan#ref", "bcast*0.5@half#ref"}
    for g in REF_SIM_GUIDELINES + REF_KERNEL_GUIDELINES:
        exprs.update((g.lhs, g.rhs))
    return sorted(exprs)


@pytest.mark.parametrize("expr", _expressions())
def test_format_opexpr_equals_reference(expr):
    """The canonical spelling of every expression of the guideline
    families (and a few with the three modifiers) is the reference's."""
    got = format_opexpr(parse_opexpr(expr))
    assert got == ref_format_opexpr(ref_parse_opexpr(expr))
    assert format_opexpr(parse_opexpr(got)) == got


def test_op_library_equals_reference():
    assert OP_LIBRARY == REF_OP_LIBRARY
    assert all(make_op(name).name == name for name in OP_LIBRARY)


# ---------------------------------------------------------------------------
# The walkthroughs
# ---------------------------------------------------------------------------

def test_quickstart_walkthrough(capsys):
    """The same two HCA lines to the printed digit; a windowed run with no
    invalid observation below the skewed barrier's mean; both Wilcoxon rows
    ``A<B``, as in the reference."""
    res = _load("quickstart_torch").walkthrough(device="cpu")
    out = capsys.readouterr().out
    ref = _reference("quickstart")
    assert res["hca"] == ref.splitlines()[:2]
    assert out.splitlines()[:2] == res["hca"]
    assert res["invalid_fraction"] == 0.0
    assert 0 < res["windowed_mean"] < res["barrier_mean"]
    want = [("allreduce", "256", "A<B"), ("allreduce", "4096", "A<B")]
    assert _rows(ref, r"A<B|A>B|~") == want
    assert _rows(out, r"A<B|A>B|~") == want
    assert [r.verdict for r in res["rows"]] == ["A<B", "A<B"]


def test_quickstart_batch_engine_prints_the_reference_s_lines(capsys):
    """``--engine batch`` draws as the reference does: on the CPU every
    printed line is the reference's, the window's and the barrier's means
    and the comparison table included, but for the store fingerprint (the
    factor sets differ between the packages)."""
    _load("quickstart_torch").main(["--device", "cpu", "--engine", "batch"])
    out = capsys.readouterr().out.splitlines()
    ref = _reference("quickstart").splitlines()
    assert len(out) == len(ref)
    fp = re.compile(r"fingerprint \w+")
    assert [fp.sub("", ln) for ln in out] == [fp.sub("", ln) for ln in ref]
    assert any(ln.startswith("barrier local-max") for ln in out)


def test_factor_impact_walkthrough(capsys):
    """``tuning`` ranked first and Holm-significant, ``dtype`` null (the
    walkthrough raises otherwise); 16 cells measured, then 16 resumed and
    none measured; the store round trip names ``tuning``."""
    res = _load("factor_impact_torch").walkthrough(device="cpu")
    out = capsys.readouterr().out
    ref = _reference("factor_impact")
    for text in (ref, out):
        rows = _rows(text, r"MATTERS|-")
        assert rows[0][::2] == ("tuning", "MATTERS")
        assert [r[2] for r in rows if r[0] == "dtype"] == ["-"]
        assert "controls hold: injected factor ranked first, dtype null" in text
        assert _line(text, "resume:") == "resume: 16 cells resumed, 0 measured"
        assert _line(text, "store round-trip:").startswith(
            "store round-trip: top factor 'tuning'")
    assert res["n_cells"] == 16 and res["n_resumed"] == 16 and res["n_measured_again"] == 0
    assert res["effects"][0].axis == "tuning" and res["store_top"] == "tuning"


def test_repro_audit_walkthrough(capsys, tmp_path):
    """6/6 EQUIVALENT on the re-run; exactly the two ``bcast`` cells
    DRIFTED under the mis-tuned bcast; the truncated log resumes 2 cells
    and recomputes 4 with the verdicts unchanged: the reference's
    summaries and every cell's verdict."""
    res = _load("repro_audit_torch").walkthrough(device="cpu", root=tmp_path)
    out = capsys.readouterr().out
    ref = _reference("repro_audit")
    verdict = r"EQUIVALENT|DRIFTED|INCONCLUSIVE"
    assert _rows(out, verdict) == _rows(ref, verdict)
    assert [r[2] for r in _rows(out, verdict)].count("DRIFTED") == 2
    for prefix in ("# 6/6", "# 4/6", "killed after 2 cells"):
        assert _line(out, prefix) == _line(ref, prefix)
    assert res["report"].all_equivalent and res["same"]
    assert {c.op for c in res["drifted"].drifted()} == {"bcast"}
    assert (res["resumed"].n_resumed, res["resumed"].n_computed) == (2, 4)


def test_verify_guidelines_walkthrough(capsys):
    """The honest library holds all 10 cells; the re-run resumes and
    measures nothing; under the mis-tuned alltoall exactly
    ``alltoall_mock_bound``'s two cells are VIOLATED: every cell's verdict
    and the summaries are the reference's."""
    res = _load("verify_guidelines_torch").walkthrough(device="cpu")
    out = capsys.readouterr().out
    ref = _reference("verify_guidelines")
    verdict = r"holds\([<~]\)|VIOLATED"
    assert _rows(out, verdict) == _rows(ref, verdict)
    assert len(_rows(out, verdict)) == 22
    for prefix in ("# all 10 cells hold", "# 2/12 cells VIOLATED"):
        assert _line(out, prefix) == _line(ref, prefix)
    assert res["resumed"].n_measured == 0
    assert _line(out, "resume:").endswith("(same verdicts: True)")
    assert [v.guideline.name for v in res["bad"].verdicts if v.verdict == "VIOLATED"] \
        == ["alltoall_mock_bound"] * 2


def test_compare_impls_walkthrough_on_the_cpu(capsys):
    """Both arms run the flash wrapper's plain version on the CPU: two rows,
    one verdict line each, under the reference's table header for the
    same labels. No verdict is asserted (it is a finding, and here both
    arms are the same code)."""
    res = _load("compare_impls_torch").walkthrough(device="cpu")
    out = capsys.readouterr().out
    assert [r.case.msize for r in res["rows"]] == [128, 256]
    header = ref_format_comparison([], "cuda", "ref").splitlines()[0]
    assert out.splitlines()[0] == header
    assert [ln.split(":")[0] for ln in out.splitlines() if ln.startswith("verdict")] \
        == ["verdict @ seq 128", "verdict @ seq 256"]
    assert all(np.isfinite(r.avg_a) and r.avg_a > 0 for r in res["rows"])
