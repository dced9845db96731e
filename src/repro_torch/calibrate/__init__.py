"""repro_torch.calibrate — fit SimNet's noise model to measured runs, then
certify the fit with the TOST audit engine.

A :class:`CalibrationSpace` declares which noise-model knobs
(AR(1) coefficient, bimodal-tail / spike / imbalance mixture weights,
per-op latencies, clock ``rw_sigma``) may move and within what bounds;
:func:`calibrate` measures a target backend, fits the space by
deterministic coordinate descent on a per-cell quantile-distance
objective (every candidate an ordinary store-resumed
:class:`~repro_torch.campaign.Campaign`), and certifies the fitted simulator
EQUIVALENT / DRIFTED / INCONCLUSIVE on held-out launch epochs via
:func:`~repro_torch.history.audit_tables`. ::

    from repro_torch.calibrate import calibrate, default_space
    from repro_torch.campaign import ResultStore, TorchSimBackend
    from repro_torch.history import RunArchive

    space = default_space(base=TorchSimBackend(p=8, seed0=0),
                          names=["op.alpha"])
    truth = TorchSimBackend(p=8, seed0=7919, op_kw=dict(alpha=6e-6))
    result = calibrate(space, truth,
                       store=ResultStore("runs/calib-000.jsonl"),
                       archive=RunArchive("runs/"))
    assert result.ok, f"certification: {result.verdict}"

Every candidate and the target run on the card unless their backends say
``device="cpu"``.

Fits are resumable: search state persists as ``calib-round`` store lines
(the ``sweep-alloc`` pattern), measurements resume at record granularity.
"""

from .fit import CALIBRATED_TAG, CalibrationResult, calibrate, certify_heldout
from .space import CalibrationParam, CalibrationSpace, default_space

__all__ = [
    "CalibrationParam",
    "CalibrationSpace",
    "default_space",
    "calibrate",
    "certify_heldout",
    "CalibrationResult",
    "CALIBRATED_TAG",
]
