"""repro_torch.sweeps — the factor registry made executable, end to end.

Enumerable factor axes (:class:`~repro_torch.core.factors.FactorAxis` /
:class:`~repro_torch.core.factors.FactorGrid`) are compiled by the
:class:`~repro_torch.campaign.SweepScheduler` into per-cell campaigns —
sharded, persistent, resumable — on
:class:`~repro_torch.campaign.TorchSimBackend`, and
:mod:`repro_torch.sweeps.effects` distills the measured grid into the
paper's "which factors matter" table (Kruskal-Wallis + Holm main effects,
Cliff's-delta ranking, pairwise interaction screen).
:mod:`repro_torch.sweeps.alloc` spends the budget in rounds (racing,
successive halving). ::

    from repro_torch.campaign import ResultStore, SweepScheduler
    from repro_torch.sweeps import (default_sim_sweep, cells_from_result,
                                    main_effects, format_factor_report)

    spec, backend = default_sim_sweep(seed=0)          # on the card
    res = SweepScheduler(spec, backend, ResultStore("sweep.jsonl")).run()
    print(format_factor_report(main_effects(cells_from_result(res))))

``default_sim_sweep(seed=0, device="cpu")`` runs the same sweep on the
CPU, through the kernel's plain version.
"""

from .alloc import (POLICIES, AllocationPolicy, AllocState, RacingPolicy,
                    RoundPlan, SuccessiveHalvingPolicy, UniformPolicy,
                    make_policy)
from .axes import (DEFAULT_SWEEP_AXES, MISTUNED_PER_OP_KW, default_sim_sweep,
                   sim_axes)
from .effects import (DEFAULT_QUANTILES, AxisDecision, AxisEffect, CellData,
                      InteractionEffect, PairEffect, alpha_spending,
                      axis_decisions, cells_from_result, cells_from_store,
                      format_factor_report, interaction_screen, main_effects,
                      quantile_distance)

__all__ = [
    "sim_axes",
    "default_sim_sweep",
    "DEFAULT_SWEEP_AXES",
    "MISTUNED_PER_OP_KW",
    "CellData",
    "PairEffect",
    "AxisEffect",
    "AxisDecision",
    "InteractionEffect",
    "cells_from_result",
    "cells_from_store",
    "main_effects",
    "axis_decisions",
    "alpha_spending",
    "interaction_screen",
    "format_factor_report",
    "quantile_distance",
    "DEFAULT_QUANTILES",
    "AllocationPolicy",
    "AllocState",
    "RoundPlan",
    "UniformPolicy",
    "RacingPolicy",
    "SuccessiveHalvingPolicy",
    "POLICIES",
    "make_policy",
]
