"""Factor-impact walkthrough on the PyTorch port: finding the factor that
matters. The port of ``examples/factor_impact.py``.

The paper's headline contribution is showing *which experimental factors
have an impact on run-time*. This script makes that executable: a factor
grid over a simulated library with one deliberately mis-tuned collective
(the ``tuning`` axis) plus real measurement-mechanical factors and a
known null factor (``dtype`` — a pure label in the simulator). The
nonparametric main-effect analysis must rank the injected defect first,
Holm-significant, and leave the dtype label at the bottom — the positive
and negative control of the whole pipeline. Every cell samples through
``sim_scan`` on ``--device`` (the card by default).

    PYTHONPATH=src python examples/factor_impact_torch.py
    PYTHONPATH=src python examples/factor_impact_torch.py --device cpu
"""

import argparse
import os
import tempfile

from repro_torch.campaign import ResultStore, SweepScheduler
from repro_torch.sweeps import (cells_from_result, cells_from_store,
                                default_sim_sweep, format_factor_report,
                                interaction_screen, main_effects)


def walkthrough(device: str = "cuda") -> dict:
    """Steps 1-4 of the reference; raises where its controls fail.
    Returns the effects, the resumed run and the store's top factor."""
    # --- 1. the factor grid ------------------------------------------------
    # Each axis is one Table-4 factor made enumerable: a name, its levels,
    # and the backend/design constructor field the levels are applied to.
    # The default sweep crosses the injected `tuning` defect with a
    # sync-algorithm choice, the window size, and the dtype label — 16
    # cells.
    spec, backend = default_sim_sweep(seed=0, n_launch_epochs=10, device=device)
    for ax in spec.grid.axes:
        print(f"  {ax.name:<14} ({ax.target}.{ax.kwarg()}): "
              f"{' | '.join(ax.label(i) for i in range(len(ax.levels)))}")
    print(f"  -> {spec.grid.n_full()} cells x {len(spec.cases)} cases x "
          f"{spec.design.n_launch_epochs} launch epochs")

    # --- 2. run the sweep through a persistent store -----------------------
    # Every cell is an ordinary campaign keyed by its own factor
    # fingerprint; the sweep manifest + per-cell completion markers make a
    # killed sweep resume at cell granularity.
    store_path = os.path.join(tempfile.mkdtemp(), "sweep.jsonl")
    result = SweepScheduler(spec, backend, ResultStore(store_path)).run()
    print(f"\nmeasured {result.n_cells_measured} cells "
          f"(sweep id {result.sweep_id})")

    # --- 3. the "factors that matter" table --------------------------------
    cells = cells_from_result(result)
    effects = main_effects(cells)
    print()
    print(format_factor_report(effects, interaction_screen(cells)))

    top = effects[0]
    if not (top.axis == "tuning" and top.significant):
        raise AssertionError("the injected defect must be the top-ranked, "
                             "Holm-significant factor")
    if [e for e in effects if e.axis == "dtype"][0].significant:
        raise AssertionError("the dtype label must stay a null factor")
    print("\ncontrols hold: injected factor ranked first, dtype null")

    # --- 4. resume: a second run measures nothing --------------------------
    again = SweepScheduler(spec, backend, ResultStore(store_path)).run()
    print(f"resume: {again.n_cells_resumed} cells resumed, "
          f"{again.n_cells_measured} measured")

    # the persisted sweep reloads without the in-memory result object
    effects2 = main_effects(cells_from_store(ResultStore(store_path)))
    print(f"store round-trip: top factor {effects2[0].axis!r} "
          f"(|delta|={effects2[0].effect_size:.3f})")
    return dict(effects=effects, n_cells=result.n_cells_measured,
                n_resumed=again.n_cells_resumed, n_measured_again=again.n_cells_measured,
                store_top=effects2[0].axis)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return walkthrough(args.device)


if __name__ == "__main__":
    main()
