"""The one traffic generator: a traffic mix's data file turned into the
sequence of campaigns a run measures, from the run's seed.

A mix (``perfbench/traffic/<name>.json``) gives the cases (collective and
message size), ``nrep``, the launch epochs of each campaign, and how many
of each campaign's epochs the correctness check works out again. Each
campaign is a design seed and a cluster seed (``seed0``), drawn from the
run's seed and the campaign's index, and so is the choice of the epochs
checked: the same seed gives the same campaigns, another seed others.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CampaignPlan:
    index: int
    cases: tuple            # ((op, msize), ...)
    nrep: int
    epochs: int
    design_seed: int
    seed0: int
    check_epochs: tuple     # sorted epoch indices the check works out again


def campaign(traffic: dict, seed: int, k: int) -> CampaignPlan:
    """Campaign ``k`` of a run with seed ``seed``."""
    seed = int(seed) % 2**64
    design_seed, seed0 = (int(x) for x in np.random.SeedSequence(
        [seed, int(k), 1]).generate_state(2, np.uint32))
    epochs = int(traffic["epochs_per_campaign"])
    n_check = min(epochs, int(traffic["check_epochs_per_campaign"]))
    pick = np.random.default_rng(np.random.SeedSequence([seed, int(k)]))
    return CampaignPlan(
        index=k, cases=tuple((str(op), int(m)) for op, m in traffic["cases"]),
        nrep=int(traffic["nrep"]), epochs=epochs,
        design_seed=design_seed, seed0=seed0 % 2**31,
        check_epochs=tuple(sorted(int(e) for e in pick.choice(epochs, n_check, replace=False))))
