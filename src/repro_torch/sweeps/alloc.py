"""Budgeted sweep allocation: spend nrep where the verdict is undecided.

The paper's design (and :func:`~repro_torch.sweeps.effects.main_effects`)
spreads measurement budget uniformly over the factor grid, but the
deliverable is a set of per-axis *verdicts* — MATTERS or null — and most
cells stop informing any undecided verdict long before the uniform
budget is spent. This module treats the sweep as a best-arm/ranking
problem: an :class:`AllocationPolicy` plans *rounds* (a launch-epoch
window over the currently surviving cells), looks at the accumulated
data after each round through the anytime-valid
:func:`~repro_torch.sweeps.effects.axis_decisions` check, and retires an axis
the moment its verdict resolves — reallocating the remaining budget to
the axes still in play by *pinning* every decided axis at its reference
level (dropping the cells that only exist to vary it).

Three policies, one protocol:

``uniform``
    one round, every cell, all epochs — the paper's design expressed as
    a policy, the reference the others are validated against;
``racing``
    geometrically growing epoch windows (1, 2, 4, ... capped at the
    design's epoch count) with a Holm + alpha-spending test at every
    look; axes retire only when the *statistics* resolve them;
``successive_halving``
    racing plus a fixed-schedule rule: from the second look onward the
    weakest half (by observed |Cliff's delta|) of the still-undecided
    axes is force-retired as null. Cheaper tail, but the forced
    retirements are a budget heuristic, not a test — the ``forced``
    flag on the decision keeps the two kinds of "null" distinguishable.

Policies are **pure**: ``plan_round`` and ``decide`` are deterministic
functions of the :class:`AllocState` (itself a pure function of the
store snapshot), with no RNG and no clock. That is the load-bearing
property — it makes a killed sweep resumable by replay (persisted
``sweep-alloc`` lines short-circuit ``decide``), keeps sharded == serial
bit-identity, and gives the budget a *prefix* semantics: raising
``nrep_budget`` at the same seed extends the allocation sequence, it
never reorders it (the budget is only ever consulted as a stop
criterion, never as an input to a decision).
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass, replace
from typing import ClassVar, Protocol

from .effects import AxisDecision, CellData, axis_decisions

__all__ = [
    "RoundPlan",
    "AllocState",
    "AllocationPolicy",
    "UniformPolicy",
    "RacingPolicy",
    "SuccessiveHalvingPolicy",
    "POLICIES",
    "make_policy",
    "build_state",
]


@dataclass(frozen=True)
class RoundPlan:
    """One budget slice: measure launch epochs ``[epochs[0], epochs[1])``
    of every cell in ``cells``."""

    round: int
    epochs: tuple[int, int]
    cells: tuple[int, ...]

    def n_cell_epochs(self) -> int:
        return len(self.cells) * (self.epochs[1] - self.epochs[0])


@dataclass
class AllocState:
    """Everything a policy is allowed to look at: the grid's shape, the
    data measured so far, and the verdicts already persisted. Built from
    a store snapshot by :func:`build_state` — never from in-process
    state, so a resumed sweep sees exactly what the killed one saw."""

    axes: list[dict]               # [{name, labels}], manifest order
    cell_levels: dict[int, dict]   # cell index -> {axis: label}
    cells: list[CellData]          # cumulative measured data, cell order
    decided: dict[str, str]        # axis -> resolved verdict
    round: int                     # completed (persisted) rounds
    spent_nrep: int                # raw repetitions in the store so far
    n_epochs_max: int              # the design's n_launch_epochs

    def undecided(self) -> list[str]:
        return [ax["name"] for ax in self.axes
                if ax["name"] not in self.decided]

    def reference_level(self, axis: str) -> str:
        for ax in self.axes:
            if ax["name"] == axis:
                return ax["labels"][0]
        raise KeyError(axis)

    def active_cells(self) -> list[int]:
        """Cells still worth budget: every *decided* axis pinned at its
        reference level (the first label — by stock-axis convention the
        non-defective setting), the undecided axes still fully crossed."""
        pins = {a: self.reference_level(a) for a in self.decided}
        return sorted(
            idx for idx, levels in self.cell_levels.items()
            if all(levels.get(a) == ref for a, ref in pins.items()))


class AllocationPolicy(Protocol):
    """The sequential-allocation strategy of a budgeted sweep.

    ``plan_round`` maps the current state to the next :class:`RoundPlan`
    (or ``None``: the sweep is finished — all verdicts resolved, epochs
    exhausted, or budget spent). ``decide`` maps the post-round state to
    per-axis :class:`~repro_torch.sweeps.effects.AxisDecision`\\ s for the
    still-undecided family. Both must be pure functions of the state.
    """

    name: str

    def plan_round(self, state: AllocState) -> RoundPlan | None: ...

    def decide(self, state: AllocState) -> dict[str, AxisDecision]: ...

    def manifest(self) -> dict: ...


@dataclass(frozen=True)
class UniformPolicy:
    """The paper's design as a policy: one round, every cell, the full
    epoch window. ``decide`` still runs (its verdicts land in the
    ``sweep-alloc`` line for provenance), but nothing is retired —
    there is no later round to save budget in."""

    alpha: float = 0.05
    nrep_budget: int | None = None

    name: ClassVar[str] = "uniform"

    def plan_round(self, state: AllocState) -> RoundPlan | None:
        if state.round >= 1:
            return None
        if self.nrep_budget is not None \
                and state.spent_nrep >= self.nrep_budget:
            return None
        return RoundPlan(round=0, epochs=(0, state.n_epochs_max),
                         cells=tuple(sorted(state.cell_levels)))

    def decide(self, state: AllocState) -> dict[str, AxisDecision]:
        if not state.cells:
            return {}
        return axis_decisions(state.cells, axes=state.undecided(),
                              alpha=self.alpha, look=state.round)

    def manifest(self) -> dict:
        return dict(name=self.name, **asdict(self))


@dataclass(frozen=True)
class RacingPolicy:
    """Race the axes: geometrically growing epoch windows, an
    anytime-valid look after each, survivors keep the budget.

    The cumulative epoch target after round *k* is
    ``ceil(epochs0 * growth**k)`` capped at the design's epoch count, so
    the default schedule measures epoch windows of width 1, 1, 2, 4, ...
    Early looks are cheap and decide the loud axes (and with the stock
    grids, usually *all* axes); late looks only happen while something
    is still genuinely undecided.
    """

    alpha: float = 0.05
    epochs0: int = 1
    growth: float = 2.0
    n_min_null: int = 24
    delta_null: float = 0.3
    nrep_budget: int | None = None
    max_rounds: int = 16

    name: ClassVar[str] = "racing"

    def cum_epochs(self, round_index: int, n_epochs_max: int) -> int:
        e = int(math.ceil(self.epochs0 * self.growth ** round_index))
        return max(1, min(int(n_epochs_max), e))

    def plan_round(self, state: AllocState) -> RoundPlan | None:
        k = state.round
        if k >= self.max_rounds:
            return None
        if self.nrep_budget is not None \
                and state.spent_nrep >= self.nrep_budget:
            return None
        if k > 0 and not state.undecided():
            return None                      # every verdict resolved
        prev = 0 if k == 0 else self.cum_epochs(k - 1, state.n_epochs_max)
        cur = self.cum_epochs(k, state.n_epochs_max)
        if cur <= prev:
            return None                      # epoch window exhausted
        return RoundPlan(round=k, epochs=(prev, cur),
                         cells=tuple(state.active_cells()))

    def decide(self, state: AllocState) -> dict[str, AxisDecision]:
        und = state.undecided()
        if not und or not state.cells:
            return {}
        return axis_decisions(state.cells, axes=und, alpha=self.alpha,
                              look=state.round, n_min_null=self.n_min_null,
                              delta_null=self.delta_null)

    def manifest(self) -> dict:
        return dict(name=self.name, **asdict(self))


@dataclass(frozen=True)
class SuccessiveHalvingPolicy(RacingPolicy):
    """Racing plus a halving schedule: from the second look onward, the
    weakest half of the still-undecided axes (smallest observed |Cliff's
    delta|, ties broken by name for determinism) is force-retired as
    null. The forced decisions carry ``forced=True`` — they are budget
    heuristics, not test outcomes, and the soundness tier only vouches
    for the un-forced kind."""

    name: ClassVar[str] = "successive_halving"

    def decide(self, state: AllocState) -> dict[str, AxisDecision]:
        out = dict(super().decide(state))
        if state.round < 1:
            return out                       # every axis gets two looks
        und = [a for a, d in out.items() if d.verdict == "undecided"]
        n_retire = len(und) // 2
        for axis in sorted(und, key=lambda a: (out[a].effect_size,
                                               a))[:n_retire]:
            out[axis] = replace(out[axis], verdict="null", forced=True)
        return out


POLICIES: dict[str, type] = {
    "uniform": UniformPolicy,
    "racing": RacingPolicy,
    "successive_halving": SuccessiveHalvingPolicy,
}


def make_policy(name: str, **overrides) -> AllocationPolicy:
    """Instantiate a policy by registry name; ``None`` overrides are
    dropped so callers can pass optional flags straight through."""
    try:
        cls = POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown allocation policy {name!r} "
                         f"(have: {', '.join(sorted(POLICIES))})") from None
    return cls(**{k: v for k, v in overrides.items() if v is not None})


def build_state(manifest: dict, snapshot, sweep_id: str,
                n_epochs_max: int, outlier_filter: bool = True) -> AllocState:
    """The policy's view of the world, rebuilt from a store snapshot.

    ``spent_nrep`` counts every raw repetition stored under the sweep's
    cell fingerprints — including records inherited from earlier sweeps
    of the same cells, which a resumed or overlapping sweep rightly does
    not pay for again. ``decided`` replays the persisted ``sweep-alloc``
    verdicts (first resolution wins), and ``round`` is the number of
    persisted rounds — so a killed sweep re-plans exactly the round it
    died in.
    """
    from ..core.design import analyze_records

    axes = [dict(name=a["name"], labels=list(a["labels"]))
            for a in manifest["axes"]]
    cell_levels = {int(i): dict(lv) for i, _, lv in manifest["cells"]}
    cells: list[CellData] = []
    spent = 0
    for index, fp, levels in manifest["cells"]:
        records = snapshot.records.get(fp, [])
        spent += sum(int(r.times.size) for r in records)
        if not records:
            continue
        table = analyze_records(records, outlier_filter)
        meds = {case.key(): table.medians(case) for case in table.cases()}
        cells.append(CellData(index=int(index), levels=dict(levels),
                              medians=meds))
    allocs = snapshot.sweep_alloc_by_id.get(sweep_id, [])
    decided: dict[str, str] = {}
    for line in allocs:
        for axis, d in (line.get("decisions") or {}).items():
            verdict = d.get("verdict") if isinstance(d, dict) else str(d)
            if verdict and verdict != "undecided" and axis not in decided:
                decided[axis] = verdict
    return AllocState(axes=axes, cell_levels=cell_levels, cells=cells,
                      decided=decided, round=len(allocs), spent_nrep=spent,
                      n_epochs_max=int(n_epochs_max))
