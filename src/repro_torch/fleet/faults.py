"""Deterministic fault injection: failure as a first-class, *tested* input
(copied from the JAX package's ``repro.fleet.faults``; one plan decides
the same faults in both packages).

A fault-tolerant scheduler whose failure paths only ever run in
production is not fault-tolerant — it is optimistic. This module makes
the failure modes injectable, seeded, and cheap enough for tier-1 tests:

  ``crash``     the worker process dies mid-cell (``os._exit``, the
                SIGKILL-equivalent: no cleanup, no flush, and — like a
                real kill — a torn half-written line left in its shard);
  ``straggle``  the worker stalls before a measurement long enough for
                its heartbeat to go quiet (exercises lease expiry);
  ``raise``     a transient exception out of ``measure`` (exercises the
                retry path without killing anything);
  ``torn``      a corrupt line written *into* the shard mid-run, as if a
                colocated writer died there (exercises the store's
                skip-warn-count path through a *successful* cell).

A :class:`FaultPlan` decides, as a pure function of ``(seed, cell index,
attempt)``, which faults strike which attempt at which measure call — so
a chaos run is exactly reproducible, and by default only a cell's early
attempts are faulty (``max_faulty_attempts``), so retries converge and
``parallel == serial`` can be asserted *under* injected faults.
:class:`FaultyBackend` wraps any ``MeasurementBackend`` to apply the
plan; it is fingerprint-transparent (``factors()`` delegates), because a
fault changes *whether* a measurement lands, never its value. It forwards
``measure`` and not a backend's fused ``measure_epochs``, so a campaign
under faults measures epoch by epoch: the fleet's "equal to the serial
run" then also holds the per-epoch engine equal to the fused one.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np

__all__ = ["Fault", "FaultPlan", "FaultyBackend", "CrashFault",
           "TransientFault"]


class CrashFault(RuntimeError):
    """Soft-mode stand-in for a worker crash (in-process schedulers
    cannot survive a real ``os._exit``)."""


class TransientFault(RuntimeError):
    """The injected transient exception (kind ``raise``)."""


@dataclass(frozen=True)
class Fault:
    """One injected fault: strike at the ``at_call``-th measure call."""

    kind: str                      # crash | straggle | raise | torn
    at_call: int                   # 1-based measure-call index


@dataclass(frozen=True)
class FaultPlan:
    """Seeded, per-(cell, attempt) fault decisions.

    Each probability is drawn independently per cell attempt; the strike
    point is a uniformly drawn measure-call index in ``[1,
    within_calls]`` (a cell of C cases x E epochs sees at least C*E
    calls, so small values strike early, where the most bookkeeping is
    still in flight). ``max_faulty_attempts`` bounds *which* attempts can
    fault: the default 1 means only a cell's first attempt is ever
    sabotaged, so the retry path always has a clean run to converge to —
    the configuration the chaos-fleet equivalence test needs. Set it
    higher (with probability 1) to drive a cell into quarantine.
    """

    seed: int = 0
    p_crash: float = 0.0
    p_straggle: float = 0.0
    p_raise: float = 0.0
    p_torn: float = 0.0
    straggle_s: float = 0.5        # stall duration; > lease TTL => expiry
    within_calls: int = 6
    max_faulty_attempts: int = 1
    torn_on_crash: bool = True     # a crash also tears its last write

    def __post_init__(self):
        for name in ("p_crash", "p_straggle", "p_raise", "p_torn"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"FaultPlan: {name} must be in [0, 1], "
                                 f"got {p}")

    def any_faults(self) -> bool:
        return any(p > 0 for p in (self.p_crash, self.p_straggle,
                                   self.p_raise, self.p_torn))

    def decide(self, cell_index: int, attempt: int) -> list[Fault]:
        """The faults striking this (cell, attempt) — deterministic, and
        independent of which worker/host happens to run it."""
        if attempt >= self.max_faulty_attempts:
            return []
        rng = np.random.default_rng(
            (int(self.seed), int(cell_index), int(attempt)))
        out = []
        for kind, p in (("crash", self.p_crash),
                        ("straggle", self.p_straggle),
                        ("raise", self.p_raise),
                        ("torn", self.p_torn)):
            u = float(rng.random())
            at = int(rng.integers(1, self.within_calls + 1))
            if u < p:
                out.append(Fault(kind=kind, at_call=at))
        return out

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """CLI form: ``crash=0.4,straggle=0.2,seed=7,straggle_s=1.0``.
        Keys are the dataclass fields, with ``crash``/``straggle``/
        ``raise``/``torn`` accepted as shorthand for their ``p_*``
        probability fields."""
        kw: dict[str, Any] = {}
        alias = {"crash": "p_crash", "straggle": "p_straggle",
                 "raise": "p_raise", "torn": "p_torn"}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"FaultPlan.parse: expected key=value, "
                                 f"got {part!r}")
            k, v = part.split("=", 1)
            k = alias.get(k.strip(), k.strip())
            if k not in cls.__dataclass_fields__:
                raise ValueError(
                    f"FaultPlan.parse: unknown key {k!r}; one of "
                    f"{sorted(set(cls.__dataclass_fields__) | set(alias))}")
            ftype = str(cls.__dataclass_fields__[k].type)
            v = v.strip()
            if "bool" in ftype:
                kw[k] = v.lower() in ("1", "true", "yes")
            elif "int" in ftype:
                kw[k] = int(v)
            else:
                kw[k] = float(v)
        return cls(**kw)


#: Exit code a hard (process) crash fault dies with — lets the scheduler
#: log "injected crash" distinctly from a genuine worker failure.
CRASH_EXIT_CODE = 113

#: The torn half-line a crash leaves behind: valid JSON prefix, no close,
#: no newline — exactly what a writer killed mid-``write(2)`` produces.
TORN_TAIL = '{"kind": "record", "fingerprint": "torn-by-injected-crash", "t'

#: A survivable mid-run torn line (newline-terminated, so later appends
#: start clean and the garbage ends up *mid-file* once the cell finishes).
TORN_LINE = '{"kind": "record", "fingerprint": "torn-by-fault-plan", "op'


@dataclass
class FaultyBackend:
    """Wrap a ``MeasurementBackend``; apply a :class:`FaultPlan`.

    ``hard=True`` (subprocess workers) makes ``crash`` a real
    ``os._exit`` — un-catchable, un-flushable, the SIGKILL-equivalent;
    ``hard=False`` (in-process scheduling, and any test that must
    survive) raises :class:`CrashFault` instead. ``shard_path`` is where
    torn-write faults land their garbage; without it they are no-ops.
    Everything else — factors, epochs, default cases, and above all the
    *measured values* — delegates untouched to ``inner``.
    """

    inner: Any
    plan: FaultPlan
    cell_index: int
    attempt: int = 0
    hard: bool = False
    shard_path: str | None = None
    _calls: int = field(default=0, init=False, repr=False, compare=False)

    @property
    def name(self) -> str:
        return self.inner.name

    def make_epoch(self, epoch: int) -> Any:
        return self.inner.make_epoch(epoch)

    def factors(self, design) -> Any:
        # fingerprint-transparent by design: injected faults decide
        # whether a measurement lands, never what it measures
        return self.inner.factors(design)

    def default_cases(self) -> list:
        return self.inner.default_cases()

    def _tear(self, text: str) -> None:
        if self.shard_path is None:
            return
        with open(self.shard_path, "a") as f:
            f.write(text)
            f.flush()

    def measure(self, ctx: Any, case: Any, nrep: int) -> np.ndarray:
        self._calls += 1
        for fault in self.plan.decide(self.cell_index, self.attempt):
            if fault.at_call != self._calls:
                continue
            if fault.kind == "torn":
                self._tear(TORN_LINE + "\n")
            elif fault.kind == "straggle":
                time.sleep(self.plan.straggle_s)
            elif fault.kind == "raise":
                raise TransientFault(
                    f"injected transient fault (cell {self.cell_index}, "
                    f"attempt {self.attempt}, call {self._calls})")
            elif fault.kind == "crash":
                if self.hard:
                    if self.plan.torn_on_crash:
                        self._tear(TORN_TAIL)
                    os._exit(CRASH_EXIT_CODE)
                raise CrashFault(
                    f"injected crash (cell {self.cell_index}, attempt "
                    f"{self.attempt}, call {self._calls})")
        return self.inner.measure(ctx, case, nrep)
