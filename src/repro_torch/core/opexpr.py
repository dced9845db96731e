"""Composite operation expressions — the mock-up language of performance
guidelines (PGMPI, arXiv:1606.00215).

A performance guideline compares a collective against a *mock-up*: an
alternative implementation of (an upper bound on) the same communication
pattern, built from other collectives run back to back — ``bcast <=
scatter + allgather``, ``allreduce <= reduce + bcast``, split-robustness
``allreduce(p) <= allreduce(p/2) + allreduce(p/2)``. Both sides of a
guideline must flow through the *same* measurement pipeline, so mock-ups
are encoded as ordinary :class:`~repro_torch.core.design.TestCase` op names and
every :class:`~repro_torch.campaign.MeasurementBackend` learns to execute them.

Grammar (whitespace-insensitive)::

    expr     :=  term ("+" term)*
    term     :=  NAME modifier*
    modifier :=  "*" FLOAT      message-size scale of this term
              |  "@half"        run this term on half the processes
              |  "#" NAME       implementation tag (backend-specific,
                                the simulator rejects it)

``"+"`` sequences the constituent operations inside one timed region: one
observation of ``"scatter+allgather"`` is a scatter immediately followed
by an allgather, timed end to end — exactly the mock-up semantics of the
guideline literature. A plain name (``"allreduce"``) parses to a single
unmodified term, so every existing op name is a valid expression.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

__all__ = ["OpTerm", "parse_opexpr", "is_composite"]

_TERM_RE = re.compile(
    r"^(?P<op>[A-Za-z_][A-Za-z0-9_]*)"
    r"(?P<mods>(?:\*[0-9.]+|@half|#[A-Za-z_][A-Za-z0-9_]*)*)$"
)
_MOD_RE = re.compile(r"\*[0-9.]+|@half|#[A-Za-z_][A-Za-z0-9_]*")


@dataclass(frozen=True)
class OpTerm:
    """One constituent operation of a (possibly composite) expression."""

    op: str
    msize_scale: float = 1.0   # term message size = round(scale * case msize)
    procs: str = "all"         # "all" | "half" (split-robustness mock-ups)
    impl: str | None = None    # backend-specific implementation tag

    def msize(self, case_msize: int) -> int:
        return max(0, int(round(self.msize_scale * case_msize)))


def parse_opexpr(expr: str) -> tuple[OpTerm, ...]:
    """Parse an op expression into its terms (a plain name -> one term)."""
    terms: list[OpTerm] = []
    for raw in expr.split("+"):
        raw = raw.strip()
        m = _TERM_RE.match(raw)
        if not m:
            raise ValueError(
                f"opexpr: cannot parse term {raw!r} of {expr!r} "
                "(grammar: NAME, NAME*SCALE, NAME@half, NAME#impl, "
                "terms joined by '+')")
        scale, procs, impl = 1.0, "all", None
        for mod in _MOD_RE.findall(m.group("mods")):
            if mod.startswith("*"):
                scale = float(mod[1:])
                if scale <= 0:
                    raise ValueError(f"opexpr: non-positive msize scale "
                                     f"in {raw!r}")
            elif mod == "@half":
                procs = "half"
            else:
                impl = mod[1:]
        terms.append(OpTerm(op=m.group("op"), msize_scale=scale,
                            procs=procs, impl=impl))
    if not terms:
        raise ValueError(f"opexpr: empty expression {expr!r}")
    return tuple(terms)


def is_composite(expr: str) -> bool:
    """True when ``expr`` needs the composite execution path (more than one
    term, or any modifier on a single term)."""
    terms = parse_opexpr(expr)
    if len(terms) > 1:
        return True
    t = terms[0]
    return t.msize_scale != 1.0 or t.procs != "all" or t.impl is not None
