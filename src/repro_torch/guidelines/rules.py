"""Performance guidelines as first-class objects (PGMPI, arXiv:1606.00215;
Hunold et al., "Tuning MPI Collectives by Verifying Performance
Guidelines", arXiv:1707.09965).

A *performance guideline* is a self-consistency requirement on a
collectives library: a specialized operation should never lose to a
general one that subsumes its communication pattern, nor to a *mock-up* of
itself built from other collectives run back to back. Each
:class:`Guideline` declares ``lhs ⪯ rhs`` where both sides are op
expressions (:mod:`repro_torch.core.opexpr`) that compile to ordinary campaign
:class:`~repro_torch.core.design.TestCase`\\ s — so a guideline is verified by
the paper's own measurement machinery, not by a separate ad-hoc harness.

Four guideline families are expressible:

  * **pattern containment**  — ``allgather ⪯ alltoall``: the alltoall
    exchange is a superset of allgather's, so a sane library's allgather
    cannot be slower;
  * **mock-up composition**  — ``bcast ⪯ scatter+allgather``,
    ``allreduce ⪯ reduce+bcast``: the library could implement the lhs via
    the rhs sequence, so the dedicated algorithm must not lose to it;
  * **monotonicity**         — ``op(m) ⪯ op(k·m)`` via ``rhs_msize_scale``:
    sending more data must not be faster (a violation is the classic
    protocol-switchover bug);
  * **split-robustness**     — ``allreduce ⪯ allreduce@half+allreduce@half``:
    running on the full communicator must not lose to running the two
    halves one after the other (``p -> p/2 + p/2``).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.design import TestCase
from ..core.opexpr import parse_opexpr

__all__ = ["Guideline", "SIM_GUIDELINES", "KERNEL_GUIDELINES",
           "default_guidelines"]


@dataclass(frozen=True)
class Guideline:
    """``lhs ⪯ rhs``: the lhs expression must not be (statistically
    significantly) slower than the rhs expression.

    ``rhs_msize_scale`` evaluates the rhs at a scaled message size — the
    monotonicity family (``lhs == rhs``, scale > 1). ``msizes``, when
    non-empty, overrides the verifier's default message-size sweep for
    this guideline (kernel guidelines need block-aligned sequence
    lengths, for example).
    """

    name: str
    lhs: str
    rhs: str
    rhs_msize_scale: float = 1.0
    msizes: tuple = ()
    description: str = ""

    def __post_init__(self):
        # fail at declaration time, not in the middle of a campaign
        parse_opexpr(self.lhs)
        parse_opexpr(self.rhs)
        if self.rhs_msize_scale <= 0:
            raise ValueError(f"guideline {self.name!r}: rhs_msize_scale "
                             "must be positive")

    def cases(self, msize: int) -> tuple[TestCase, TestCase]:
        """The (lhs, rhs) campaign cases of this guideline at ``msize``."""
        rhs_m = max(1, int(round(self.rhs_msize_scale * msize)))
        return TestCase(self.lhs, msize), TestCase(self.rhs, rhs_m)


#: The PGMPI-style self-consistency set for the simulated MPI library —
#: one guideline per family. All four hold for the honest default cost
#: models in :func:`repro_torch.core.mpi_ops.make_op`; a mis-tuned collective
#: (seeded via ``TorchSimBackend(per_op_kw=...)``) is what verification exists
#: to flag.
SIM_GUIDELINES: tuple[Guideline, ...] = (
    Guideline(
        name="allgather_pat_alltoall",
        lhs="allgather", rhs="alltoall",
        description="pattern containment: allgather ⪯ alltoall",
    ),
    Guideline(
        name="bcast_mock_scatter_allgather",
        lhs="bcast", rhs="scatter+allgather",
        description="mock-up: bcast ⪯ scatter+allgather",
    ),
    Guideline(
        name="allreduce_mock_reduce_bcast",
        lhs="allreduce", rhs="reduce+bcast",
        description="mock-up: allreduce ⪯ reduce+bcast",
    ),
    Guideline(
        name="allreduce_mono_msize",
        lhs="allreduce", rhs="allreduce", rhs_msize_scale=4.0,
        description="monotonicity: allreduce(m) ⪯ allreduce(4m)",
    ),
    Guideline(
        name="allreduce_split_procs",
        lhs="allreduce", rhs="allreduce@half+allreduce@half",
        description="split-robustness: allreduce(p) ⪯ 2x allreduce(p/2)",
    ),
)

#: The kernel-layer analogue: a hand-written kernel must not lose to its
#: own plain PyTorch version (both sides measured in the same campaign
#: through ``#impl`` tags). On the card this is a measured question; on
#: the CPU both tags run the plain version, so the two sides are the same
#: code and the guideline can only hold or be undecided there.
KERNEL_GUIDELINES: tuple[Guideline, ...] = (
    Guideline(
        name="flash_attention_vs_ref",
        lhs="flash_attention#cuda", rhs="flash_attention#ref",
        msizes=(128,),
        description="kernel: cuda flash_attention ⪯ plain version",
    ),
    Guideline(
        name="ssd_scan_vs_ref",
        lhs="ssd_scan#cuda", rhs="ssd_scan#ref",
        msizes=(128,),
        description="kernel: cuda ssd_scan ⪯ plain version",
    ),
)


def default_guidelines(backend_name: str) -> tuple[Guideline, ...]:
    """The stock guideline set for a backend family."""
    sets = {"sim": SIM_GUIDELINES, "kernel": KERNEL_GUIDELINES}
    try:
        return sets[backend_name]
    except KeyError:
        raise ValueError(f"no default guideline set for backend "
                         f"{backend_name!r}; one of {sorted(sets)}") from None
