"""Clock-synchronization algorithms studied and introduced by the paper (§4)."""

from .base import (
    ClockSync,
    SyncResult,
    compute_rtt,
    probe_offsets,
    skampi_pingpong_adjusted,
    true_offsets,
)
from .hca import HCASync, learn_model_hca
from .jk import JKSync, collect_fitpoint, collect_fitpoints_batch
from .netgauge import NetgaugeSync, compute_offset_minrtt
from .skampi import SkampiSync

__all__ = [
    "ClockSync",
    "SyncResult",
    "compute_rtt",
    "skampi_pingpong_adjusted",
    "probe_offsets",
    "true_offsets",
    "HCASync",
    "JKSync",
    "NetgaugeSync",
    "SkampiSync",
    "learn_model_hca",
    "collect_fitpoint",
    "collect_fitpoints_batch",
    "compute_offset_minrtt",
    "ALGORITHMS",
    "SYNC_CLASSES",
    "make_sync",
]

#: Paper name -> implementation class: the single authority for sync-name
#: resolution, shared by :func:`make_sync` and by callers that need to
#: introspect an algorithm's constructor (e.g. the campaign backends
#: filtering their ``sync_kw`` when a sweep swaps algorithms).
SYNC_CLASSES: dict[str, type] = {
    "skampi": SkampiSync,
    "netgauge": NetgaugeSync,
    "jk": JKSync,
    "hca": HCASync,
    "hca2": HCASync,
}

ALGORITHMS = tuple(SYNC_CLASSES)


def make_sync(name: str, **kw) -> ClockSync:
    """Factory by paper name."""
    cls = SYNC_CLASSES.get(name)
    if cls is None:
        raise ValueError(f"unknown sync algorithm {name!r}; "
                         f"known: {ALGORITHMS}")
    if cls is HCASync:
        # implied by the name; accepting an override would let 'hca' run
        # with hca2 semantics while every factor record still says 'hca'
        if "hierarchical_intercepts" in kw:
            raise TypeError(
                "make_sync: hierarchical_intercepts is implied by the "
                "algorithm name ('hca'/'hca2'); do not pass it")
        kw["hierarchical_intercepts"] = name == "hca2"
    return cls(**kw)
