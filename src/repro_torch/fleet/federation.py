"""Store federation: many per-worker shards, one idempotent merge (copied
from the JAX package's ``repro.fleet.federation``; the port's store has
the reference's line format, so either package merges the other's shards).

One process owning one JSONL file is the store's single-writer
invariant; a fleet keeps it by giving every worker *attempt* its own
shard and making the parent the only writer of the authoritative store.
:func:`merge_stores` is the compaction step: append everything the
destination does not already hold, skip (and count) everything it does.
Records are identified by ``(fingerprint, op, msize, epoch)`` and
campaign declarations by ``(fingerprint, spec)`` — the same identities
the resume path uses — so merging is idempotent: replaying a merge, or
merging a shard that a crashed previous merge half-applied, is a no-op
for the lines that already landed. Corrupt shard lines (torn writes from
killed workers) are skipped by the store loader and surface in
:class:`MergeStats.n_corrupt` instead of poisoning the merge.

The same function federates whole *sweep* stores across hosts: sweep
manifests and completion markers are content-addressed (the sweep id is
a hash of the manifest), so two hosts that measured disjoint cells of
the same grid merge into one resumable sweep.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from ..campaign.store import ResultStore, StoreSnapshot

__all__ = ["MergeStats", "merge_stores"]


@dataclass
class MergeStats:
    """What one merge actually did — and what it refused to double-apply."""

    n_campaigns: int = 0          # campaign declarations appended
    n_records: int = 0            # measurement records appended
    n_duplicates: int = 0         # records already present (idempotent skips)
    n_sweep_lines: int = 0        # sweep manifests + cell markers appended
    n_corrupt: int = 0            # undecodable shard lines skipped
    shards: list = field(default_factory=list)   # shard paths, merge order

    def merged_nothing(self) -> bool:
        return not (self.n_campaigns or self.n_records or self.n_sweep_lines)


def _as_store(s) -> ResultStore:
    return s if isinstance(s, ResultStore) else ResultStore(s)


def merge_stores(dest, shards,
                 snapshot: StoreSnapshot | None = None) -> MergeStats:
    """Merge ``shards`` (paths or :class:`ResultStore`) into ``dest``.

    ``snapshot`` — a snapshot of ``dest`` — skips the re-parse and is
    kept coherent with everything appended, so a scheduler can thread its
    one global snapshot through many incremental merges. Shards are
    merged in the given order (sort paths for a deterministic compaction).
    The destination must not appear among the shards: a self-merge would
    read and append the same file.
    """
    dest = _as_store(dest)
    shards = [_as_store(s) for s in shards]
    for s in shards:
        if s.path.resolve() == Path(dest.path).resolve():
            raise ValueError(f"merge_stores: destination {dest.path} listed "
                             "among its own shards")
    if snapshot is None:
        snapshot = dest.snapshot()
    stats = MergeStats(n_corrupt=snapshot.n_corrupt)

    for shard in shards:
        if not shard.path.exists():
            continue
        snap = shard.snapshot()
        stats.shards.append(str(shard.path))
        stats.n_corrupt += snap.n_corrupt

        for fp, spec in snap.campaign_specs.items():
            if snapshot.campaign_specs.get(fp) != spec:
                dest._append(dict(kind="campaign", fingerprint=fp,
                                  factors=snap.campaign_factors.get(fp, {}),
                                  spec=spec))
                snapshot.campaign_specs[fp] = spec
                snapshot.campaign_factors[fp] = \
                    snap.campaign_factors.get(fp, {})
                stats.n_campaigns += 1
            for rec in snap.records.get(fp, []):
                key = (rec.case.op, rec.case.msize, rec.epoch)
                if key in snapshot.completed(fp):
                    stats.n_duplicates += 1
                    continue
                dest.append_record(fp, rec)
                snapshot.records.setdefault(fp, []).append(rec)
                stats.n_records += 1

        # sweep bookkeeping is content-addressed, so it federates too
        for sweep_id in snap.sweeps:
            if sweep_id not in snapshot.sweeps:
                dest._append(dict(kind="sweep", sweep=sweep_id,
                                  manifest=snap.manifests.get(sweep_id, {})))
                snapshot.sweeps.append(sweep_id)
                snapshot.manifests[sweep_id] = snap.manifests.get(sweep_id, {})
                stats.n_sweep_lines += 1
        for sweep_id, cells in snap.sweep_cells_by_id.items():
            have = snapshot.sweep_cells_by_id.setdefault(sweep_id, {})
            for index, fp in cells.items():
                if index not in have:
                    dest.append_sweep_cell(sweep_id, index, fp)
                    have[index] = fp
                    stats.n_sweep_lines += 1
        for sweep_id, cells in snap.sweep_failed_by_id.items():
            done = snapshot.sweep_cells_by_id.get(sweep_id, {})
            have = snapshot.sweep_failed_by_id.setdefault(sweep_id, {})
            for index, info in cells.items():
                # completion anywhere supersedes quarantine: never merge a
                # stale quarantine over a cell another shard finished
                if index in done or index in have:
                    continue
                dest.append_sweep_cell_failed(
                    sweep_id, index, info.get("fingerprint", ""),
                    info.get("attempts", 0), info.get("error", ""))
                have[index] = info
                stats.n_sweep_lines += 1
    return stats
