"""The run archive: many result stores, one manifest, cheap lookups.

A reproducibility audit compares *runs separated by time* — yesterday's
calibration against today's, last month's reference against a fresh
re-measurement on the same (or a changed) machine. That needs a durable
index over many :class:`~repro_torch.campaign.ResultStore` JSONLs: which factor
fingerprints each file holds, on which host it was measured, when it was
registered, and under what human-facing tag ("reference", "post-upgrade").

:class:`RunArchive` is a directory of stores plus one append-only
``manifest.jsonl``. Registration parses a store *once* and appends a
:class:`RunEntry` line; every later lookup (``runs``, ``baseline_for``)
reads only the manifest — an archive of a thousand runs answers "what is
the latest reference for this fingerprint?" without re-parsing a thousand
JSONL files. Registration also stamps the store itself with a ``meta``
line (run id, tag, registration time), so a store file carried away from
its archive still says where it came from.

Run identity is content-based: ``run_id = sha256(relative path + the
store's non-meta lines)``. Re-registering an unchanged store is a no-op;
a store that *grew* (a resumed campaign) gets a fresh entry superseding
the old one at the same path; and the meta stamp itself is excluded from
the hash, so stamping does not change what it stamps.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import platform
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path

from ..campaign import ResultStore

__all__ = ["RunEntry", "RunArchive", "CONTROL_TAG"]

MANIFEST_NAME = "manifest.jsonl"

#: Runs tagged with this are *controls* (e.g. a seeded mis-tuning's
#: drift run): they stay in the archive for the record, but default
#: baseline resolution never picks one — a deliberately-bad run must not
#: become the yardstick a later run "passes" against.
CONTROL_TAG = "control"


@dataclass(frozen=True)
class RunEntry:
    """One archived run: the manifest's one-pass index of a store file."""

    run_id: str                      # sha256(relpath + non-meta content)[:16]
    store: str                       # store path relative to the archive root
    timestamp: float                 # registration time (unix seconds)
    host: str = ""
    tag: str | None = None
    fingerprints: tuple = ()         # campaign fingerprints, file order
    names: tuple = ()                # campaign spec names, same order
    n_records: int = 0
    schema_version: int = 0
    factors: dict = field(default_factory=dict)  # last campaign's factor dict
    n_corrupt: int = 0               # undecodable store lines at registration

    def to_dict(self) -> dict:
        return dict(kind="run", run_id=self.run_id, store=self.store,
                    timestamp=self.timestamp, host=self.host, tag=self.tag,
                    fingerprints=list(self.fingerprints),
                    names=list(self.names), n_records=self.n_records,
                    schema_version=self.schema_version, factors=self.factors,
                    n_corrupt=self.n_corrupt)

    @classmethod
    def from_dict(cls, o: dict) -> "RunEntry":
        return cls(run_id=o["run_id"], store=o["store"],
                   timestamp=float(o["timestamp"]), host=o.get("host", ""),
                   tag=o.get("tag"),
                   fingerprints=tuple(o.get("fingerprints", ())),
                   names=tuple(o.get("names", ())),
                   n_records=int(o.get("n_records", 0)),
                   schema_version=int(o.get("schema_version", 0)),
                   factors=o.get("factors", {}),
                   n_corrupt=int(o.get("n_corrupt", 0)))


def _content_hash(relpath: str, store_path: Path) -> str:
    """Identity of a store's *measurements*: path + every non-meta line.

    Meta lines (the archive's own registration stamps) are skipped so that
    stamping a store does not change its identity; the relative path is
    included so two bit-identical runs (a deterministic simulator re-run)
    still register as two distinct runs — which is exactly the pair an
    audit wants to compare.
    """
    h = hashlib.sha256(relpath.encode())
    with open(store_path, "rb") as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            try:
                kind = json.loads(line).get("kind")
            except (json.JSONDecodeError, AttributeError):
                kind = None      # torn tail line; identity ignores it too
            if kind in ("meta", None):
                continue
            h.update(line)
            h.update(b"\n")
    return h.hexdigest()[:16]


class RunArchive:
    """A directory of result stores indexed by an append-only manifest."""

    def __init__(self, root):
        self.root = Path(root)

    @property
    def manifest_path(self) -> Path:
        return self.root / MANIFEST_NAME

    # -- registration ------------------------------------------------------

    def register(self, store_path, tag: str | None = None,
                 stamp: bool = True) -> RunEntry:
        """Index one store into the manifest; returns its :class:`RunEntry`.

        Idempotent on content: an unchanged store (same relative path, same
        non-meta lines) returns its existing entry without re-indexing —
        unless a *different* ``tag`` is requested, in which case a
        re-tagged entry (same run id, original timestamp) supersedes the
        old one, so tagging an already-registered run (say, one that
        ``Campaign(archive=...)`` auto-registered untagged) works. A grown
        store appends a fresh entry that supersedes the old one at the
        same path (``entries()`` keeps both for history; ``runs()``
        returns the latest per path). With ``stamp``, the store itself
        receives a ``meta`` line recording the registration.
        """
        store_path = Path(store_path)
        if not store_path.exists():
            raise FileNotFoundError(f"RunArchive.register: no store at "
                                    f"{store_path}")
        try:
            rel = str(store_path.resolve().relative_to(self.root.resolve()))
        except ValueError:
            # outside the archive root: index it by absolute path (the
            # manifest stays usable, the file just isn't archive-managed)
            rel = str(store_path.resolve())
        run_id = _content_hash(rel, store_path)
        existing = None
        for entry in self.entries():
            if entry.run_id == run_id and entry.store == rel:
                existing = entry            # last registration wins
        if existing is not None:
            if tag is None or existing.tag == tag:
                return existing
            entry = dataclasses.replace(existing, tag=tag)
        else:
            store = ResultStore(store_path)
            # one parsing pass: the snapshot carries everything the entry
            # needs (fingerprints in declaration order, spec names, factor
            # dicts, record counts/hosts)
            snap = store.snapshot()
            fingerprints = tuple(snap.campaign_specs)
            names = tuple(snap.campaign_specs[fp].get("name", "")
                          for fp in fingerprints)
            hosts = {r.meta.get("host", "") for recs in snap.records.values()
                     for r in recs} - {""}
            entry = RunEntry(
                run_id=run_id, store=rel, timestamp=time.time(),
                host=min(hosts) if hosts else platform.node(), tag=tag,
                fingerprints=fingerprints, names=names,
                n_records=sum(len(r) for r in snap.records.values()),
                schema_version=store.schema_version(),
                factors=(snap.campaign_factors.get(fingerprints[-1], {})
                         if fingerprints else {}),
                n_corrupt=snap.n_corrupt,
            )
            if snap.n_corrupt:
                # a store carrying torn-write residue is still archivable
                # (the loader skipped the damage), but an audit baseline
                # with silent holes is worse than a loud one
                warnings.warn(
                    f"RunArchive.register: {store_path} had "
                    f"{snap.n_corrupt} undecodable line(s) skipped at "
                    "registration; recorded in the manifest entry's "
                    "n_corrupt", RuntimeWarning, stacklevel=2)
        self.root.mkdir(parents=True, exist_ok=True)
        with open(self.manifest_path, "a") as f:
            f.write(json.dumps(entry.to_dict(), sort_keys=True) + "\n")
            f.flush()
        if stamp:
            ResultStore(store_path).append_meta(
                archived=dict(run_id=run_id, tag=tag,
                              timestamp=entry.timestamp))
        return entry

    def new_store_path(self, stem: str = "run") -> Path:
        """A fresh ``<stem>-NNN.jsonl`` path inside the archive (NNN past
        the highest existing index, so killed runs never collide)."""
        self.root.mkdir(parents=True, exist_ok=True)
        taken = [p.name for p in self.root.glob(f"{stem}-*.jsonl")]
        n = 0
        for name in taken:
            try:
                n = max(n, int(name[len(stem) + 1:-len(".jsonl")]) + 1)
            except ValueError:
                continue
        return self.root / f"{stem}-{n:03d}.jsonl"

    def log_calibration(self, entry: RunEntry, report: dict) -> None:
        """Append a calibration fit report to the manifest, keyed by the
        registered run — the archive-level record of *how* a run earned
        its ``calibrated`` tag (fitted params, objective trace, per-cell
        verdicts). A separate line kind, not a :class:`RunEntry` field:
        :meth:`entries` filters by ``kind == "run"``, so older readers
        skip these lines untouched (the store schema's forward-compat
        rule applied to the manifest)."""
        self.root.mkdir(parents=True, exist_ok=True)
        with open(self.manifest_path, "a") as f:
            f.write(json.dumps(dict(kind="calibration",
                                    run_id=entry.run_id, report=report),
                               sort_keys=True) + "\n")
            f.flush()

    def calibrations(self, run_id: str | None = None) -> list[dict]:
        """Calibration reports in log order, optionally for one run."""
        if not self.manifest_path.exists():
            return []
        out: list[dict] = []
        with open(self.manifest_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    o = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if o.get("kind") == "calibration" and \
                        (run_id is None or o.get("run_id") == run_id):
                    out.append(o)
        return out

    # -- lookups (manifest only — stores are never re-parsed here) --------

    def entries(self) -> list[RunEntry]:
        """Every manifest line in registration order (including superseded
        registrations of grown stores)."""
        if not self.manifest_path.exists():
            return []
        out: list[RunEntry] = []
        with open(self.manifest_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    o = json.loads(line)
                except json.JSONDecodeError:   # torn tail: registration lost,
                    continue                   # store is still on disk
                if o.get("kind") == "run":
                    out.append(RunEntry.from_dict(o))
        return out

    def runs(self, fingerprint: str | None = None, tag: str | None = None,
             name: str | None = None) -> list[RunEntry]:
        """Current runs (latest registration per store path), filtered."""
        latest: dict[str, RunEntry] = {}
        for e in self.entries():
            latest[e.store] = e
        out = sorted(latest.values(), key=lambda e: e.timestamp)
        if fingerprint is not None:
            out = [e for e in out if fingerprint in e.fingerprints]
        if tag is not None:
            out = [e for e in out if e.tag == tag]
        if name is not None:
            out = [e for e in out if name in e.names]
        return out

    def entry(self, run_id: str) -> RunEntry:
        """The *latest* registration of a run id — a re-tagged run's
        superseding entry, not its stale original."""
        for e in reversed(self.entries()):
            if e.run_id == run_id:
                return e
        raise KeyError(f"no run {run_id!r} in {self.manifest_path}")

    def open_store(self, entry: RunEntry) -> ResultStore:
        path = Path(entry.store)
        if not path.is_absolute():
            path = self.root / path
        return ResultStore(path)

    def baseline_for(self, candidate: RunEntry,
                     tag: str | None = None) -> RunEntry | None:
        """The run a fresh ``candidate`` should be audited against.

        With a ``tag``: the latest run so tagged (a pinned reference);
        raises if the tag names nothing. Without: the latest *earlier* run
        sharing a factor fingerprint with the candidate — the same declared
        experiment, re-run; failing that, the latest earlier run of the
        same campaign name (comparable up to the factor drift the audit
        report surfaces); ``None`` when the candidate is the first run.
        Runs tagged :data:`CONTROL_TAG` are never picked by the default
        resolution — only an explicit ``tag=CONTROL_TAG`` can select one.
        """
        if tag is not None:
            tagged = [e for e in self.runs(tag=tag)
                      if e.run_id != candidate.run_id]
            if not tagged:
                raise KeyError(f"no archived run tagged {tag!r} in "
                               f"{self.manifest_path}")
            return tagged[-1]
        earlier = [e for e in self.runs()
                   if e.run_id != candidate.run_id
                   and e.timestamp <= candidate.timestamp
                   and e.store != candidate.store
                   and e.tag != CONTROL_TAG]
        shared = [e for e in earlier
                  if set(e.fingerprints) & set(candidate.fingerprints)]
        if shared:
            return shared[-1]
        named = [e for e in earlier
                 if set(e.names) & set(candidate.names)]
        return named[-1] if named else None
