"""Append-only persistent result store (JSONL), keyed by factor fingerprint.

The line format of the JAX package's ``repro.campaign.store`` (schema 1),
so that a store written by the port loads in the reference's
``ResultStore`` and the reference's audits, sweeps and comparisons read
it, and a reference store loads here:

  ``{"kind": "schema", "version": 1}``
      the first line of every new store; a file declaring a future schema
      version refuses to load;

  ``{"kind": "campaign", "fingerprint": ..., "factors": {...}, "spec": ...}``
      declares a campaign: the full :class:`~repro_torch.core.factors.FactorSet`
      and the spec metadata, written once per fingerprint and spec;

  ``{"kind": "record", "fingerprint": ..., "op": ..., "msize": ...,
     "epoch": ..., "times": [...], "meta": {...}}``
      one measured cell (case x launch epoch), appended the moment it is
      measured — so a killed campaign loses at most one cell;

  ``{"kind": "meta", ...}``
      free-form metadata (archive registration stamps: run id, tag,
      registration time), excluded from the store's content identity.

Factor sweeps (:mod:`repro_torch.campaign.sweep`) add ``{"kind":
"sweep", ...}`` (the grid manifest) and ``{"kind": "sweep-cell", ...}``
(a cell completely measured); a quarantined cell is ``{"kind":
"sweep-cell-failed", ...}``, carrying the factor fingerprint and last
error so partial results stay honest about what is missing. Budgeted
sweeps (:mod:`repro_torch.sweeps.alloc`) add ``{"kind": "sweep-alloc",
...}`` — one line per allocation *round*, recording which cells received
budget, the epoch window measured, and the axis verdicts the policy
reached on the data available at that look. Persisting the decisions (not
just the measurements) is what makes a racing sweep kill/resume
deterministic: a resumed run replays the recorded verdicts instead of
re-deciding on a possibly-larger record set. Calibration fits
(:mod:`repro_torch.calibrate`) reuse the same idea with ``{"kind":
"calib", ...}`` (the fit manifest: parameter space bounds, target
fingerprint, design) and ``{"kind": "calib-round", ...}`` (one line per
completed search round: the incumbent parameter vector, its objective,
and every evaluation the round made) — a killed fit replays its persisted
rounds and resumes the search mid-trajectory.

Appending is atomic at line granularity and times round-trip exactly
(``json`` emits shortest-repr doubles). Undecodable lines are skipped with
a warning naming the line number and (best-effort) kind, and counted in
:attr:`ResultStore.n_corrupt`: a torn *tail* is the ordinary residue of a
killed writer, a torn line *mid-file* the louder signal of a crashed
merge.
"""

from __future__ import annotations

import hashlib
import json
import os
import platform
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable

import numpy as np

from ..core.design import (MeasurementRecord, ResultTable, TestCase,
                           analyze_records)
from ..core.factors import FactorSet
from ..core.warnutil import warn_external

__all__ = ["ResultStore", "StoreSnapshot", "SCHEMA_VERSION"]

#: Version of the JSONL line schema this build writes (and the newest it
#: reads), the reference's.
SCHEMA_VERSION = 1


def _line_kind(line: str) -> str:
    """Best-effort ``kind`` of an undecodable line: a torn write usually
    keeps its head, so the kind tag often survives the truncation — and a
    warning that says *which* kind of line was lost tells the operator
    whether a measurement, a marker, or mere bookkeeping is gone."""
    m = re.search(r'"kind"\s*:\s*"([a-zA-Z0-9_-]+)"', line)
    return f'"{m.group(1)}"' if m else "unknown-kind"


def _record_from(o: dict) -> MeasurementRecord:
    return MeasurementRecord(
        case=TestCase(o["op"], int(o["msize"])),
        epoch=int(o["epoch"]),
        times=np.asarray(o["times"], np.float64),
        invalid_fraction=float(o.get("invalid_fraction", 0.0)),
        meta=o.get("meta", {}),
    )


@dataclass
class StoreSnapshot:
    """A one-pass index of a store file, for write paths that would
    otherwise re-scan the whole JSONL per operation.

    A sweep touching N cells consults the store ~3 times per cell
    (campaign dedup, resume lookup, completion markers); against a
    growing file that is O(N^2) parsing. ``ResultStore.snapshot()`` reads
    the file once; the snapshot-aware append methods keep it coherent for
    everything *this* process appends. Single-writer only — a snapshot
    does not see lines appended by anyone else after it was taken.
    """

    campaign_specs: dict = field(default_factory=dict)   # fp -> last spec
    campaign_factors: dict = field(default_factory=dict)  # fp -> factor dict
    records: dict = field(default_factory=dict)          # fp -> [records]
    sweeps: list = field(default_factory=list)           # ids, file order
    manifests: dict = field(default_factory=dict)        # id -> manifest
    sweep_cells_by_id: dict = field(default_factory=dict)  # id -> {cell: fp}
    sweep_failed_by_id: dict = field(default_factory=dict)  # id -> {cell: info}
    sweep_alloc_by_id: dict = field(default_factory=dict)  # id -> [rounds]
    calibs: list = field(default_factory=list)           # ids, file order
    calib_manifests: dict = field(default_factory=dict)  # id -> manifest
    calib_rounds_by_id: dict = field(default_factory=dict)  # id -> [rounds]
    n_corrupt: int = 0             # undecodable lines skipped in this pass

    def completed(self, fingerprint: str) -> set:
        return {(r.case.op, r.case.msize, r.epoch)
                for r in self.records.get(fingerprint, [])}


class ResultStore:
    """Append-only JSONL store of campaign measurement records."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        #: Undecodable lines skipped during the most recent full parse —
        #: the visible residue of torn writes (crashed writer, killed
        #: merge). Zero on a healthy file; a nonzero count after loading
        #: is the signal an audit should not silently absorb.
        self.n_corrupt = 0

    # -- writing ----------------------------------------------------------

    def _append(self, obj: dict) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        header = None
        heal = False
        if not self.path.exists() or self.path.stat().st_size == 0:
            if obj.get("kind") != "schema":
                header = dict(kind="schema", version=SCHEMA_VERSION)
        else:
            # a killed writer can leave the file without a trailing
            # newline (torn tail); appending straight onto it would glue
            # the new line into the garbage and silently lose *this*
            # append on the next load — terminate the torn line first so
            # it is skipped alone
            with open(self.path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                heal = f.read(1) != b"\n"
        with open(self.path, "a") as f:
            if heal:
                f.write("\n")
            if header is not None:
                f.write(json.dumps(header, sort_keys=True) + "\n")
            f.write(json.dumps(obj, sort_keys=True) + "\n")
            f.flush()

    def append_meta(self, **fields) -> None:
        """Append a free-form metadata line (``kind="meta"``) — e.g. the
        archive-registration stamp. Meta lines are bookkeeping, not data:
        they are excluded from the store's content identity
        (:meth:`~repro_torch.history.RunArchive.register` hashes around them),
        so stamping a store does not turn it into a different run."""
        self._append(dict(kind="meta", **_jsonable(fields)))

    def meta(self) -> dict:
        """All metadata lines merged in file order (later stamps win)."""
        out: dict = {}
        for obj in self._lines():
            if obj.get("kind") == "meta":
                out.update({k: v for k, v in obj.items() if k != "kind"})
        return out

    def schema_version(self) -> int:
        """The file's declared schema version (0 = legacy, pre-header)."""
        if not self.path.exists():
            return SCHEMA_VERSION
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    return 0
                if isinstance(obj, dict) and obj.get("kind") == "schema":
                    v = obj.get("version")
                    return v if isinstance(v, int) else 0
                return 0
        return 0

    def append_campaign(self, factors: FactorSet, spec: dict | None = None,
                        snapshot: StoreSnapshot | None = None) -> str:
        """Declare a campaign; returns its fingerprint.

        Campaign identity is the *factor* fingerprint, deliberately not the
        spec's case list: growing a campaign with new cases or message
        sizes under unchanged experimental conditions is a resume of the
        same experiment, not a new one (cells are keyed per case x epoch).
        A fingerprint already declared with the same spec is not
        re-declared — which is what makes re-running a *resume* — but a
        changed spec appends a fresh declaration so the file's last
        declaration always describes the data actually in it.

        With a ``snapshot``, the already-declared check consults it
        instead of re-scanning the file (and updates it on append).
        """
        fp = factors.fingerprint()
        spec = spec or {}
        if snapshot is not None:
            last_spec = snapshot.campaign_specs.get(fp)
        else:
            last_spec = None
            for obj in self._lines():
                if obj.get("kind") == "campaign" and obj["fingerprint"] == fp:
                    last_spec = obj.get("spec", {})
        if last_spec != spec:
            self._append(dict(kind="campaign", fingerprint=fp,
                              factors=factors.to_dict(), spec=spec))
            if snapshot is not None:
                snapshot.campaign_specs[fp] = spec
                snapshot.campaign_factors[fp] = factors.to_dict()
        return fp

    def append_record(self, fingerprint: str, rec: MeasurementRecord) -> None:
        meta = _jsonable(rec.meta)
        # host is excluded from the fingerprint by design; without it in the
        # record meta a merged multi-host store cannot attribute its cells
        meta.setdefault("host", platform.node())
        self._append(dict(
            kind="record", fingerprint=fingerprint,
            op=rec.case.op, msize=int(rec.case.msize), epoch=int(rec.epoch),
            times=[float(t) for t in np.asarray(rec.times, np.float64)],
            invalid_fraction=float(rec.invalid_fraction),
            meta=meta,
        ))

    # -- sweep manifests ---------------------------------------------------

    def append_sweep(self, manifest: dict,
                     snapshot: StoreSnapshot | None = None) -> str:
        """Declare a factor sweep; returns its deterministic sweep id.

        The manifest (grid axes, per-cell levels and fingerprints, spec
        meta) is the map that lets one JSONL file hold a whole sweep: the
        campaign/record lines carry the measurements, the sweep line says
        which fingerprints form the grid, and :meth:`append_sweep_cell`
        markers make resume *cell*-granular. The id is a hash of the
        manifest content, so re-declaring the same sweep is a no-op and a
        re-run finds its own markers.
        """
        blob = json.dumps(manifest, sort_keys=True, default=str)
        sweep_id = hashlib.sha256(blob.encode()).hexdigest()[:16]
        if snapshot is not None:
            if sweep_id in snapshot.sweeps:
                return sweep_id
        else:
            for obj in self._lines():
                if obj.get("kind") == "sweep" and obj["sweep"] == sweep_id:
                    return sweep_id
        self._append(dict(kind="sweep", sweep=sweep_id, manifest=manifest))
        if snapshot is not None:
            snapshot.sweeps.append(sweep_id)
        return sweep_id

    def append_sweep_cell(self, sweep_id: str, index: int,
                          fingerprint: str) -> None:
        """Mark one grid cell as completely measured (its campaign records
        are already in the file). Written *after* the cell's last record,
        so a killed sweep never marks a half-measured cell."""
        self._append(dict(kind="sweep-cell", sweep=sweep_id,
                          cell=int(index), fingerprint=fingerprint))

    def append_sweep_cell_failed(self, sweep_id: str, index: int,
                                 fingerprint: str, attempts: int,
                                 error: str) -> None:
        """Quarantine one grid cell: every retry failed, and the sweep is
        degrading to partial-but-honest results instead of wedging. The
        record carries the factor fingerprint and the last error, so the
        analysis layer can say exactly *which* experiment is missing and
        why — a silently absent cell would bias which cells get measured,
        the §5.2 failure mode a fleet must not have."""
        self._append(dict(kind="sweep-cell-failed", sweep=sweep_id,
                          cell=int(index), fingerprint=fingerprint,
                          attempts=int(attempts), error=str(error)[:500]))

    def append_sweep_alloc(self, sweep_id: str, round: int, cells: list[int],
                           epochs: tuple[int, int], decisions: dict,
                           spent_nrep: int, policy: str) -> None:
        """Record one completed allocation round of a budgeted sweep: the
        cells that received budget, the launch-epoch window ``[lo, hi)``
        measured, and the per-axis verdicts the policy reached at this
        look. Written *after* the round's last record, so a killed sweep
        either replays the persisted verdicts (line present) or
        re-derives them from exactly the records the round produced (line
        absent, measurements record-granular resumable) — both paths land
        on the same allocation sequence."""
        self._append(dict(
            kind="sweep-alloc", sweep=sweep_id, round=int(round),
            cells=[int(c) for c in cells],
            epochs=[int(epochs[0]), int(epochs[1])],
            decisions=_jsonable(decisions), spent_nrep=int(spent_nrep),
            policy=str(policy)))

    def sweep_allocs(self, sweep_id: str) -> list[dict]:
        """Allocation-round lines of a sweep, ordered by round index.

        Duplicate round indices keep the *first* occurrence: a resumed
        run that re-appended an identical line (crash between append and
        the next read) must not shadow the decision the original run
        acted on."""
        rounds: dict[int, dict] = {}
        for o in self._lines():
            if o.get("kind") == "sweep-alloc" and o["sweep"] == sweep_id:
                rounds.setdefault(int(o["round"]), o)
        return [rounds[k] for k in sorted(rounds)]

    # -- calibration manifests --------------------------------------------

    def append_calib(self, manifest: dict,
                     snapshot: StoreSnapshot | None = None) -> str:
        """Declare a calibration fit; returns its deterministic calib id.

        The manifest (parameter space bounds, target fingerprint, case
        list, design meta) plays the role :meth:`append_sweep`'s does for
        sweeps: the id is a hash of the manifest content, so re-running
        the same fit finds its own ``calib-round`` lines and resumes the
        search instead of restarting it."""
        blob = json.dumps(manifest, sort_keys=True, default=str)
        calib_id = hashlib.sha256(blob.encode()).hexdigest()[:16]
        if snapshot is not None:
            if calib_id in snapshot.calibs:
                return calib_id
        else:
            for obj in self._lines():
                if obj.get("kind") == "calib" and obj["calib"] == calib_id:
                    return calib_id
        self._append(dict(kind="calib", calib=calib_id, manifest=manifest))
        if snapshot is not None:
            snapshot.calibs.append(calib_id)
            snapshot.calib_manifests[calib_id] = manifest
        return calib_id

    def append_calib_round(self, calib_id: str, round: int, params: dict,
                           objective: float, step: float, evals: list,
                           spent_nrep: int) -> None:
        """Record one completed search round of a calibration fit: the
        incumbent parameter vector and objective after the round, the
        step size the next round starts from, and every (params,
        objective) evaluation the round made. Written *after* the round's
        last measurement, so a killed fit either replays the persisted
        round (line present) or re-evaluates through store-resumed
        campaigns (line absent) — both paths land on the same search
        trajectory."""
        self._append(dict(
            kind="calib-round", calib=calib_id, round=int(round),
            params=_jsonable(params), objective=float(objective),
            step=float(step), evals=_jsonable_value(evals),
            spent_nrep=int(spent_nrep)))

    def calib_rounds(self, calib_id: str) -> list[dict]:
        """Round lines of a calibration fit, ordered by round index.
        Duplicate round indices keep the *first* occurrence (same
        rationale as :meth:`sweep_allocs`)."""
        rounds: dict[int, dict] = {}
        for o in self._lines():
            if o.get("kind") == "calib-round" and o["calib"] == calib_id:
                rounds.setdefault(int(o["round"]), o)
        return [rounds[k] for k in sorted(rounds)]

    def calib_manifest(self, calib_id: str | None = None) -> dict:
        """The declared manifest of a calibration fit (default: last)."""
        out: dict | None = None
        for obj in self._lines():
            if obj.get("kind") != "calib":
                continue
            if calib_id is None or obj["calib"] == calib_id:
                out = obj["manifest"]
        if out is None:
            raise KeyError(f"no calib {calib_id!r} in {self.path}")
        return out

    def sweep_cells_failed(self, sweep_id: str) -> dict[int, dict]:
        """``cell index -> quarantine info`` of every quarantined cell.

        A cell later marked complete (a resumed fleet re-attempted it and
        succeeded) is *removed*: completion supersedes quarantine."""
        out: dict[int, dict] = {}
        for o in self._lines():
            if o.get("kind") == "sweep-cell-failed" and o["sweep"] == sweep_id:
                out[int(o["cell"])] = dict(
                    fingerprint=o["fingerprint"],
                    attempts=int(o.get("attempts", 0)),
                    error=o.get("error", ""))
            elif o.get("kind") == "sweep-cell" and o["sweep"] == sweep_id:
                out.pop(int(o["cell"]), None)
        return out

    def sweeps(self) -> list[str]:
        """Sweep ids in declaration order."""
        out: list[str] = []
        for obj in self._lines():
            if obj.get("kind") == "sweep" and obj["sweep"] not in out:
                out.append(obj["sweep"])
        return out

    def sweep_manifest(self, sweep_id: str | None = None) -> dict:
        """The declared manifest of a sweep (default: the last one)."""
        out: dict | None = None
        for obj in self._lines():
            if obj.get("kind") != "sweep":
                continue
            if sweep_id is None or obj["sweep"] == sweep_id:
                out = obj["manifest"]
        if out is None:
            raise KeyError(f"no sweep {sweep_id!r} in {self.path}")
        return out

    def sweep_cells(self, sweep_id: str) -> dict[int, str]:
        """``cell index -> fingerprint`` of every *completed* cell."""
        return {int(o["cell"]): o["fingerprint"]
                for o in self._lines()
                if o.get("kind") == "sweep-cell" and o["sweep"] == sweep_id}

    def snapshot(self) -> StoreSnapshot:
        """Index the whole file in one pass (see :class:`StoreSnapshot`)."""
        snap = StoreSnapshot()
        for o in self._lines():
            kind = o.get("kind")
            if kind == "campaign":
                snap.campaign_specs[o["fingerprint"]] = o.get("spec", {})
                snap.campaign_factors[o["fingerprint"]] = o.get("factors", {})
            elif kind == "record":
                snap.records.setdefault(o["fingerprint"],
                                        []).append(_record_from(o))
            elif kind == "sweep":
                if o["sweep"] not in snap.sweeps:
                    snap.sweeps.append(o["sweep"])
                snap.manifests[o["sweep"]] = o.get("manifest", {})
            elif kind == "sweep-cell":
                snap.sweep_cells_by_id.setdefault(
                    o["sweep"], {})[int(o["cell"])] = o["fingerprint"]
                # completion supersedes an earlier quarantine of the cell
                snap.sweep_failed_by_id.get(o["sweep"], {}).pop(
                    int(o["cell"]), None)
            elif kind == "sweep-cell-failed":
                snap.sweep_failed_by_id.setdefault(o["sweep"], {})[
                    int(o["cell"])] = dict(
                        fingerprint=o["fingerprint"],
                        attempts=int(o.get("attempts", 0)),
                        error=o.get("error", ""))
            elif kind == "sweep-alloc":
                rounds = snap.sweep_alloc_by_id.setdefault(o["sweep"], [])
                if not any(int(r["round"]) == int(o["round"])
                           for r in rounds):
                    rounds.append(o)
                    rounds.sort(key=lambda r: int(r["round"]))
            elif kind == "calib":
                if o["calib"] not in snap.calibs:
                    snap.calibs.append(o["calib"])
                snap.calib_manifests[o["calib"]] = o.get("manifest", {})
            elif kind == "calib-round":
                rounds = snap.calib_rounds_by_id.setdefault(o["calib"], [])
                if not any(int(r["round"]) == int(o["round"])
                           for r in rounds):
                    rounds.append(o)
                    rounds.sort(key=lambda r: int(r["round"]))
        snap.n_corrupt = self.n_corrupt
        return snap

    # -- reading ----------------------------------------------------------

    def _lines(self) -> Iterable[dict]:
        self.n_corrupt = 0
        if not self.path.exists():
            return
        with open(self.path) as f:
            raw = f.readlines()
        last_lineno = len(raw)
        for lineno, line in enumerate(raw, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                self.n_corrupt += 1
                kind = _line_kind(line)
                if lineno == last_lineno:
                    # A truncated tail line (crashed writer) is expected
                    # and safe to drop — the cell was never fully measured
                    # — but dropping it *silently* hides that a campaign
                    # was killed mid-write.
                    warn_external(
                        f"{self.path}:{lineno}: dropping undecodable "
                        f"{kind} tail line (truncated write from a killed "
                        "campaign); the cell it held will be re-measured "
                        "on resume", RuntimeWarning)
                else:
                    # Corruption *mid*-file cannot come from an ordinary
                    # kill (appends are line-atomic); it is the residue of
                    # a crash during a merge/compaction, or real file
                    # damage — louder wording, and the count survives in
                    # ``n_corrupt`` so audits can report it.
                    warn_external(
                        f"{self.path}:{lineno}: dropping undecodable "
                        f"{kind} line mid-file (crash during a store "
                        "merge, or file corruption); "
                        f"{self.n_corrupt} corrupt line(s) so far — "
                        "counted in store.n_corrupt", RuntimeWarning)
                continue
            if isinstance(obj, dict) and obj.get("kind") == "schema":
                # A *future* version is the one skew this reader must
                # not paper over: its line kinds may look like ours but
                # mean something else, and warn-and-drop would silently
                # re-measure (or worse, merge) a resumed campaign.
                version = obj.get("version")
                if not isinstance(version, int) \
                        or version > SCHEMA_VERSION:
                    raise ValueError(
                        f"{self.path}: store declares schema version "
                        f"{version!r}, but this build reads <= "
                        f"{SCHEMA_VERSION} — refusing to load (upgrade "
                        "the reader, or re-measure into a fresh store)")
                continue
            yield obj

    def fingerprints(self) -> list[str]:
        """Campaign fingerprints in file (declaration) order."""
        seen: list[str] = []
        for obj in self._lines():
            if obj.get("kind") == "campaign" and obj["fingerprint"] not in seen:
                seen.append(obj["fingerprint"])
        return seen

    def factors(self, fingerprint: str | None = None) -> dict:
        """The declared factor dict of a campaign (default: the last one)."""
        out: dict | None = None
        for obj in self._lines():
            if obj.get("kind") != "campaign":
                continue
            if fingerprint is None or obj["fingerprint"] == fingerprint:
                out = obj["factors"]
        if out is None:
            raise KeyError(f"no campaign {fingerprint!r} in {self.path}")
        return out

    def completed(self, fingerprint: str) -> set[tuple[str, int, int]]:
        """``(op, msize, epoch)`` keys of every cell already measured."""
        return {(o["op"], int(o["msize"]), int(o["epoch"]))
                for o in self._lines()
                if o.get("kind") == "record"
                and o["fingerprint"] == fingerprint}

    def records(self, fingerprint: str | None = None) -> list[MeasurementRecord]:
        """Measurement records of one campaign (default: the last declared
        fingerprint), in append order."""
        if fingerprint is None:
            fps = self.fingerprints()
            if not fps:
                return []
            fingerprint = fps[-1]
        return [_record_from(o) for o in self._lines()
                if o.get("kind") == "record"
                and o["fingerprint"] == fingerprint]

    def to_table(self, fingerprint: str | None = None,
                 outlier_filter: bool = True) -> ResultTable:
        """Algorithm-6 reduction of a stored campaign — the adapter that
        lets ``compare_tables(store_a, store_b)`` work directly."""
        return analyze_records(self.records(fingerprint), outlier_filter)


def _jsonable_value(v):
    """One value made JSON-serializable, *recursively*: numpy scalars and
    arrays convert losslessly at any nesting depth (a ``meta["jit"]``
    telemetry dict or a calibration fit report full of ``np.float64`` must
    round-trip as numbers, not ``repr()`` strings), containers convert
    element-wise, and only a leaf that still defies ``json.dumps`` after
    all that degrades to its ``repr``."""
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, dict):
        return {str(k): _jsonable_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable_value(x) for x in v]
    try:
        json.dumps(v)
    except (TypeError, ValueError):
        return repr(v)
    return v


def _jsonable(meta: dict) -> dict:
    return {str(k): _jsonable_value(v) for k, v in (meta or {}).items()}
