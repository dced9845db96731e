"""Append-only persistent result store (JSONL), keyed by factor fingerprint.

The line format of the JAX package's ``repro.campaign.store`` (schema 1),
so that a store written by the port loads in the reference's
``ResultStore`` and the reference's audits, sweeps and comparisons read it:

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
      free-form metadata, excluded from the store's content identity.

Appending is atomic at line granularity and times round-trip exactly
(``json`` emits shortest-repr doubles). Undecodable lines are skipped with
a warning and counted in :attr:`ResultStore.n_corrupt`. Line kinds of later
layers (sweeps, allocation rounds, calibration fits) are not written by
this slice and are skipped on load.
"""

from __future__ import annotations

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
#: reads).
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
    """A one-pass index of a store's campaigns and records, so a run that
    consults the store several times parses the file once. Single-writer:
    the snapshot-aware append methods keep it coherent for what *this*
    process appends."""

    campaign_specs: dict = field(default_factory=dict)   # fp -> last spec
    campaign_factors: dict = field(default_factory=dict)  # fp -> factor dict
    records: dict = field(default_factory=dict)          # fp -> [records]
    n_corrupt: int = 0             # undecodable lines skipped in this pass


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
        they are excluded from the store's content identity, so stamping a
        store does not turn it into a different run."""
        self._append(dict(kind="meta", **_jsonable(fields)))

    def meta(self) -> dict:
        """All metadata lines merged in file order (later stamps win)."""
        out: dict = {}
        for obj in self._lines():
            if obj.get("kind") == "meta":
                out.update({k: v for k, v in obj.items() if k != "kind"})
        return out

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
