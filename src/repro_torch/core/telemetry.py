"""Spans and counters of the campaign path, for operators and profilers.

The program marks where its work happens: :func:`span` bounds a step
(``"sync"``, ``"topup"``, ``"engine.window"``, ...) and :func:`count` adds
to a named counter (``"engine.readbacks"``, ``"engine.grids.read"``,
``"records.valid_calls"``, ...).
They record only while recording is on, which is inside :func:`recording`
and whenever a ``torch.profiler`` session records. Otherwise a call costs
one check and records nothing. The one exception is
``"engine.dispatches"``, which always counts, because
:class:`~repro_torch.campaign.Campaign` reports each campaign's share of it
(``meta["dispatch"]["n_dispatches"]``) whether or not anyone records.

A span holds its name, its start and end on ``time.perf_counter_ns()``,
its parent (the span open around it on the main thread; a span opened on
any other thread records nothing) and its identifiers: the keywords given
to :func:`span`, merged over its parent's, so every span under a record
carries the record's campaign, epoch, op and message size. While a
profiler records, each span also opens
``torch.profiler.record_function("repro_torch::<name>")``, so the spans
lie in the profiler's own timeline, on the clock of the device's kernels
and copies, and its chrome trace exports them.

:func:`snapshot` returns what was recorded since recording last turned on
(a profiler session that starts, or a :func:`recording` block entered):
the spans, per span name their count, total and self seconds (the total
less the time their child spans cover), and the counters.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch

__all__ = ["span", "spanned", "count", "recording", "snapshot", "reset",
           "dispatches", "PREFIX", "DISPATCHES"]

#: Prefix of the spans' ranges in a profiler's trace.
PREFIX = "repro_torch::"
#: The counter that counts with recording off too.
DISPATCHES = "engine.dispatches"

_profiler_enabled = torch._C._autograd._profiler_enabled
_MAIN = threading.main_thread().ident


class _Store:
    """What was recorded since recording last turned on."""

    def __init__(self):
        self.spans: list = []           # _Span, in the order they opened
        self.stack: list[int] = []
        self.counts: dict[str, int] = {}


class _Recorder:
    def __init__(self):
        self.forced = 0              # depth of open recording() blocks
        self.live = False            # recording at the last call
        self.dispatches = 0          # engine dispatches over the process's life
        self.store = _Store()
        self.lock = threading.Lock()


_REC = _Recorder()


def _on() -> bool:
    if _REC.forced or _profiler_enabled():
        if not _REC.live:            # recording turned on: a fresh store
            _REC.store, _REC.live = _Store(), True
        return True
    _REC.live = False
    return False


class _Span:
    """One recorded span, and the context manager that records it. It
    starts as it is made and ends as it exits, so its own bookkeeping lies
    inside it; ``end_ns`` is ``None`` while it is open."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "ids", "store", "fn")

    def __init__(self, name: str, ids: dict):
        self.start_ns = time.perf_counter_ns()
        store = self.store = _REC.store
        parent = self.parent = store.stack[-1] if store.stack else None
        if parent is not None and store.spans[parent].ids:
            ids = {**store.spans[parent].ids, **ids}
        self.name, self.ids, self.end_ns = name, ids, None
        self.fn = (torch.profiler.record_function(PREFIX + name)
                   if _profiler_enabled() else None)
        store.stack.append(len(store.spans))
        store.spans.append(self)

    def __enter__(self):
        if self.fn is not None:
            self.fn.__enter__()
        return self

    def __exit__(self, *exc):
        if self.fn is not None:
            self.fn.__exit__(*exc)
        store, self.store, self.fn = self.store, None, None
        if store.stack and store.spans[store.stack[-1]] is self:
            store.stack.pop()
        self.end_ns = time.perf_counter_ns()
        return False


_NULL = contextlib.nullcontext()


def span(name: str, **ids):
    """A context manager bounding one step of work called ``name``; its
    keywords identify what the step works on (``campaign``, ``epoch``,
    ``epochs``, ``op``, ``msize``, ``fused``). Records only while recording
    is on, and only on the main thread."""
    if _on() and threading.get_ident() == _MAIN:
        return _Span(name, ids)
    return _NULL


def spanned(name: str):
    """Decorator: every call of the function is a span called ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while recording is on
    (``"engine.dispatches"`` also counts with recording off)."""
    if name == DISPATCHES:
        _REC.dispatches += n
    if _on():
        with _REC.lock:
            counts = _REC.store.counts
            counts[name] = counts.get(name, 0) + n


def dispatches() -> int:
    """Engine dispatches (sample and window calls) over the process's life,
    counted with recording on or off."""
    return _REC.dispatches


@contextlib.contextmanager
def recording():
    """Record inside the block, starting from an empty store; what it
    recorded stays readable by :func:`snapshot` after the block until
    recording next turns on."""
    _REC.forced += 1
    if _REC.forced == 1:
        _REC.store = _Store()
        _REC.live = True
    try:
        yield
    finally:
        _REC.forced -= 1
        if _REC.forced == 0:         # a profiler that starts next starts afresh
            _REC.live = _profiler_enabled()


def reset() -> None:
    """Empty the store and zero the dispatch count."""
    _REC.store = _Store()
    _REC.dispatches = 0


def snapshot() -> dict:
    """What was recorded since recording last turned on: ``spans``, a list
    of ``{"name", "start_ns", "end_ns", "parent", "ids", "self_ns"}`` in the
    order they opened (``parent`` is an index into the list, or ``None``;
    an open span has ``end_ns`` and ``self_ns`` ``None``); ``totals``,
    ``{name: {"count", "total_s", "self_s"}}`` over the closed spans; and
    ``counters``, ``{name: n}``."""
    store = _REC.store
    spans = list(store.spans)
    child_ns = [0] * len(spans)
    for s in spans:
        if s.end_ns is not None and s.parent is not None:
            child_ns[s.parent] += s.end_ns - s.start_ns
    out, totals = [], {}
    for i, s in enumerate(spans):
        dur = None if s.end_ns is None else s.end_ns - s.start_ns
        self_ns = None if dur is None else dur - child_ns[i]
        out.append(dict(name=s.name, start_ns=s.start_ns, end_ns=s.end_ns,
                        parent=s.parent, ids=dict(s.ids), self_ns=self_ns))
        if dur is not None:
            t = totals.setdefault(s.name, dict(count=0, total_s=0.0, self_s=0.0))
            t["count"] += 1
            t["total_s"] += dur / 1e9
            t["self_s"] += self_ns / 1e9
    with _REC.lock:
        counters = dict(store.counts)
    return dict(spans=out, totals=totals, counters=counters)
