"""The device trace of a ``--trace 1`` run, and its reduction.

``torch.profiler`` records the window's device operations (kernels,
copies, sets), the harness's own host annotations (``perfbench::<layer>``,
from the wrappers around the calls into each layer) and the program's spans
(``repro_torch::<name>``, which it records while a profiler records). The
reduction gives the seconds in which any device operation ran (their union
within the window), the device time of each kernel, and the idle time,
each idle gap split over the innermost annotation or span the host was in
along it (named without its prefix).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field

PREFIX = "perfbench::"
#: Prefixes of the host ranges that idle time is charged to: the harness's
#: annotations and the program's spans.
HOST_PREFIXES = (PREFIX, "repro_torch::")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class TraceData:
    window_s: float
    busy_s: float
    device_s: dict = field(default_factory=dict)      # name -> seconds
    device_n: dict = field(default_factory=dict)      # name -> count
    idle_s: dict = field(default_factory=dict)        # host range -> idle seconds


class Tracer:
    """Host annotations always cost a context manager; they record only
    while the profiler runs."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    def annotate(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(PREFIX + name)

    def start(self) -> None:
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()

    def stop(self) -> TraceData | None:
        if self.prof is None:
            return None
        self.prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self.prof = None
        return reduce(events)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(annotations):
    """Flatten properly nested ``(start, end, name)`` spans into segments
    ``(start, name)`` of the innermost one (``None`` outside all)."""
    points = sorted([(a, 1, -b, name) for a, b, name in annotations]
                    + [(b, 0, 0.0, name) for a, b, name in annotations])
    stack, segs = [], []
    for t, is_start, _, name in points:
        if is_start:
            stack.append(name)
        elif name in stack:
            stack.reverse()
            stack.remove(name)
            stack.reverse()
        segs.append((t, stack[-1] if stack else None))
    return segs


def reduce(events) -> TraceData | None:
    """Reduce chrome-trace events; ``None`` where no ``window`` annotation
    was recorded."""
    dev, notes = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        a, d = float(ev["ts"]), float(ev["dur"])
        if ev.get("cat") in DEVICE_CATS:
            dev.append((a, a + d, ev.get("name", "?")))
        elif ev.get("cat") == "user_annotation":
            name = ev.get("name", "")
            for prefix in HOST_PREFIXES:
                if name.startswith(prefix):
                    notes.append((a, a + d, prefix, name[len(prefix):]))
    windows = [(a, b) for a, b, prefix, n in notes if prefix == PREFIX and n == "window"]
    if not windows:
        return None
    w0, w1 = windows[0]
    inside = [(max(a, w0), min(b, w1), n) for a, b, n in dev if b > w0 and a < w1]
    busy = _merge((a, b) for a, b, _ in inside)
    out = TraceData(window_s=(w1 - w0) / 1e6, busy_s=sum(b - a for a, b in busy) / 1e6)
    for a, b, n in inside:
        out.device_s[n] = out.device_s.get(n, 0.0) + (b - a) / 1e6
        out.device_n[n] = out.device_n.get(n, 0) + 1
    segs = _innermost([(a, b, n) for a, b, _, n in notes if w0 <= a and b <= w1])
    starts = [t for t, _ in segs]
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        i = bisect.bisect_right(starts, a) - 1
        while a < b:
            end = min(b, starts[i + 1]) if i + 1 < len(starts) else b
            if end > a:
                label = (segs[i][1] if i >= 0 else None) or "window"
                out.idle_s[label] = out.idle_s.get(label, 0.0) + (end - a) / 1e6
            a, i = end, i + 1
    return out
