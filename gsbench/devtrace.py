"""Reduction of a traced run: device work, busy time and idle gaps from a
``torch.profiler`` capture of the measured window.

The profiler records the device's operations alone (kernels, memory copies
and sets; no host operators, which would cost the traced run minutes to
record and read), on the host's clock in Unix nanoseconds; ``Spans`` records
the benchmark's own host spans (names that start with ``gsbench.``; the span
``gsbench.window`` encloses the measured window) on the same clock.  Device
busy time is the union of the operations' intervals inside
that window, so operations that overlap count once and the idle share never
falls below 0.  An idle gap is charged to the innermost benchmark span open
on the host when the gap began.
"""

from __future__ import annotations

import collections
import contextlib
import re
import time
from typing import NamedTuple

WINDOW_SPAN = "gsbench.window"


class Interval(NamedTuple):
    name: str
    start: int   # ns
    end: int     # ns


class Capture(NamedTuple):
    device: list   # [Interval] device operations
    spans: list    # [Interval] the benchmark's host spans


def group_name(name: str) -> str:
    """A kernel or operator name collapsed to a stable group: the function
    name without its return type, anonymous-namespace prefix, template
    arguments and parameters."""
    base = name.replace("(anonymous namespace)::", "")
    base = re.sub(r"^void ", "", base)
    base = re.split(r"[<(]", base, maxsplit=1)[0].strip()
    return base or name


class Spans:
    """The benchmark's host spans of one run: ``with spans("gsbench.call"):``
    records (name, start, end) on the host's clock when enabled, and costs a
    context manager otherwise."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.intervals = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.enabled:
            yield
            return
        start = time.time_ns()
        try:
            yield
        finally:
            self.intervals.append(Interval(name, start, time.time_ns()))


def collect(prof, spans: Spans) -> Capture:
    """Device operations of a finished profiler, and the host spans."""
    device = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CPU"):
            continue
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        if end > start:
            device.append(Interval(e.name(), start, end))
    return Capture(device, list(spans.intervals))


def window_of(cap: Capture) -> tuple[int, int]:
    w = [s for s in cap.spans if s.name == WINDOW_SPAN]
    if not w:
        raise ValueError("the capture holds no gsbench.window span")
    return w[0].start, w[0].end


def merged(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The union of ``intervals`` clipped to [lo, hi], as sorted disjoint
    (start, end) pairs."""
    out = []
    for s, e in sorted((max(i[0], lo), min(i[1], hi)) for i in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_ns(intervals, lo: int, hi: int) -> int:
    return sum(e - s for s, e in merged(intervals, lo, hi))


def device_ops(cap: Capture, top: int = 10) -> list[list]:
    """[[group, seconds]] of the groups of device operations that took the
    most time inside the window (summed durations)."""
    lo, hi = window_of(cap)
    groups = collections.Counter()
    for d in cap.device:
        s, e = max(d.start, lo), min(d.end, hi)
        if e > s:
            groups[group_name(d.name)] += (e - s) * 1e-9
    return [[n, s] for n, s in groups.most_common(top)]


def idle_gaps(cap: Capture, top: int = 10) -> list[list]:
    """[[host span, seconds]]: the device's idle time inside the window,
    charged to the innermost benchmark span open when each gap began
    ("host" where none is), the largest totals first."""
    lo, hi = window_of(cap)
    busy = merged([(d.start, d.end) for d in cap.device], lo, hi)
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    inner = sorted((s for s in cap.spans if s.name != WINDOW_SPAN), key=lambda s: s.start)
    totals = collections.Counter()
    open_spans, j = [], 0
    for g0, g1 in gaps:
        while j < len(inner) and inner[j].start <= g0:
            open_spans.append(inner[j])
            j += 1
        open_spans = [s for s in open_spans if s.end > g0]
        owner = min(open_spans, key=lambda s: s.end - s.start).name if open_spans else "host"
        totals[owner] += (g1 - g0) * 1e-9
    return [[n, s] for n, s in totals.most_common(top)]


def kernel_seconds(cap: Capture, patterns) -> float:
    """Device seconds inside the window of the operations whose name
    contains one of ``patterns``."""
    lo, hi = window_of(cap)
    total = 0
    for d in cap.device:
        if any(p in d.name for p in patterns):
            total += max(0, min(d.end, hi) - max(d.start, lo))
    return total * 1e-9
