"""The port's own tracing, read from a traced run: its stage marks on the
device trace and its host spans (``gaussiansplatting_tpu_torch.utils.tracing``).

The port launches an empty kernel ``gs_mark_<stage>`` at each stage boundary
of a frame, a step and a density event, inside the bodies its CUDA graphs
capture, and ``gs_mark_end`` as the last node of every captured body.  On the
device trace a stage runs from its mark to the next mark: every other device
operation belongs to the stage of the last mark that began before it.  An
``end`` mark whose stage before it is a frame's or a step's closes one replay
(a density event's ``end`` follows ``densify`` or ``opacity_reset``).  The
device operations of a capture's eager warm-up (they begin inside a
``graph.capture`` span) count in no stage and close no replay.

Idle gaps (the window less the union of every device operation, marks
included) are charged to the innermost span open on the host when each gap
began, taking the port's spans and the benchmark's together ("host" where
none is open).  Everything is clipped to ``devtrace.window_of``.

``analysis(rec)`` returns None wherever the port has no tracing module,
recorded no span in the window or dropped spans, so a run of a commit without
them reads null; a metric that needs the marks reads null where the trace holds none.
"""

from __future__ import annotations

import bisect
import collections
import importlib

from gsbench import devtrace

MARK = "gs_mark_"
END = "end"
CAPTURE_SPAN = "graph.capture"
# the stages a frame's or a step's replay ends in
REPLAY_STAGES = ("compose", "adam")
_KEY = "_portspans"


def port_spans():
    """The port's recorded host spans as devtrace.Interval, or None where
    the port has no tracing module, or where its buffer was full and
    dropped spans (a partial set would misread every charge)."""
    try:
        mod = importlib.import_module("gaussiansplatting_tpu_torch.utils.tracing")
    except ImportError:
        return None
    read, dropped = getattr(mod, "spans", None), getattr(mod, "dropped", None)
    if read is None or dropped is None or dropped():
        return None
    return [devtrace.Interval(s[0], int(s[1]), int(s[2])) for s in read() if s[2] > s[1]]


def stages(device, lo: int, hi: int, captures) -> tuple[dict, int, int]:
    """({stage: busy ns of its non-mark operations, a union clipped to [lo,
    hi]}, replays closed by an ``end`` mark, marks seen) over the device
    operations in start order; ``captures`` the sorted disjoint intervals
    whose operations count nowhere.  Operations before the first mark go to
    the stage None."""
    starts = [s for s, _ in captures]

    def captured(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t < captures[i][1]

    by_stage = collections.defaultdict(list)
    stage, replays, marks = None, 0, 0
    for d in sorted(device, key=lambda d: d.start):
        mark = d.name[len(MARK):] if d.name.startswith(MARK) else None
        if d.end <= lo or d.start >= hi or captured(d.start):
            stage = mark or stage
            continue
        if mark is None:
            by_stage[stage].append((d.start, d.end))
            continue
        marks += 1
        if mark == END and stage in REPLAY_STAGES:
            replays += 1
        stage = mark
    return ({s: devtrace.busy_ns(iv, lo, hi) for s, iv in by_stage.items()}, replays, marks)


def idle_by_span(device, spans, lo: int, hi: int) -> dict:
    """{span name: idle ns}: each gap in the union of ``device`` inside [lo,
    hi] charged to the innermost of ``spans`` (the latest begun, then the
    shortest) open when it began, "host" where none is."""
    busy = devtrace.merged([(d.start, d.end) for d in device], lo, hi)
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    inner = sorted(spans, key=lambda s: s.start)
    totals = collections.Counter()
    open_spans, j = [], 0
    for g0, g1 in gaps:
        while j < len(inner) and inner[j].start <= g0:
            open_spans.append(inner[j])
            j += 1
        open_spans = [s for s in open_spans if s.end > g0]
        owner = (max(open_spans, key=lambda s: (s.start, s.start - s.end)).name
                 if open_spans else "host")
        totals[owner] += g1 - g0
    return dict(totals)


def analysis(rec) -> dict | None:
    """The port's stages, replays and idle charges of a traced run's
    record, computed once per record; None where the port has no tracing
    module, dropped spans or recorded none in the window."""
    if _KEY in rec:
        return rec[_KEY]
    out = None
    spans = port_spans()
    cap = rec["capture"]
    lo, hi = devtrace.window_of(cap)
    if spans is not None:
        spans = [s for s in spans if s.end > lo and s.start < hi]
    if spans:
        captures = devtrace.merged([(s.start, s.end) for s in spans if s.name == CAPTURE_SPAN],
                                   lo, hi)
        stage_ns, replays, marks = stages(cap.device, lo, hi, captures)
        bench = [s for s in cap.spans if s.name != devtrace.WINDOW_SPAN]
        out = {"stage_ns": stage_ns, "replays": replays, "marks": marks,
               "idle_ns": idle_by_span(cap.device, spans + bench, lo, hi), "spans": spans}
    rec[_KEY] = out
    return out


def stage_ms(rec, names) -> float | None:
    """Device ms a replay in the stages ``names``; None without marks."""
    a = analysis(rec)
    if a is None or not a["replays"]:
        return None
    return sum(a["stage_ns"].get(n, 0) for n in names) * 1e-6 / a["replays"]


def idle_ms(rec, names, per: str) -> float | None:
    """Idle ms charged to the spans ``names``, per replay (``per`` =
    "replay") or per pass of the training loop ("pass"); None without the
    port's spans, or without replays or passes to divide by."""
    a = analysis(rec)
    if a is None:
        return None
    n = a["replays"] if per == "replay" else rec.get("counters", {}).get("passes")
    if not n:
        return None
    return sum(a["idle_ns"].get(s, 0) for s in names) * 1e-6 / n


def mean_span_ms(rec, name: str) -> float | None:
    """The mean host duration of the port's spans ``name`` in the window,
    in ms; None where there is none."""
    a = analysis(rec)
    if a is None:
        return None
    ds = [s.end - s.start for s in a["spans"] if s.name == name]
    return sum(ds) * 1e-6 / len(ds) if ds else None
