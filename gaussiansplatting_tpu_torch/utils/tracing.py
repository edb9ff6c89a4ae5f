"""The port's tracing: stage marks on the device and host spans, on one
clock, and the launch counts of its hand-written kernels.

**Stage marks.**  ``mark(stage, where)`` launches the empty CUDA kernel
``gs_mark_<stage>`` (csrc/marks.cu) on the current stream of ``where``'s
device (a tensor or a device).  The step and the frame run as CUDA graphs
(train/graph.py), and on a replay the host runs nothing stage by stage; a
mark launched inside a captured body is a node of the graph, so every replay
shows the stage boundary on the profiler's device trace, on the trace's own
clock.  A stage runs from its mark to the next mark on the stream.  The marks
are always launched, so the graphs always hold them (about a microsecond of
the chain a mark).  On the CPU a mark does nothing.  ``mark_grad`` passes a
tensor through an identity whose backward launches a mark when the tensor's
cotangent is ready.

Where the marks sit (``STAGES``, in the order a step meets them):

- the frame (ops/rasterize.render): ``projection`` (the colour, the
  presort's rows of ops/projection.project_rows, the depth presort),
  ``pairs`` (capacity plan, expansion, tile
  sort, windows, ops/runs.py's slots to runs), ``blend`` (#1, #1p, #5 and their
  columns), ``compose``;
- the step (trainer.step_body, batched_body): the frame's four, ``loss``
  (photometric_loss), ``loss_bwd`` (launched before ``torch.autograd.grad``:
  the loss's backward), ``compose_bwd`` (the image's cotangent is ready),
  ``blend_bwd`` (the blend backward kernels), ``reduction``
  (``_reduce_to_data``), ``projection_bwd`` (the rest of the backward),
  ``adam`` (step_update: Adam, the density statistics, the metrics, and in a
  graph the state written back);
- a frame whose SH row is wider than band 1 (degree 2 or 3) at a degree of 1
  or more: ``sh`` (the SH colour, before ``projection``) and ``sh_bwd`` (its
  backward, launched when the colour's cotangent is ready: after the rest
  of ``projection_bwd``); degrees 0 and 1 launch neither;
- a surfel step (RasterConfig.primitive "surfel"): ``regularizer`` (after
  ``loss``: the depth normal, the normal consistency and the distortion
  of ops/losses.surfel_regularizers) and ``regularizer_bwd`` (their
  backward, launched when the regularizers' sum gets its cotangent, after
  ``loss_bwd``);
- the density events: ``densify``, ``opacity_reset``;
- ``end``: the last node of every captured body (train/graph.py's
  ``_Capture``).

**Host spans.**  ``with span(name):`` records a ``Span`` (name, start and end
on ``time.time_ns()``, which is the clock of the profiler's device events,
the index of the enclosing span, a request id) in a bounded buffer that
counts what it drops, while ``enabled()``: a ``torch.profiler`` capture is
running, or ``enable()`` was called.  While it records it also opens a
profiler range of the same name (torch's ``_RecordFunctionFast``: 2-4 us a
span on an H100 machine's host, against 22 us for ``record_function``), so
an exported chrome trace and ``key_averages()`` carry the span.
Otherwise it costs a flag test.  A span opened with no span open on its
thread starts a new request id, which its children carry.  The spans, by
file: train/graph.py (``graph.render_frame``, ``graph.run_steps`` and
``graph.event``, the requests; under them ``graph.copy_in``,
``graph.replay``, ``graph.clone_out``, and ``graph.capture`` with
``graph.warmup``), train/trainer.train_loop (``loop.chunk``,
``loop.pair_read``, ``loop.densify`` with ``density.draw``, ``loop.grow``,
``loop.opacity_reset``), parallel/sharded.py (``sharded.gather_strips``,
``sharded.all_reduce``).  Their readers: the benchmark's per-layer metrics
(gsbench/portspans.py) and tools/trace.py, which prints the idle time by
span and by request (``--loop`` traces the training loop's events).

**Launch counts.**  One registry of counters by name: each hand-written
kernel's launches under its wrapper's name (ops/blend.py's
``windowed_blend_*``, ops/compose.py's ``compose_fwd``, ``compose_logti``
and ``compose_bwd``, ops/runs.py's ``run_ids``, ops/projection.py's
``project_fwd`` and ``project_bwd``, ops/surfel_projection.py's
``surfel_project_{fwd,bwd}``, ops/surfel_blend.py's ``surfel_blend_{fwd,bwd}``,
ops/surfel_compose.py's ``surfel_compose_{fwd,bwd}``), to which
kernels/build.py's ``launch`` adds one a launch, the frames by SH
degree (``sh.degree_<d>``, ops/projection.py) and the surfel frames
(``primitive.surfel``, ops/rasterize.render_surfel).  A module registers its
names at 0 when it is imported (``counted``), so ``launch_counts()`` holds
every name before any launch; the CPU's plain versions count nothing.  A
CUDA graph's capture records the launches without running them, so
train/graph.py sets the counts back after a capture and adds what it
recorded on every replay (``add_launches``).  The stage marks are not
counted.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

FRAME_STAGES = ("projection", "pairs", "blend", "compose")
STEP_STAGES = FRAME_STAGES + ("loss", "loss_bwd", "compose_bwd", "blend_bwd", "reduction",
                              "projection_bwd", "adam")
# a frame of SH degree 2 or 3 (ops/rasterize._plan): its colour before
# ``projection``, the colour's backward after ``projection_bwd``
SH_STAGES = ("sh", "sh_bwd")
# a surfel step (trainer.step_body, RasterConfig.primitive "surfel"): 2DGS's
# regularizers after ``loss`` (the depth normal, the normal consistency and
# the distortion), their backward after ``loss_bwd``
SURFEL_STAGES = ("regularizer", "regularizer_bwd")
EVENT_STAGES = ("densify", "opacity_reset")
STAGES = STEP_STAGES + SH_STAGES + SURFEL_STAGES + EVENT_STAGES + ("end",)
MARK_PREFIX = "gs_mark_"
MAX_SPANS = 1 << 17

_STAGE_SET = frozenset(STAGES)


def mark(stage: str, where) -> None:
    """Launch ``gs_mark_<stage>`` on the current stream of ``where``'s
    device (a tensor or a device); nothing on the CPU."""
    if stage not in _STAGE_SET:
        raise ValueError(f"no stage mark {stage!r}; the stages are {STAGES}")
    dev = where.device if isinstance(where, torch.Tensor) else torch.device(where)
    if dev.type != "cuda":
        return
    from gaussiansplatting_tpu_torch.kernels import build

    build.launch("marks", f"{MARK_PREFIX}{stage}_launch", "", dev)


class _MarkGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, stage):
        ctx.stage = stage
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mark(ctx.stage, g)
        return g, None


def mark_grad(stage: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` through an identity whose backward launches the mark ``stage``
    when x's cotangent is ready: a CUDA tensor that autograd follows; ``x``
    itself elsewhere."""
    if x.is_cuda and x.requires_grad and torch.is_grad_enabled():
        return _MarkGrad.apply(x, stage)
    return x


class Span(NamedTuple):
    name: str
    start_ns: int     # time.time_ns()
    end_ns: int       # 0 while the span is open
    parent: int       # index in spans() of the enclosing span; -1 at a request's root
    request: int      # shared by a root span and everything under it


_lock = threading.Lock()
_local = threading.local()
_requests = itertools.count(1)
_records: list = []     # [name, start, end, parent, request]
_bound = MAX_SPANS      # the buffer's size
_dropped = 0
_forced = False


def enabled() -> bool:
    """True while spans record: a torch.profiler capture runs, or enable()
    was called."""
    return _forced or _profiler._is_profiler_enabled


def enable(on: bool = True) -> None:
    """Record spans without a profiler (``on``), or only under one again."""
    global _forced
    _forced = bool(on)


def clear() -> None:
    """Empty the buffer and its drop count.  Call it with no span open."""
    global _records, _dropped
    with _lock:
        _records, _dropped = [], 0


def spans() -> list[Span]:
    """The spans recorded since the last clear(), in the order they opened."""
    with _lock:
        return [Span(*r) for r in _records]


def dropped() -> int:
    """Spans not recorded since the last clear(): the buffer was full."""
    return _dropped


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Span:
    """One span: records itself when ``record``, and reads the clock either
    way (``start``, ``end`` in ns; ``seconds``)."""

    __slots__ = ("name", "record", "start", "end", "_slot", "_rf")

    def __init__(self, name: str, record: bool):
        self.name, self.record = name, record
        self.start = self.end = 0

    def __enter__(self):
        global _dropped
        if self.record:
            stack = _stack()
            parent, request = stack[-1] if stack else (-1, 0)
            request = request or next(_requests)
            self.start = time.time_ns()
            with _lock:
                if len(_records) < _bound:
                    slot = [self.name, self.start, 0, parent, request]
                    index = len(_records)
                    _records.append(slot)
                else:
                    slot, index = None, -1
                    _dropped += 1
            self._slot = slot
            stack.append((index, request))
            self._rf = _RecordFunctionFast(self.name)
            self._rf.__enter__()
        else:
            self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.record:
            self._rf.__exit__(*exc)
            self.end = time.time_ns()
            _stack().pop()
            if self._slot is not None:
                self._slot[2] = self.end
        else:
            self.end = time.time_ns()
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


_NULL = contextlib.nullcontext()


def span(name: str, timed: bool = False):
    """A context manager over the host span ``name``: recorded while
    enabled(), else nothing.  ``timed``: read the clock either way (the
    object has ``start``, ``end`` and ``seconds``)."""
    if _forced or _profiler._is_profiler_enabled:
        return _Span(name, True)
    return _Span(name, False) if timed else _NULL


_launches: dict[str, int] = {}


def counted(*names: str) -> None:
    """Register the counters ``names`` at 0 (a name already registered
    keeps its count)."""
    with _lock:
        for name in names:
            _launches.setdefault(name, 0)


def launch_counts() -> dict[str, int]:
    """Every registered counter's count, by name."""
    with _lock:
        return dict(_launches)


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` (name -> launches) to the registered counters; an
    unregistered name raises KeyError."""
    with _lock:
        for name, n in counts.items():
            _launches[name] += n
