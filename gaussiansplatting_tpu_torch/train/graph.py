"""The compiled dispatch of the port: the train step, the batched train step,
the inference render, the sharded steps and render, the density events and
the garden's ray tracer, each captured once per static key as a CUDA graph,
then replayed.  This module is the port's counterpart of every ``jax.jit``
of the JAX package:

- ``train_step = jax.jit(_train_step_impl)`` and the ``lax.scan`` program
  of ``train_steps`` (gaussiansplatting_tpu/train/trainer.py:93-123):
  ``run_steps`` with ``trainer.step_body``, one view per replay;
- ``jax.jit(train_step_batched)`` (trainer.py:141): ``run_steps`` with
  ``trainer.batched_body``, K views per replay;
- ``jax.jit(render, static_argnums=2)`` of the tools and the facade
  (tools/render.py:78, tools/view.py:132, tools/evaluate.py:61,
  tools/train.py:295, 336, 362, tools/bench_train.py:92,
  models/gaussian_model.py:126): ``render_frame``;
- ``jax.jit`` of the sharded step, batched step and render
  (parallel/sharded.py:166, 283, 316): ``run_sharded_steps`` and
  ``run_sharded_render`` with parallel/sharded.py's module-level bodies, on
  a CUDA rank of an NCCL group (gloo's collectives run on the host, where
  no capture can hold them: its ranks run the bodies op by op);
- ``jax.jit(densify_step)`` and ``jax.jit(opacity_reset_step)``
  (train/trainer.py:219, 243): ``run_event`` (``event_key``: the capacity,
  the device, the SH width, the DensityConfig and the scene extent; the
  iteration, the split draw and the focal length are inputs);
- ``_render_view_jit`` (utils/scenegen.py:228-250): ``run_trace``
  (``trace_key``: the resolution, the intrinsics and the device; the pose
  is an input).

JAX compiles once per static argument set and runs K steps as one program.
Here a step is captured once per key (``step_key``: the Gaussian capacity,
the resolution, the device, the frozen Config, which holds the pair
capacity, and the SH width; with the body and its views per replay) and
replayed K times.  A replay reads the state, the cameras, the ground truth
and the step's scalars (position LR, Adam's bias corrections) from static
buffers and ends by copying the new state into the state buffers it read,
so K replays chain K steps.  Camera pose, ground truth, the timestep and
total_iters are inputs, not part of the key.  A render is captured once per
``render_key`` (capacity, resolution, device, the frozen RasterConfig, SH
width); a replay reads the parameters and the camera from static buffers.

``run_steps`` and ``render_frame`` keep the port's functional contract:
they copy the caller's state (parameters) into the buffers, return clones,
and leave the input as it was (the JAX program donates its input instead).

Capture: an eager warm-up call on a side stream (it loads the kernels'
libraries, creates cuBLAS's handle for the stream and fills the cached SSIM
band matrices), then the capture of one call on that stream, into the
graph's own memory pool.  A capture that fails raises, naming the op where
it failed; nothing falls back to eager calls.  The capture records the
blend kernels' launches without running them: ops.blend's counters are set
back after it, and every replay adds what the capture recorded.  The
capture mode is ``thread_local``: the viewer captures in an HTTP handler
thread while other handler threads build their cameras on the card, and in
torch's default ``global`` mode such a copy fails in the other thread and
invalidates the capture (chip_smoke.py phase 13 runs both modes beside such
a thread); the capturing thread itself is still held to the capture's
rules.

Each kind of graph has a bounded cache of its own (MAX_GRAPHS steps,
MAX_RENDER_GRAPHS renders, MAX_SHARDED_GRAPHS sharded calls,
MAX_DENSITY_GRAPHS density events, MAX_TRACE_GRAPHS tracer views): the
least recently used is freed with its pool before a new key is captured
(another pair capacity, a grown state, another resolution or mode), so a
tool that renders between steps, or a loop that densifies between steps,
keeps its step graph.  The sharded cache holds only graphs whose
collectives every rank of a mesh runs: each rank of the mesh makes the same
sharded calls in the same order, so every rank captures, replays and evicts
alike (a rank that captured alone would wait in its warm-up's first
collective for ranks that replay).  The caches are not locked: callers
that share them across threads (tools/view.py) hold one lock around every
call.

Tracing (utils/tracing.py): every captured body ends with the ``end`` stage
mark, the last node of its graph, so a device trace counts replays.  Each
call is a request span (``graph.run_steps``, ``graph.render_frame``,
``graph.event``) over ``graph.copy_in``, one
``graph.replay`` a replay (with that replay's view copies) and
``graph.clone_out``, and a capture is ``graph.capture`` over its
``graph.warmup``; the spans record only under a profiler or after
``tracing.enable()``.
"""

from __future__ import annotations

import collections
import os
import time
import traceback

import torch

from gaussiansplatting_tpu_torch.core.gaussians import FIELDS, GaussianParams
from gaussiansplatting_tpu_torch.density.control import DensityAccum
from gaussiansplatting_tpu_torch.ops import blend, rasterize
from gaussiansplatting_tpu_torch.train.optimizer import TRAINABLE, AdamState
from gaussiansplatting_tpu_torch.train.state import TrainState
from gaussiansplatting_tpu_torch.utils import tracing

MAX_GRAPHS = 2          # two are enough for steps that alternate between two modes
MAX_RENDER_GRAPHS = 2   # tools.train renders its snapshots and its held-out views
MAX_SHARDED_GRAPHS = 3  # a mesh's sharded step, batched step and render
MAX_DENSITY_GRAPHS = 2  # densify_step and opacity_reset_step
MAX_TRACE_GRAPHS = 2    # the dataset's resolution and one other
WARMUP_STEPS = 1
CAPTURE_MODE = "thread_local"
_ACCUM = ("grad_accum", "grad_count", "pos_grad_accum")

# captures and warm-up calls run in this process: "captures" and
# "warmup_steps" (views a step's warm-up renders: each launches its mode's
# forward and backward kernels once), "render_captures" and
# "warmup_renders" (each launches its mode's forward kernels once),
# "sharded_captures" (sharded steps and renders; their warm-up calls count
# in "warmup_steps" and "warmup_renders"), "density_captures" and
# "warmup_events", "trace_captures" and "warmup_traces" (these two warm-ups
# launch no blend kernel)
counts: collections.Counter = collections.Counter()


def step_key(state: TrainState, camera, cfg) -> tuple:
    """What a captured step is specific to: the Gaussian capacity, the
    render resolution, the device, the Config (with its pair capacity) and
    the SH width (a buffer of another width would take the copy in by
    broadcasting)."""
    p = state.params
    return (p.capacity, (camera.width, camera.height), p.means.device, cfg, p.sh.shape[1])


def graph_key(body, views, state: TrainState, camera, cfg) -> tuple:
    """The step cache's key: the body, its views per replay (None: one
    view, trainer.step_body) and step_key."""
    return (body, views) + step_key(state, camera, cfg)


def render_key(params: GaussianParams, camera, raster_cfg) -> tuple:
    """What a captured render is specific to: as step_key, with the
    RasterConfig (pair capacity, t_floor_exact, payload_dtype, ...)."""
    return (params.capacity, (camera.width, camera.height), params.means.device, raster_cfg,
            params.sh.shape[1])


def sharded_key(body, views, mesh, backend: str, chunks, state: TrainState, camera,
                cfg) -> tuple:
    """The sharded cache's key of a sharded step: the body, its views per
    replay, the mesh's size and this rank, the group's backend, the
    gradient all-reduce's chunks and step_key (not the group object: a
    mesh of one size holds the first ``size`` ranks, parallel/mesh.py)."""
    return (body, views, mesh.size, mesh.rank, backend, chunks) + step_key(state, camera, cfg)


def sharded_render_key(body, mesh, backend: str, params: GaussianParams, camera,
                       raster_cfg) -> tuple:
    """The sharded cache's key of a sharded render: as sharded_key, with
    render_key."""
    return (body, None, mesh.size, mesh.rank, backend, None) + render_key(params, camera,
                                                                          raster_cfg)


def event_key(body, state: TrainState, cfg, scene_extent=None) -> tuple:
    """What a captured density event is specific to: its body, the
    capacity, the device, the SH width, the DensityConfig and the scene
    extent (densify's thresholds scale with it; None for the opacity
    reset).  The iteration, the split draw and the focal length are
    inputs."""
    p = state.params
    return (body, p.capacity, p.means.device, p.sh.shape[1], cfg.density, scene_extent)


def trace_key(fx, fy, cx, cy, width: int, height: int, device) -> tuple:
    """What a captured garden view is specific to: the intrinsics, the
    resolution and the device (the pose is an input)."""
    return (fx, fy, cx, cy, width, height, torch.device(device))


def state_tensors(state: TrainState) -> list[torch.Tensor]:
    """The state's tensors in a fixed order: the parameters, Adam's m and v,
    the density accumulators."""
    p, o, a = state.params, state.opt, state.accum
    return ([getattr(p, f).detach() for f in FIELDS] + [o.m[f] for f in TRAINABLE]
            + [o.v[f] for f in TRAINABLE] + [getattr(a, f) for f in _ACCUM])


def _state_of(tensors, t: int, generator) -> TrainState:
    """The TrainState over ``tensors`` (state_tensors' order), sharing them."""
    n, k = len(FIELDS), len(TRAINABLE)
    opt = AdamState(m=dict(zip(TRAINABLE, tensors[n:n + k])),
                    v=dict(zip(TRAINABLE, tensors[n + k:n + 2 * k])), t=t)
    return TrainState(GaussianParams(*tensors[:n]), opt, DensityAccum(*tensors[n + 2 * k:]),
                      generator)


def _where(exc: BaseException) -> str:
    """The innermost frame outside torch (and this module) in ``exc``'s
    traceback, or in the exception it was raised while handling: the op a
    failed capture stopped at."""
    skip = (os.path.dirname(os.path.abspath(torch.__file__)), os.path.abspath(__file__))
    while exc is not None:
        frames = [f for f in traceback.extract_tb(exc.__traceback__)
                  if not os.path.abspath(f.filename).startswith(skip)]
        if frames:
            f = frames[-1]
            return f"{f.filename}:{f.lineno} ({f.line})"
        exc = exc.__context__
    return "an op of the backward (no Python frame of the step)"


def _clones(out):
    """Clones of every tensor of ``out``: a tensor, or a (named) tuple of
    them, nested."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    parts = (_clones(x) for x in out)
    return type(out)(*parts) if hasattr(out, "_fields") else type(out)(parts)


def _pool_bytes(pool, dev) -> int:
    """The bytes of the segments of the private memory pool ``pool`` on
    ``dev`` (torch.cuda.memory_snapshot)."""
    index = torch.device(dev).index
    index = torch.cuda.current_device() if index is None else index
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == index and tuple(seg["segment_pool_id"]) == pool)


class _Capture:
    """``warm()`` run once eagerly on a side stream, then one call of
    ``fn()`` captured on that stream into a new CUDA graph (see the module
    docstring), each ended by the ``end`` stage mark (utils/tracing.py),
    under the spans ``graph.capture`` and its child ``graph.warmup``.  Holds
    the graph, fn's output (static tensors the replays rewrite), the
    launches the capture recorded, the graph's memory pool and device,
    ``warmup_s`` (the warm-up call, synchronized, from its span's clock
    reads) and ``capture_s`` (the capture, synchronized: from after
    ``empty_cache`` to the end of ``graph.capture``).  ``free_cache``:
    return the allocator's cached blocks to the device before the capture
    (a step's or a frame's pool is gigabytes); a density event or a traced
    view captures a small pool mid-run, where emptying a trainer's cache
    cost 0.3 s on an H100."""

    def __init__(self, warm, fn, dev, what: str, free_cache: bool = True):
        with tracing.span("graph.capture", timed=True) as whole:
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with tracing.span("graph.warmup", timed=True) as warmup:
                with torch.cuda.stream(stream):
                    warm()
                    tracing.mark("end", dev)
                torch.cuda.current_stream(dev).wait_stream(stream)
                torch.cuda.synchronize(dev)
            if free_cache:
                torch.cuda.empty_cache()
            start = time.time_ns()
            before = blend.launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(self.graph, stream=stream,
                                      capture_error_mode=CAPTURE_MODE):
                    self.out = fn()
                    tracing.mark("end", dev)
            except Exception as e:
                raise RuntimeError(f"capturing {what} failed at {_where(e)}: {e}") from e
            finally:
                after = blend.launch_counts()
                blend.add_launches({k: before[k] - after[k] for k in before})
            torch.cuda.synchronize(dev)
        self.warmup_s = warmup.seconds
        self.capture_s = (whole.end - start) * 1e-9
        self.launches = {k: after[k] - before[k] for k in before if after[k] != before[k]}
        self.pool, self.dev = tuple(self.graph.pool()), dev


class _Graph:
    """What every kind of graph keeps of its capture: the graph, the
    launches it recorded, warmup_s and capture_s, and ``pool_bytes``, the
    bytes of its memory pool, read at first use (it walks every segment of
    the device)."""

    def _keep(self, c: _Capture) -> None:
        self.graph, self.launches = c.graph, c.launches
        self.warmup_s, self.capture_s = c.warmup_s, c.capture_s
        self._pool, self._dev, self._pool_bytes = c.pool, c.dev, None

    @property
    def pool_bytes(self) -> int:
        if self._pool_bytes is None:
            self._pool_bytes = _pool_bytes(self._pool, self._dev)
        return self._pool_bytes


class StepGraph(_Graph):
    """One captured step of ``body`` for one key.  ``views`` None: the
    body is ``body(state, camera, gt [H, W, 3], cfg, scalars, *extra)`` and
    a replay reads one view (trainer.step_body, sharded.step_body);
    ``views`` K: the body is ``body(state, K cameras, gts [K, H, W, 3], cfg,
    scalars, *extra)`` and a replay reads K views (trainer.batched_body,
    sharded.batched_body).  Either returns (state, metrics NamedTuple of 0-d
    tensors).  ``extra``: the sharded bodies' mesh and chunks; ``counter``:
    the entry of ``counts`` the capture adds one to."""

    def __init__(self, body, state: TrainState, cameras, gts, cfg, views: int | None = None,
                 extra: tuple = (), what: str | None = None, counter: str = "captures"):
        dev = state.params.means.device
        n = views or 1
        self.key = step_key(state, cameras[0], cfg)
        self.views = views
        with torch.no_grad():
            self.tensors = [x.clone() for x in state_tensors(state)]
            self.cameras = [c.to(dev).clone() for c in cameras[:n]]
            self.gt = torch.stack([gts[j].to(device=dev, dtype=torch.float32)
                                   for j in range(n)])
            self.scalars = torch.zeros(3, dtype=torch.float32, device=dev)
        static = _state_of(self.tensors, state.opt.t, state.generator)
        inputs = (self.cameras[0], self.gt[0]) if views is None else (self.cameras, self.gt)

        def warm():
            body(static, *inputs, cfg, self.scalars, *extra)

        def step():
            new_state, metrics = body(static, *inputs, cfg, self.scalars, *extra)
            with torch.no_grad():
                packed = torch.stack([x.to(torch.float64) for x in metrics])
                for dst, src in zip(self.tensors, state_tensors(new_state)):
                    dst.copy_(src)
            return packed, metrics

        if what is None:
            what = "the train step" if views is None else "the batched train step"
        c = _Capture(warm, step, dev, what)
        counts["warmup_steps"] += WARMUP_STEPS * n
        self._keep(c)
        self.metrics, metrics = c.out
        self.metrics_type = type(metrics)
        self.metrics_dtypes = [x.dtype for x in metrics]
        counts[counter] += 1

    def load(self, state: TrainState) -> None:
        """Copy ``state`` into the state buffers."""
        with torch.no_grad():
            for dst, src in zip(self.tensors, state_tensors(state)):
                dst.copy_(src)

    def run(self, state: TrainState, cameras, gts, scalars: torch.Tensor):
        """len(cameras) / n replays from ``state``, n the views per replay:
        replay i reads cameras and gts [i n, (i + 1) n) and scalars[i]
        ([replays, 3] on the device).  Returns (new state, metrics with
        every field stacked [replays])."""
        n = len(self.cameras)
        k, rest = divmod(len(cameras), n)
        if rest or len(gts) != len(cameras):
            raise ValueError(f"{len(cameras)} cameras and {len(gts)} ground truths for "
                             f"replays of {n} views")
        with tracing.span("graph.copy_in"):
            out = torch.empty((k, self.metrics.shape[0]), dtype=torch.float64,
                              device=self.metrics.device)
            self.load(state)
        with torch.no_grad():
            for i in range(k):
                with tracing.span("graph.replay"):
                    for j in range(n):
                        gt = gts[i * n + j]
                        if gt.shape != self.gt.shape[1:]:
                            raise ValueError(f"ground truth {tuple(gt.shape)}, the step was "
                                             f"captured for {tuple(self.gt.shape[1:])}")
                        self.cameras[j].copy_(cameras[i * n + j])
                        self.gt[j].copy_(gt)
                    self.scalars.copy_(scalars[i])
                    self.graph.replay()
                    out[i].copy_(self.metrics)
            with tracing.span("graph.clone_out"):
                new = [x.clone() for x in self.tensors]
        blend.add_launches({name: c * k for name, c in self.launches.items()})
        metrics = self.metrics_type(*(out[:, j].to(dt) for j, dt in enumerate(self.metrics_dtypes)))
        return _state_of(new, state.opt.t + k, state.generator), metrics

    def free(self) -> None:
        """Release the graph and its memory pool."""
        self.graph.reset()
        self.graph = self.metrics = self.tensors = None


class RenderGraph(_Graph):
    """One captured ``body(params, camera, raster_cfg, *extra)`` under
    ``torch.no_grad`` for one render_key: ``ops.rasterize.render`` (image,
    RenderAux), or the sharded render's body with its mesh in ``extra``.
    ``counter``: the entry of ``counts`` the capture adds one to."""

    def __init__(self, params: GaussianParams, camera, raster_cfg, body=None, extra: tuple = (),
                 what: str = "the render", counter: str = "render_captures"):
        dev = params.means.device
        body = rasterize.render if body is None else body
        self.key = render_key(params, camera, raster_cfg)
        with torch.no_grad():
            self.params = GaussianParams(*(getattr(params, f).detach().clone() for f in FIELDS))
            self.camera = camera.to(dev).clone()

        def frame():
            with torch.no_grad():
                return body(self.params, self.camera, raster_cfg, *extra)

        c = _Capture(frame, frame, dev, what)
        counts["warmup_renders"] += 1
        self._keep(c)
        self.out = c.out
        counts[counter] += 1

    def run(self, params: GaussianParams, camera):
        """Copy ``params`` and ``camera`` in, replay, return the body's
        output as clones."""
        with torch.no_grad():
            with tracing.span("graph.copy_in"):
                for f in FIELDS:
                    getattr(self.params, f).copy_(getattr(params, f))
                self.camera.copy_(camera)
            with tracing.span("graph.replay"):
                self.graph.replay()
            with tracing.span("graph.clone_out"):
                out = _clones(self.out)
        blend.add_launches(self.launches)
        return out

    def free(self) -> None:
        """Release the graph and its memory pool."""
        self.graph.reset()
        self.graph = self.params = self.out = None


class CallGraph(_Graph):
    """One captured ``fn(*buffers)`` over static buffers of ``inputs``'
    shapes on ``dev``: a replay reads the buffers, into which ``run``
    copies its inputs, and ``run`` returns fn's output (a tensor or a
    nested (named) tuple of them) as clones.  The density events and the
    garden's tracer, which launch no blend kernel.  ``counter`` and
    ``warm_counter``: the entries of ``counts`` the capture and its warm-up
    call add one to.  The graph keeps ``fn``: the tensors it holds (the
    tracer's constants) lie outside the graph's pool, and every replay
    reads them."""

    def __init__(self, fn, inputs, dev, what: str, counter: str, warm_counter: str):
        self.fn = fn
        with torch.no_grad():
            self.buffers = [x.to(dev, copy=True) for x in inputs]

        def call():
            with torch.no_grad():
                return fn(*self.buffers)

        c = _Capture(call, call, dev, what, free_cache=False)
        counts[warm_counter] += 1
        self._keep(c)
        self.out = c.out
        counts[counter] += 1

    def run(self, inputs):
        """Copy ``inputs`` into the buffers, replay, return clones of the
        output."""
        with torch.no_grad():
            with tracing.span("graph.copy_in"):
                for dst, src in zip(self.buffers, inputs, strict=True):
                    dst.copy_(src)
            with tracing.span("graph.replay"):
                self.graph.replay()
            with tracing.span("graph.clone_out"):
                out = _clones(self.out)
        blend.add_launches(self.launches)
        return out

    def free(self) -> None:
        """Release the graph and its memory pool."""
        self.graph.reset()
        self.graph = self.fn = self.buffers = self.out = None


class _LRU:
    """At most ``bound`` graphs by key; the least recently used is freed
    before a new one is made."""

    def __init__(self, bound: int):
        self.bound = bound
        self.graphs: collections.OrderedDict = collections.OrderedDict()

    def get(self, key, make):
        """The graph of ``key``, made by ``make()`` if it is not there."""
        graph = self.graphs.pop(key, None)
        if graph is None:
            while len(self.graphs) >= self.bound:
                self.graphs.popitem(last=False)[1].free()
            graph = make()
        self.graphs[key] = graph
        return graph

    def clear(self) -> None:
        while self.graphs:
            self.graphs.popitem(last=False)[1].free()


_steps = _LRU(MAX_GRAPHS)
_renders = _LRU(MAX_RENDER_GRAPHS)
_sharded = _LRU(MAX_SHARDED_GRAPHS)
_events = _LRU(MAX_DENSITY_GRAPHS)
_traces = _LRU(MAX_TRACE_GRAPHS)


def run_steps(body, state: TrainState, cameras, gts, cfg, scalars: torch.Tensor,
              views: int | None = None):
    """StepGraph.run through the step cache: the graph of ``body`` with
    ``views`` per replay for this state's, camera's and Config's key,
    captured first if it is not there."""
    with tracing.span("graph.run_steps"):
        key = graph_key(body, views, state, cameras[0], cfg)
        graph = _steps.get(key, lambda: StepGraph(body, state, cameras, gts, cfg, views))
        return graph.run(state, cameras, gts, scalars)


def render_frame(params: GaussianParams, camera, raster_cfg):
    """One inference render, the port's ``jax.jit(render,
    static_argnums=2)``: (image [H, W, 3], RenderAux), no autograd.  On a
    CUDA device a replay of the render's CUDA graph (captured at the first
    call for this render_key, through the render cache); on the CPU, which
    a caller asks for, ``ops.rasterize.render`` under ``torch.no_grad``."""
    if params.means.device.type != "cuda":
        with torch.no_grad():
            return rasterize.render(params, camera, raster_cfg)
    with tracing.span("graph.render_frame"):
        graph = _renders.get(render_key(params, camera, raster_cfg),
                             lambda: RenderGraph(params, camera, raster_cfg))
        return graph.run(params, camera)


def run_sharded_steps(body, state: TrainState, cameras, gts, cfg, scalars: torch.Tensor, mesh,
                      backend: str, chunks: int, views: int | None = None):
    """run_steps for parallel/sharded.py's step bodies, ``body(state,
    camera(s), gt(s), cfg, scalars, mesh, chunks)``, through the sharded
    cache (sharded_key).  Every rank of ``mesh`` calls it alike."""
    with tracing.span("graph.run_steps"):
        key = sharded_key(body, views, mesh, backend, chunks, state, cameras[0], cfg)
        what = f"the sharded {'batched ' if views else ''}train step"
        graph = _sharded.get(key, lambda: StepGraph(body, state, cameras, gts, cfg, views,
                                                    (mesh, chunks), what, "sharded_captures"))
        return graph.run(state, cameras, gts, scalars)


def run_sharded_render(body, params: GaussianParams, camera, raster_cfg, mesh, backend: str):
    """One replay of the sharded render's body, ``body(params, camera,
    raster_cfg, mesh)``, through the sharded cache (sharded_render_key);
    returns its output as clones.  Every rank of ``mesh`` calls it
    alike."""
    with tracing.span("graph.render_frame"):
        key = sharded_render_key(body, mesh, backend, params, camera, raster_cfg)
        graph = _sharded.get(key, lambda: RenderGraph(params, camera, raster_cfg, body, (mesh,),
                                                      "the sharded render", "sharded_captures"))
        return graph.run(params, camera)


def run_event(body, state: TrainState, inputs, cfg, scene_extent=None):
    """One density event, ``body(state, *inputs, cfg[, scene_extent])`` ->
    (state, extra), replayed through the density cache (event_key): the
    state and ``inputs`` (tensors: densify's iteration, split draw and
    focal length; none for the opacity reset) are copied into the graph's
    buffers.  Returns (the new state, with ``state``'s timestep and
    generator, and extra as clones); ``state`` is left as it was."""
    args = (cfg,) if scene_extent is None else (cfg, scene_extent)
    t, generator = state.opt.t, state.generator
    tensors = state_tensors(state)
    n = len(tensors)

    def event(*buffers):
        new, extra = body(_state_of(buffers[:n], t, generator), *buffers[n:], *args)
        return state_tensors(new), extra

    with tracing.span("graph.event"):
        graph = _events.get(event_key(body, state, cfg, scene_extent), lambda: CallGraph(
            event, tensors + list(inputs), state.params.means.device,
            f"the density event {body.__name__}", "density_captures", "warmup_events"))
        new, extra = graph.run(tensors + list(inputs))
    return _state_of(new, t, generator), extra


def run_trace(trace, rows: torch.Tensor, eye: torch.Tensor, fx, fy, cx, cy, width: int,
              height: int, device, constants):
    """One garden view, ``trace(rows, eye, fx, fy, cx, cy, width, height,
    constants(device))`` [H, W, 3], replayed on ``device`` through the
    tracer cache (trace_key): the pose (R's rows [3, 3], eye [3]) is copied
    in.  ``constants(device)`` makes the scene's tensors once, before the
    capture."""
    def make():
        consts = constants(device)
        return CallGraph(lambda r, e: trace(r, e, fx, fy, cx, cy, width, height, consts),
                         [rows, eye], device, "the garden's ray tracer", "trace_captures",
                         "warmup_traces")

    return _traces.get(trace_key(fx, fy, cx, cy, width, height, device), make).run([rows, eye])


def live() -> list[StepGraph]:
    """The cached step graphs, least recently used first."""
    return list(_steps.graphs.values())


def live_renders() -> list[RenderGraph]:
    """The cached render graphs, least recently used first."""
    return list(_renders.graphs.values())


def live_sharded() -> list:
    """The cached sharded graphs (StepGraph, RenderGraph), least recently
    used first."""
    return list(_sharded.graphs.values())


def live_events() -> list[CallGraph]:
    """The cached density-event graphs, least recently used first."""
    return list(_events.graphs.values())


def live_traces() -> list[CallGraph]:
    """The cached tracer graphs, least recently used first."""
    return list(_traces.graphs.values())


def clear() -> None:
    """Free every cached graph and return the pools' memory to the device."""
    for cache in (_steps, _renders, _sharded, _events, _traces):
        cache.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
