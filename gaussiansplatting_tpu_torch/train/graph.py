"""The compiled dispatch of the port: the train step, the batched train step
and the inference render, each captured once per static key as a CUDA
graph, then replayed.  This module is the port's counterpart of every
``jax.jit`` of the JAX package:

- ``train_step = jax.jit(_train_step_impl)`` and the ``lax.scan`` program
  of ``train_steps`` (gaussiansplatting_tpu/train/trainer.py:93-123):
  ``run_steps`` with ``trainer.step_body``, one view per replay;
- ``jax.jit(train_step_batched)`` (trainer.py:141): ``run_steps`` with
  ``trainer.batched_body``, K views per replay;
- ``jax.jit(render, static_argnums=2)`` of the tools and the facade
  (tools/render.py:78, tools/view.py:132, tools/evaluate.py:61,
  tools/train.py:295, 336, 362, tools/bench_train.py:92,
  models/gaussian_model.py:126): ``render_frame``.

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

Step graphs and render graphs are kept in two bounded caches (MAX_GRAPHS,
MAX_RENDER_GRAPHS): the least recently used is freed with its pool before
a new key is captured (another pair capacity, a grown state, another
resolution or mode), and a tool that renders between steps keeps its step
graph.  The caches are not locked: callers that share them across threads
(tools/view.py) hold one lock around every call.
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

MAX_GRAPHS = 2          # two are enough for steps that alternate between two modes
MAX_RENDER_GRAPHS = 2   # tools.train renders its snapshots and its held-out views
WARMUP_STEPS = 1
CAPTURE_MODE = "thread_local"
_ACCUM = ("grad_accum", "grad_count", "pos_grad_accum")

# captures and warm-up calls run in this process: "captures" and
# "warmup_steps" (views a step's warm-up renders: each launches its mode's
# forward and backward kernels once), "render_captures" and
# "warmup_renders" (each launches its mode's forward kernels once)
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


class _Capture:
    """``warm()`` run once eagerly on a side stream, then one call of
    ``fn()`` captured on that stream into a new CUDA graph (see the module
    docstring).  Holds the graph, fn's output (static tensors the replays
    rewrite), the launches the capture recorded, the warm-up and capture
    seconds and the pool's bytes."""

    def __init__(self, warm, fn, dev, what: str):
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            warm()
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        self.warmup_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = blend.launch_counts()
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, stream=stream, capture_error_mode=CAPTURE_MODE):
                self.out = fn()
        except Exception as e:
            raise RuntimeError(f"capturing {what} failed at {_where(e)}: {e}") from e
        finally:
            after = blend.launch_counts()
            blend.add_launches({k: before[k] - after[k] for k in before})
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches = {k: after[k] - before[k] for k in before if after[k] != before[k]}


class StepGraph:
    """One captured step of ``body`` for one key.  ``views`` None: the
    body is ``body(state, camera, gt [H, W, 3], cfg, scalars)`` and a
    replay reads one view (trainer.step_body); ``views`` K: the body is
    ``body(state, K cameras, gts [K, H, W, 3], cfg, scalars)`` and a replay
    reads K views (trainer.batched_body).  Either returns (state, metrics
    NamedTuple of 0-d tensors)."""

    def __init__(self, body, state: TrainState, cameras, gts, cfg, views: int | None = None):
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
            body(static, *inputs, cfg, self.scalars)

        def step():
            new_state, metrics = body(static, *inputs, cfg, self.scalars)
            with torch.no_grad():
                packed = torch.stack([x.to(torch.float64) for x in metrics])
                for dst, src in zip(self.tensors, state_tensors(new_state)):
                    dst.copy_(src)
            return packed, metrics

        what = "the train step" if views is None else "the batched train step"
        c = _Capture(warm, step, dev, what)
        counts["warmup_steps"] += WARMUP_STEPS * n
        self.graph, self.launches = c.graph, c.launches
        self.warmup_s, self.capture_s, self.pool_bytes = c.warmup_s, c.capture_s, c.pool_bytes
        self.metrics, metrics = c.out
        self.metrics_type = type(metrics)
        self.metrics_dtypes = [x.dtype for x in metrics]
        counts["captures"] += 1

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
        out = torch.empty((k, self.metrics.shape[0]), dtype=torch.float64,
                          device=self.metrics.device)
        self.load(state)
        with torch.no_grad():
            for i in range(k):
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
            new = [x.clone() for x in self.tensors]
        blend.add_launches({name: c * k for name, c in self.launches.items()})
        metrics = self.metrics_type(*(out[:, j].to(dt) for j, dt in enumerate(self.metrics_dtypes)))
        return _state_of(new, state.opt.t + k, state.generator), metrics

    def free(self) -> None:
        """Release the graph and its memory pool."""
        self.graph.reset()
        self.graph = self.metrics = self.tensors = None


class RenderGraph:
    """One captured ``ops.rasterize.render(params, camera, raster_cfg)``
    under ``torch.no_grad`` for one render_key."""

    def __init__(self, params: GaussianParams, camera, raster_cfg):
        dev = params.means.device
        self.key = render_key(params, camera, raster_cfg)
        with torch.no_grad():
            self.params = GaussianParams(*(getattr(params, f).detach().clone() for f in FIELDS))
            self.camera = camera.to(dev).clone()

        def frame():
            with torch.no_grad():
                return rasterize.render(self.params, self.camera, raster_cfg)

        c = _Capture(frame, frame, dev, "the render")
        counts["warmup_renders"] += 1
        self.graph, self.launches = c.graph, c.launches
        self.warmup_s, self.capture_s, self.pool_bytes = c.warmup_s, c.capture_s, c.pool_bytes
        self.image, self.aux = c.out
        counts["render_captures"] += 1

    def run(self, params: GaussianParams, camera):
        """Copy ``params`` and ``camera`` in, replay, return (image,
        RenderAux) as clones."""
        with torch.no_grad():
            for f in FIELDS:
                getattr(self.params, f).copy_(getattr(params, f))
            self.camera.copy_(camera)
            self.graph.replay()
            out = self.image.clone(), type(self.aux)(*(x.clone() for x in self.aux))
        blend.add_launches(self.launches)
        return out

    def free(self) -> None:
        """Release the graph and its memory pool."""
        self.graph.reset()
        self.graph = self.params = self.image = self.aux = None


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


def run_steps(body, state: TrainState, cameras, gts, cfg, scalars: torch.Tensor,
              views: int | None = None):
    """StepGraph.run through the step cache: the graph of ``body`` with
    ``views`` per replay for this state's, camera's and Config's key,
    captured first if it is not there."""
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
    graph = _renders.get(render_key(params, camera, raster_cfg),
                         lambda: RenderGraph(params, camera, raster_cfg))
    return graph.run(params, camera)


def live() -> list[StepGraph]:
    """The cached step graphs, least recently used first."""
    return list(_steps.graphs.values())


def live_renders() -> list[RenderGraph]:
    """The cached render graphs, least recently used first."""
    return list(_renders.graphs.values())


def clear() -> None:
    """Free every cached graph and return the pools' memory to the device."""
    _steps.clear()
    _renders.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
