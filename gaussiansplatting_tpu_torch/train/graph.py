"""The compiled dispatch of the train step: the step captured once per
static shape as a CUDA graph, then replayed.

Counterpart of ``train_step = jax.jit(_train_step_impl)`` and of the
``lax.scan`` program of ``train_steps`` (gaussiansplatting_tpu/train/
trainer.py:93-123).  JAX compiles the step once per static argument set and
runs K steps as one program.  Here the step is captured once per key
(``step_key``: the Gaussian capacity, the resolution, the device and the
frozen Config, which holds the pair capacity) and replayed K times.  A
replay reads the state, the camera, the ground truth and the step's scalars
(position LR, Adam's bias corrections) from static buffers and ends by
copying the new state into the state buffers it read, so K replays chain K
steps.  Camera pose, ground truth, the timestep and total_iters are inputs,
not part of the key.

``run_steps`` keeps the port's functional contract: it copies the caller's
state into the buffers, returns clones, and leaves the input as it was
(the JAX program donates its input instead).

Capture: an eager warm-up step on a side stream (it loads the kernels'
libraries, creates cuBLAS's handle for the stream and fills the cached SSIM
band matrices), then the capture of one whole step on that stream, into the
graph's own memory pool: the forward, ``torch.autograd.grad`` through the
custom Functions, Adam, the density statistics and the metrics packed into
one float64 vector.  A capture that fails raises, naming the op where it
failed; nothing falls back to eager steps.  The capture records the blend
kernels' launches without running them: ops.blend's counters are set back
after it, and every replay adds what the capture recorded.

At most MAX_GRAPHS graphs are kept; the least recently used is freed with
its pool before a new key is captured (another pair capacity, a grown
state, another resolution or mode).
"""

from __future__ import annotations

import collections
import os
import time
import traceback

import torch

from gaussiansplatting_tpu_torch.core.gaussians import FIELDS, GaussianParams
from gaussiansplatting_tpu_torch.density.control import DensityAccum
from gaussiansplatting_tpu_torch.ops import blend
from gaussiansplatting_tpu_torch.train.optimizer import TRAINABLE, AdamState
from gaussiansplatting_tpu_torch.train.state import TrainState

MAX_GRAPHS = 2       # two are enough for steps that alternate between two modes
WARMUP_STEPS = 1
_ACCUM = ("grad_accum", "grad_count", "pos_grad_accum")

# captures and warm-up steps run in this process
counts: collections.Counter = collections.Counter()


def step_key(state: TrainState, camera, cfg) -> tuple:
    """What a captured step is specific to: the Gaussian capacity, the
    render resolution, the device and the Config (with its pair capacity)."""
    return (state.params.capacity, (camera.width, camera.height),
            state.params.means.device, cfg)


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


class StepGraph:
    """One captured step of ``body(state, camera, gt, cfg, scalars) ->
    (state, metrics NamedTuple of 0-d tensors)`` for one key (see the
    module docstring)."""

    def __init__(self, body, state: TrainState, camera, gt: torch.Tensor, cfg):
        dev = state.params.means.device
        self.key = step_key(state, camera, cfg)
        with torch.no_grad():
            self.tensors = [x.clone() for x in state_tensors(state)]
            self.camera = camera.to(dev).clone()
            self.gt = gt.to(device=dev, dtype=torch.float32).clone()
            self.scalars = torch.zeros(3, dtype=torch.float32, device=dev)
        static = _state_of(self.tensors, state.opt.t, state.generator)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            for _ in range(WARMUP_STEPS):
                body(static, self.camera, self.gt, cfg, self.scalars)
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        self.warmup_s = time.perf_counter() - t0
        counts["warmup_steps"] += WARMUP_STEPS
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = blend.launch_counts()
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                new_state, metrics = body(static, self.camera, self.gt, cfg, self.scalars)
                with torch.no_grad():
                    self.metrics = torch.stack([x.to(torch.float64) for x in metrics])
                    for dst, src in zip(self.tensors, state_tensors(new_state)):
                        dst.copy_(src)
        except Exception as e:
            raise RuntimeError(f"capturing the train step failed at {_where(e)}: {e}") from e
        finally:
            after = blend.launch_counts()
            blend.add_launches({k: before[k] - after[k] for k in before})
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches = {k: after[k] - before[k] for k in before if after[k] != before[k]}
        self.metrics_type = type(metrics)
        self.metrics_dtypes = [x.dtype for x in metrics]
        counts["captures"] += 1

    def load(self, state: TrainState) -> None:
        """Copy ``state`` into the state buffers."""
        with torch.no_grad():
            for dst, src in zip(self.tensors, state_tensors(state)):
                dst.copy_(src)

    def run(self, state: TrainState, cameras, gts, scalars: torch.Tensor):
        """K = len(cameras) replays from ``state``: step i reads cameras[i],
        gts[i] and scalars[i] ([K, 3] on the device).  Returns (new state,
        metrics with every field stacked [K])."""
        k = len(cameras)
        out = torch.empty((k, self.metrics.shape[0]), dtype=torch.float64,
                          device=self.metrics.device)
        self.load(state)
        with torch.no_grad():
            for i in range(k):
                if gts[i].shape != self.gt.shape:
                    raise ValueError(f"ground truth {tuple(gts[i].shape)}, the step was "
                                     f"captured for {tuple(self.gt.shape)}")
                self.camera.copy_(cameras[i])
                self.gt.copy_(gts[i])
                self.scalars.copy_(scalars[i])
                self.graph.replay()
                out[i].copy_(self.metrics)
            new = [x.clone() for x in self.tensors]
        blend.add_launches({name: n * k for name, n in self.launches.items()})
        metrics = self.metrics_type(*(out[:, j].to(dt) for j, dt in enumerate(self.metrics_dtypes)))
        return _state_of(new, state.opt.t + k, state.generator), metrics

    def free(self) -> None:
        """Release the graph and its memory pool."""
        self.graph.reset()
        self.graph = self.metrics = self.tensors = None


_cache: collections.OrderedDict = collections.OrderedDict()


def run_steps(body, state: TrainState, cameras, gts, cfg, scalars: torch.Tensor):
    """StepGraph.run through the cache: the graph of ``body`` for this
    state's, camera's and Config's key, captured first if it is not there
    (freeing the least recently used graph when MAX_GRAPHS are live)."""
    key = (body,) + step_key(state, cameras[0], cfg)
    graph = _cache.pop(key, None)
    if graph is None:
        while len(_cache) >= MAX_GRAPHS:
            _cache.popitem(last=False)[1].free()
        graph = StepGraph(body, state, cameras[0], gts[0], cfg)
    _cache[key] = graph
    return graph.run(state, cameras, gts, scalars)


def live() -> list[StepGraph]:
    """The cached graphs, least recently used first."""
    return list(_cache.values())


def clear() -> None:
    """Free every cached graph and return the pools' memory to the device."""
    while _cache:
        _cache.popitem(last=False)[1].free()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
