"""Tile-strip sharded training steps and render over a process group
(counterpart of gaussiansplatting_tpu/parallel/sharded.py).

Scheme (sharded.py:1-14): Gaussian parameters are REPLICATED; rank r
rasterizes the horizontal strip of tile rows [r * rows_per, (r + 1) *
rows_per) (``render(tile_rows=...)``); the strips are gathered into the
full image on every rank, so the photometric loss, its 11x11 D-SSIM window
crossing strip boundaries, is computed identically on every rank; the
gather's backward hands each rank its own strip's cotangent, so the
per-Gaussian gradients are per-rank partial sums that one all-reduce
completes.  Adam and the density statistics then run identically on every
rank, whose states stay bit-identical.

Collectives: ``all_gather_into_tensor`` for the strips and ``all_reduce``
for the sums, on every backend (gloo takes both on CPU and on CUDA
tensors, nccl on CUDA).  The gather's backward slices the rank's strip out
of the full image's cotangent, which is the same on every rank (JAX:
psum_scatter of N identical cotangents of loss / N).
Gradients, vs_grad and pos_grad are all-reduced, pair counts summed over
strips.  No float atomics: the reductions are the backend's collectives.

Every collective runs inside a host span (COLLECTIVE_SPANS,
utils/tracing.py), which under a profiler is also a profiler range of the
same name, so a profile of a step reads the time spent in them.

Dispatch (the counterpart of JAX's ``jax.jit`` of each sharded function,
sharded.py:166, 283, 316): the step, the batched step and the render are
module-level bodies (``step_body``, ``batched_body``, ``render_body``) that
take the mesh and the chunks as arguments and the step's scalars
(schedule.step_scalars) as a device tensor.  On a CUDA rank of an NCCL
group (``replays``) the functions that ``make_sharded_*`` return replay the
bodies captured as CUDA graphs (train/graph.py: once per key, which holds
the body, the mesh's size and rank, the backend and the chunks; NCCL's
kernels are captured with the rest).  A gloo rank, on the CPU or sharing a
card (parallel/launch.BACKEND_RULE), runs the bodies op by op: gloo's
collectives run on the host, where no capture can hold them.  A failed
NCCL capture raises; nothing falls back to eager calls.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from gaussiansplatting_tpu_torch.config import Config
from gaussiansplatting_tpu_torch.ops import projection as proj_mod
from gaussiansplatting_tpu_torch.ops.losses import photometric_loss
from gaussiansplatting_tpu_torch.ops.rasterize import render
from gaussiansplatting_tpu_torch.parallel.mesh import Mesh, require_process_group
from gaussiansplatting_tpu_torch.train import graph, optimizer
from gaussiansplatting_tpu_torch.train import trainer
from gaussiansplatting_tpu_torch.utils import tracing


# the host spans around the collectives: the strip gather, and the
# all-reduces of the gradients and of the density statistics and counts
COLLECTIVE_SPANS = ("sharded.gather_strips", "sharded.all_reduce")


def strip_rows(height: int, tile_size: int, num_devices: int) -> int:
    """Tile rows per rank (the last rank's strip may cover padding rows)."""
    tiles_y = proj_mod.num_tiles(height, tile_size)
    return -(-tiles_y // num_devices)


def _check_member(mesh: Mesh) -> None:
    require_process_group("a sharded step")
    if mesh.rank < 0:
        raise RuntimeError(f"rank {dist.get_rank()} is outside this {mesh.size}-rank mesh")


def _all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh (a contiguous copy where ``x`` is a
    view: autograd hands vs_grad back as a column slice, which a collective
    must not take)."""
    x = x.contiguous()
    with tracing.span(COLLECTIVE_SPANS[1]):
        dist.all_reduce(x, group=mesh.group)
    return x


def chunked_all_reduce(grads: dict, mesh: Mesh, chunks: int = 1) -> dict:
    """Sum every parameter group's per-rank partial gradient over the mesh,
    in place, each group split along the Gaussian axis into ``chunks``
    slices with an all-reduce each (JAX chunked_psum, sharded.py:43-71,
    where XLA overlaps them with the backward; eager PyTorch runs them after
    it).  The sum is elementwise, so the slices change no value: with two
    ranks each element is one addition, bit-identical either way."""
    out = {}
    with tracing.span(COLLECTIVE_SPANS[1]):
        for f in sorted(grads):
            g = grads[f].contiguous()
            n = g.shape[0]
            per = -(-n // max(chunks, 1))
            for lo in range(0, n, per):
                dist.all_reduce(g[lo:lo + per], group=mesh.group)
            out[f] = g
    return out


class _GatherStrips(torch.autograd.Function):
    """The ranks' strips [rows, W, 3] -> the padded full image [size * rows,
    W, 3] on every rank (see the module docstring)."""

    @staticmethod
    def forward(ctx, strip, mesh):
        rows = strip.shape[0]
        full = strip.new_empty((mesh.size * rows,) + tuple(strip.shape[1:]))
        with tracing.span(COLLECTIVE_SPANS[0]):
            dist.all_gather_into_tensor(full, strip.contiguous(), group=mesh.group)
        ctx.lo, ctx.rows = mesh.rank * rows, rows
        return full

    @staticmethod
    def backward(ctx, g):
        return g[ctx.lo:ctx.lo + ctx.rows], None


def _full_image(params, camera, raster, mesh: Mesh, vs_dummy=None):
    """This rank's strip gathered into the full [H, W, 3] image, and the
    strip's RenderAux."""
    rows_per = strip_rows(camera.height, raster.tile_size, mesh.size)
    strip, aux = render(params, camera, raster, vs_dummy=vs_dummy,
                        tile_rows=(mesh.rank * rows_per, rows_per))
    return _GatherStrips.apply(strip, mesh)[:camera.height], aux


def _sum_counts(mesh: Mesh, num_pairs, overflow):
    """(pairs, overflowing strips) summed over the mesh, per entry."""
    counts = _all_reduce(torch.stack([num_pairs.to(torch.int64).reshape(-1),
                                      overflow.to(torch.int64).reshape(-1)]), mesh)
    return counts[0], counts[1] > 0


def replays(backend: str, device) -> bool:
    """True where the sharded functions replay CUDA graphs: a rank on a
    CUDA device of an NCCL group.  Elsewhere (gloo) they run the bodies op
    by op."""
    return torch.device(device).type == "cuda" and backend == "nccl"


def step_body(state, camera, gt_image, cfg: Config, scalars: torch.Tensor, mesh: Mesh,
              grad_psum_chunks: int = 1):
    """The sharded step on one view (sharded.py:74-166), given its
    ``scalars`` as trainer.step_body takes them.  What train/graph.py
    captures on an NCCL rank and a gloo rank runs; it reads no device value
    back to the host."""
    params = state.params
    trainable = [getattr(params, f) for f in optimizer.TRAINABLE]
    vs_zero = torch.zeros((params.capacity, 2), dtype=torch.float32,
                          device=params.means.device, requires_grad=True)
    with torch.enable_grad():
        img, aux = _full_image(params, camera, cfg.raster, mesh, vs_zero)
        tracing.mark("loss", img)
        rep = photometric_loss(img, gt_image, cfg.loss)
        tracing.mark("loss_bwd", img)
        *grads, vs_grad = torch.autograd.grad(rep.grad_loss, trainable + [vs_zero])
    grad = chunked_all_reduce(dict(zip(optimizer.TRAINABLE, grads)), mesh, grad_psum_chunks)
    vs_grad = _all_reduce(vs_grad, mesh)
    pairs, overflow = _sum_counts(mesh, aux.num_pairs, aux.overflow)
    return trainer.step_update(state, grad, vs_grad, rep, img, gt_image,
                               pairs[0].to(torch.int32), overflow[0], cfg, scalars)


def batched_body(state, cameras, gt_images, cfg: Config, scalars: torch.Tensor, mesh: Mesh,
                 grad_psum_chunks: int = 1):
    """The sharded step over K views (sharded.py:169-283), given its
    ``scalars``: every view's strip is gathered into its full image, one
    all-reduce per parameter group completes the mean gradient, and the
    per-view vs_grad / pos_grad are all-reduced for the per-view density
    statistics (train_step_batched).  ``num_pairs`` sums each view's strips
    first, then takes the max over views.  Captured as step_body is."""
    def render_view(p, cam, vs):
        return _full_image(p, cam, cfg.raster, mesh, vs)

    grad, vs_grad, pos_grad, reps, auxs, imgs = trainer.batched_view_grads(
        state.params, cameras, gt_images, cfg, render_view)
    grad = chunked_all_reduce(grad, mesh, grad_psum_chunks)
    vs_grad = _all_reduce(vs_grad, mesh)
    pos_grad = _all_reduce(pos_grad, mesh)
    pairs, overflow = _sum_counts(mesh, torch.stack([a.num_pairs for a in auxs]),
                                  torch.stack([a.overflow for a in auxs]))
    return trainer.batched_update(state, grad, vs_grad, pos_grad, reps, imgs, gt_images,
                                  pairs.amax().to(torch.int32), overflow.any(), cfg, scalars)


class ShardedRender(NamedTuple):
    image: torch.Tensor
    num_pairs: torch.Tensor


def render_body(params, camera, raster, mesh: Mesh) -> ShardedRender:
    """The inference-only sharded render (sharded.py:286-316) under
    ``torch.no_grad``: strips gathered, pair counts summed.  Captured as
    step_body is."""
    with torch.no_grad():
        img, aux = _full_image(params, camera, raster, mesh)
        pairs, _ = _sum_counts(mesh, aux.num_pairs, aux.overflow)
    return ShardedRender(image=img, num_pairs=pairs[0].to(torch.int32))


def make_sharded_train_step(mesh: Mesh, cfg: Config, total_iters: int,
                            grad_psum_chunks: int = 1):
    """The sharded step (state, camera, gt [H, W, 3]) -> (state,
    StepMetrics), which every rank of ``mesh`` calls with the same
    arguments (sharded.py:74-166).  ``grad_psum_chunks`` > 1 splits each
    gradient all-reduce into that many slices (chunked_all_reduce).  A
    replay of step_body's graph where ``replays``, step_body op by op
    elsewhere; functional, as trainer.train_step."""
    trainer.only_gaussians(cfg, "the tile-sharded step and render")

    def step(state, camera, gt_image):
        _check_member(mesh)
        dev = state.params.means.device
        scalars = trainer.device_scalars(cfg, state.opt.t, 1, total_iters, dev)
        backend = dist.get_backend(mesh.group)
        if replays(backend, dev):
            new_state, ms = graph.run_sharded_steps(step_body, state, [camera], [gt_image], cfg,
                                                    scalars, mesh, backend, grad_psum_chunks)
            return new_state, trainer._metrics_at(ms, 0)
        return step_body(state, camera, gt_image, cfg, scalars[0], mesh, grad_psum_chunks)

    return step


def make_sharded_train_step_batched(mesh: Mesh, cfg: Config, total_iters: int,
                                    batch_views: int, grad_psum_chunks: int = 1):
    """The sharded batched step (state, K cameras, K ground truths) ->
    (state, StepMetrics) (sharded.py:169-283): batched_body, dispatched as
    make_sharded_train_step dispatches step_body (one replay of K
    views)."""
    trainer.only_gaussians(cfg, "the tile-sharded step and render")

    def step(state, cameras, gt_images):
        _check_member(mesh)
        if len(cameras) != batch_views:
            raise ValueError(f"sharded batched step of {batch_views} views given {len(cameras)}")
        dev = state.params.means.device
        scalars = trainer.device_scalars(cfg, state.opt.t, 1, total_iters, dev)
        backend = dist.get_backend(mesh.group)
        if replays(backend, dev):
            new_state, ms = graph.run_sharded_steps(batched_body, state, cameras, gt_images, cfg,
                                                    scalars, mesh, backend, grad_psum_chunks,
                                                    views=batch_views)
            return new_state, trainer._metrics_at(ms, 0)
        return batched_body(state, cameras, gt_images, cfg, scalars[0], mesh, grad_psum_chunks)

    return step


def make_sharded_render(mesh: Mesh, cfg: Config):
    """Inference-only sharded render (params, camera) -> ShardedRender
    (sharded.py:286-316): render_body, a replay of its graph where
    ``replays``, op by op elsewhere."""
    trainer.only_gaussians(cfg, "the tile-sharded step and render")

    def run(params, camera) -> ShardedRender:
        _check_member(mesh)
        backend = dist.get_backend(mesh.group)
        if replays(backend, params.means.device):
            return graph.run_sharded_render(render_body, params, camera, cfg.raster, mesh,
                                            backend)
        return render_body(params, camera, cfg.raster, mesh)

    return run
