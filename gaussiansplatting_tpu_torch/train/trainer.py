"""Training: the step (render, loss, gradient, Adam and the density
statistics of one view), the density and opacity-reset events, and the loop
that runs them on the reference schedule.

Counterpart of gaussiansplatting_tpu/train/trainer.py (reference: trainStep,
mtl_engine.mm:856-1025, and the epoch loop, mtl_engine.mm:1047-1221).
The step's body (``step_body``) is a Python function; the gradients come
from ``torch.autograd.grad`` over the five trainable parameter groups and a
zero ``vs_dummy`` whose gradient is the view-space positional gradient.
``train_step`` and ``train_steps`` dispatch it as the JAX package does: on a
CUDA device each step replays the body captured as a CUDA graph, once per
static shape (train/graph.py, the counterpart of ``jax.jit`` and of the
``lax.scan`` program); on the CPU, which a caller asks for, the body runs op
by op (``train_step_eager``).  The step's scalars that change with the
iteration reach the body as a device tensor (schedule.step_scalars).
Every function is functional: it returns a new state and leaves its input
as it was, so a step or an event can be replayed from the same state.
``train_step_batched`` (``batch_views > 1``) takes one Adam step on the mean
gradient of K views, dispatched the same way (``batched_body``, one replay
of K views; ``train_step_batched_eager``).  ``train_loop(mesh_devices > 1)``
runs the tile-sharded steps of ``parallel/sharded.py`` over a
``torch.distributed`` process group (replays on an NCCL group, op by op on
gloo).  The density events (``densify_step``, ``opacity_reset_step``)
replay their bodies captured as CUDA graphs on a CUDA device, in a cache
of their own (a density event never evicts the step the loop replays), and
run op by op on the CPU (``densify_step_eager``,
``opacity_reset_step_eager``).
"""

from __future__ import annotations

import dataclasses
import random
from typing import NamedTuple, Sequence

import torch

from gaussiansplatting_tpu_torch.config import Config
from gaussiansplatting_tpu_torch.core import transforms as T
from gaussiansplatting_tpu_torch.core.camera import Camera
from gaussiansplatting_tpu_torch.density import control as density
from gaussiansplatting_tpu_torch.ops.losses import photometric_loss, psnr
from gaussiansplatting_tpu_torch.ops.rasterize import render
from gaussiansplatting_tpu_torch.train import graph, optimizer, schedule
from gaussiansplatting_tpu_torch.train import state as state_mod
from gaussiansplatting_tpu_torch.train.state import TrainState
from gaussiansplatting_tpu_torch.utils import tracing


class StepMetrics(NamedTuple):
    loss: torch.Tensor        # combined (1-l)L1 + l*DSSIM per-pixel mean
    l1: torch.Tensor
    dssim: torch.Tensor
    psnr: torch.Tensor
    num_pairs: torch.Tensor
    overflow: torch.Tensor
    position_lr: torch.Tensor
    num_gaussians: torch.Tensor
    # population statistics (reference: per-200-step opacity/scale sample
    # dump, mtl_engine.mm:1009-1022)
    mean_opacity: torch.Tensor
    mean_world_scale: torch.Tensor


def device_scalars(cfg: Config, t0: int, k: int, total_iters: int, device) -> torch.Tensor:
    """schedule.step_scalars of the k steps from Adam timestep t0, as a
    [k, 3] float32 tensor on ``device`` (on CUDA, a copy from pinned memory
    that does not wait for the device)."""
    x = torch.from_numpy(schedule.step_scalars(cfg.optim, t0, k, total_iters))
    if torch.device(device).type == "cuda":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def step_body(state: TrainState, camera: Camera, gt_image: torch.Tensor, cfg: Config,
              scalars: torch.Tensor) -> tuple[TrainState, StepMetrics]:
    """One optimization step on one view, given its ``scalars`` [3] float32
    on the parameters' device (position LR, bias corrections: the row of
    schedule.step_scalars for ``state.opt.t``).  What train/graph.py
    captures and train_step_eager runs; it reads no device value back to
    the host."""
    params = state.params
    trainable = [getattr(params, f) for f in optimizer.TRAINABLE]
    vs_zero = torch.zeros((params.capacity, 2), dtype=torch.float32,
                          device=params.means.device, requires_grad=True)
    with torch.enable_grad():
        img, aux = render(params, camera, cfg.raster, vs_dummy=vs_zero)
        tracing.mark("loss", img)
        rep = photometric_loss(img, gt_image, cfg.loss)
        tracing.mark("loss_bwd", img)
        *grads, vs_grad = torch.autograd.grad(rep.grad_loss, trainable + [vs_zero])
    return step_update(state, dict(zip(optimizer.TRAINABLE, grads)), vs_grad, rep, img,
                       gt_image, aux.num_pairs, aux.overflow, cfg, scalars)


def train_step_eager(state: TrainState, camera: Camera, gt_image: torch.Tensor,
                     cfg: Config, total_iters: int) -> tuple[TrainState, StepMetrics]:
    """One step run op by op: step_body with the schedule's scalars.  The
    CPU's train_step, and the yardstick of the captured one on the card."""
    scalars = device_scalars(cfg, state.opt.t, 1, total_iters, state.params.means.device)
    return step_body(state, camera, gt_image, cfg, scalars[0])


def train_step(
    state: TrainState,
    camera: Camera,
    gt_image: torch.Tensor,
    cfg: Config,
    total_iters: int,
) -> tuple[TrainState, StepMetrics]:
    """One optimization step on one view.  Functional: returns a new state
    and leaves ``state`` as it was.  On a CUDA device, train_steps with
    K = 1 (a replay of the captured step); on the CPU, train_step_eager."""
    if state.params.means.device.type == "cuda":
        new_state, ms = train_steps(state, [camera], [gt_image], cfg, total_iters)
        return new_state, _metrics_at(ms, 0)
    return train_step_eager(state, camera, gt_image, cfg, total_iters)


def step_update(state: TrainState, grad: dict, vs_grad, rep, img, gt_image, num_pairs,
                overflow, cfg: Config, scalars: torch.Tensor) -> tuple[TrainState, StepMetrics]:
    """The rest of the step once the view's gradients exist: Adam, the
    density statistics and the metrics (parallel/sharded.py calls it with
    the all-reduced gradients).  ``scalars`` as step_body takes them."""
    params = state.params
    tracing.mark("adam", params.means)
    # LR uses the pre-increment iteration count (mtl_engine.mm:1092-1094)
    lrs = schedule.rates(cfg.optim, scalars[0])
    new_params, new_opt = optimizer.step(params, grad, state.opt, lrs, cfg.optim,
                                         (scalars[1], scalars[2]))

    # density statistics (reference: DensityController::accumulateGradients
    # after every backward, mtl_engine.mm:1000-1002)
    new_accum = density.accumulate(state.accum, vs_grad, grad["means"], cfg.density)

    with torch.no_grad():
        metrics = StepMetrics(
            loss=rep.combined_mean.detach(),
            l1=rep.l1_mean.detach(),
            dssim=rep.dssim_mean.detach(),
            psnr=psnr(img.detach(), gt_image),
            num_pairs=num_pairs,
            overflow=overflow,
            position_lr=lrs.position,
            num_gaussians=new_params.count(),
            mean_opacity=_mean_opacity(new_params),
            mean_world_scale=_mean_world_scale(new_params),
        )
    new_state = TrainState(params=new_params, opt=new_opt, accum=new_accum,
                           generator=state.generator)
    return new_state, metrics


def train_steps(
    state: TrainState,
    cameras: list[Camera],
    gt_images: list[torch.Tensor],
    cfg: Config,
    total_iters: int,
) -> tuple[TrainState, StepMetrics]:
    """K sequential optimization steps (one per view), the JAX
    ``train_steps`` scan.  On a CUDA device, K replays of the step's CUDA
    graph (train/graph.py: captured at the first call for this capacity,
    resolution and Config); on the CPU, K train_step_eager calls.  The views
    share one resolution.  Returns (state, metrics) with every StepMetrics
    field stacked [K], and leaves ``state`` as it was."""
    dev = state.params.means.device
    if dev.type == "cuda":
        scalars = device_scalars(cfg, state.opt.t, len(cameras), total_iters, dev)
        return graph.run_steps(step_body, state, cameras, gt_images, cfg, scalars)
    steps = []
    for cam, gt in zip(cameras, gt_images):
        state, m = train_step_eager(state, cam, gt, cfg, total_iters)
        steps.append(m)
    return state, StepMetrics(*(torch.stack(xs) for xs in zip(*steps)))


class _ParamsView(NamedTuple):
    """The fields render reads, for a view of the parameters whose means
    carry a per-view zero (train_step_batched's ``pos_dummy``)."""
    means: torch.Tensor
    log_scales: torch.Tensor
    quats: torch.Tensor
    raw_opacities: torch.Tensor
    sh: torch.Tensor
    alive: torch.Tensor


def batched_view_grads(params, cameras, gt_images, cfg: Config, render_view=None):
    """The autograd half of train_step_batched: the K views' losses under
    one ``torch.autograd.grad`` of their mean (JAX vmaps one_view,
    trainer.py:169-188; a CUDA kernel has no vmap, so the views run in a
    Python loop and their graphs are kept until the one backward).

    ``render_view(p, camera, vs_dummy) -> (image, RenderAux)`` renders one
    view (default: ``render`` of the whole image; parallel/sharded.py passes
    its strip render and gather).  Returns (grads dict, vs_grad [K, N, 2],
    pos_grad [K, N, 3], reps, auxs, imgs): each view's vs_grad / pos_grad is
    its gradient / K."""
    if render_view is None:
        def render_view(p, cam, vs):
            return render(p, cam, cfg.raster, vs_dummy=vs)

    k = len(cameras)
    trainable = [getattr(params, f) for f in optimizer.TRAINABLE]
    dev = params.means.device
    vs_zero = torch.zeros((k, params.capacity, 2), dtype=torch.float32, device=dev,
                          requires_grad=True)
    pos_zero = torch.zeros((k, params.capacity, 3), dtype=torch.float32, device=dev,
                           requires_grad=True)
    reps, auxs, imgs = [], [], []
    with torch.enable_grad():
        for v, (cam, gt) in enumerate(zip(cameras, gt_images)):
            view = _ParamsView(params.means + pos_zero[v], params.log_scales, params.quats,
                               params.raw_opacities, params.sh, params.alive)
            img, aux = render_view(view, cam, vs_zero[v])
            tracing.mark("loss", img)
            reps.append(photometric_loss(img, gt, cfg.loss))
            auxs.append(aux)
            imgs.append(img)
        loss = torch.stack([r.grad_loss for r in reps]).mean()
        tracing.mark("loss_bwd", loss)
        *grads, vs_grad, pos_grad = torch.autograd.grad(loss, trainable + [vs_zero, pos_zero])
    return dict(zip(optimizer.TRAINABLE, grads)), vs_grad, pos_grad, reps, auxs, imgs


def batched_update(state: TrainState, grad: dict, vs_grad, pos_grad, reps, imgs, gt_images,
                   num_pairs, overflow, cfg: Config, scalars: torch.Tensor):
    """The rest of train_step_batched: Adam on the mean gradient, then the
    K views' density statistics folded in view order, each at its own
    gradient (vs_grad * K, pos_grad * K), as K sequential accumulate()
    calls would (trainer.py:190-202).  ``scalars`` as step_body takes
    them."""
    k = len(reps)
    tracing.mark("adam", state.params.means)
    lrs = schedule.rates(cfg.optim, scalars[0])
    new_params, new_opt = optimizer.step(state.params, grad, state.opt, lrs, cfg.optim,
                                         (scalars[1], scalars[2]))
    accum = state.accum
    for v in range(k):
        accum = density.accumulate(accum, vs_grad[v] * k, pos_grad[v] * k, cfg.density)
    with torch.no_grad():
        metrics = StepMetrics(
            loss=torch.stack([r.combined_mean for r in reps]).detach().mean(),
            l1=torch.stack([r.l1_mean for r in reps]).detach().mean(),
            dssim=torch.stack([r.dssim_mean for r in reps]).detach().mean(),
            # of the K views' pooled MSE, as JAX's psnr of the stacked views
            psnr=psnr(torch.stack([img.detach() for img in imgs]),
                      torch.stack(list(gt_images))),
            num_pairs=num_pairs,
            overflow=overflow,
            position_lr=lrs.position,
            num_gaussians=new_params.count(),
            mean_opacity=_mean_opacity(new_params),
            mean_world_scale=_mean_world_scale(new_params),
        )
    new_state = TrainState(params=new_params, opt=new_opt, accum=accum,
                           generator=state.generator)
    return new_state, metrics


def batched_body(state: TrainState, cameras: Sequence[Camera], gt_images, cfg: Config,
                 scalars: torch.Tensor) -> tuple[TrainState, StepMetrics]:
    """One Adam step on the mean loss of K views, given its ``scalars`` as
    step_body takes them.  What train/graph.py captures (K views per
    replay) and train_step_batched_eager runs; it reads no device value
    back to the host."""
    grad, vs_grad, pos_grad, reps, auxs, imgs = batched_view_grads(
        state.params, cameras, gt_images, cfg)
    num_pairs = torch.stack([a.num_pairs for a in auxs]).amax()
    overflow = torch.stack([a.overflow for a in auxs]).any()
    return batched_update(state, grad, vs_grad, pos_grad, reps, imgs, gt_images,
                          num_pairs, overflow, cfg, scalars)


def train_step_batched_eager(state: TrainState, cameras: Sequence[Camera], gt_images,
                             cfg: Config, total_iters: int) -> tuple[TrainState, StepMetrics]:
    """One batched step run op by op: batched_body with the schedule's
    scalars.  The CPU's train_step_batched, and the yardstick of the
    captured one on the card."""
    scalars = device_scalars(cfg, state.opt.t, 1, total_iters, state.params.means.device)
    return batched_body(state, cameras, gt_images, cfg, scalars[0])


def train_step_batched(
    state: TrainState,
    cameras: Sequence[Camera],
    gt_images,
    cfg: Config,
    total_iters: int,
) -> tuple[TrainState, StepMetrics]:
    """One Adam step on the MEAN loss over K views (gradient accumulation),
    the JAX ``train_step_batched`` (trainer.py:141-216): ``cameras`` K
    cameras of one resolution, ``gt_images`` [K, H, W, 3] or K images.
    Per-view density statistics come from a per-view zero ``pos_dummy``
    added to the means and a per-view ``vs_dummy``.  ``metrics.num_pairs``
    is the MAX per-view pair count (what pair capacity must cover),
    ``overflow`` any view's.  With K = 1 it is train_step, bit for bit.
    Functional, as train_step.  On a CUDA device one replay of the batched
    body's CUDA graph (train/graph.py: captured at the first call for this
    K, capacity, resolution and Config); on the CPU,
    train_step_batched_eager."""
    dev = state.params.means.device
    if dev.type == "cuda":
        scalars = device_scalars(cfg, state.opt.t, 1, total_iters, dev)
        new_state, ms = graph.run_steps(batched_body, state, cameras, gt_images, cfg, scalars,
                                        views=len(cameras))
        return new_state, _metrics_at(ms, 0)
    return train_step_batched_eager(state, cameras, gt_images, cfg, total_iters)


def _mean_opacity(params) -> torch.Tensor:
    alive = params.alive.to(torch.float32)
    n = torch.clamp(alive.sum(), min=1.0)
    return (T.sigmoid(params.raw_opacities) * alive).sum() / n


def _mean_world_scale(params) -> torch.Tensor:
    alive = params.alive.to(torch.float32)
    n = torch.clamp(alive.sum(), min=1.0)
    max_scale = torch.exp(torch.clamp(params.log_scales, -8.0, 8.0)).amax(-1)
    return (max_scale * alive).sum() / n


def densify_body(state: TrainState, iteration, r: torch.Tensor, focal: torch.Tensor,
                 cfg: Config, scene_extent: float) -> tuple[TrainState, density.DensityStats]:
    """One density event on ``state`` given its iteration (an int, or a 0-d
    int32 tensor on the parameters' device), the split draw ``r`` and the
    focal length.  What train/graph.py captures and densify_step_eager
    runs; it reads no device value back to the host.  The new state keeps
    ``state``'s generator."""
    tracing.mark("densify", state.params.means)
    avg_depth = 2.0 * scene_extent  # conservative (mtl_engine.mm:1128)
    params, opt, accum, stats = density.apply(
        state.params, state.opt, state.accum, iteration, r,
        scene_extent, focal, avg_depth, cfg.density,
    )
    return TrainState(params=params, opt=opt, accum=accum, generator=state.generator), stats


def _draw(state: TrainState):
    """(an advanced clone of the state's generator, the split draw it
    made on the parameters' device)."""
    with tracing.span("density.draw"):
        generator = state_mod.clone_generator(state.generator)
        return generator, density.draw_split_offsets(generator, state.params.capacity,
                                                     state.params.means.device)


def densify_step_eager(
    state: TrainState,
    scene_extent: float,
    focal: torch.Tensor,
    cfg: Config,
) -> tuple[TrainState, density.DensityStats]:
    """densify_step run op by op: densify_body at the state's iteration.
    The CPU's densify_step, and the yardstick of the captured one on the
    card."""
    generator, r = _draw(state)
    new_state, stats = densify_body(state, state.opt.t, r, focal, cfg, scene_extent)
    return dataclasses.replace(new_state, generator=generator), stats


def densify_step(
    state: TrainState,
    scene_extent: float,
    focal: torch.Tensor,
    cfg: Config,
) -> tuple[TrainState, density.DensityStats]:
    """One density-control event (mtl_engine.mm:1105-1168).  Draws the
    split offsets on a clone of the state's generator (on the host, once
    per event) and returns the advanced clone in the new state.  On a CUDA
    device a replay of densify_body's CUDA graph (graph.run_event: captured
    once per capacity, SH width, DensityConfig and scene extent; the
    iteration, the draw and ``focal`` copied in, the state and the stats
    cloned out); on the CPU, densify_step_eager."""
    dev = state.params.means.device
    if dev.type != "cuda":
        return densify_step_eager(state, scene_extent, focal, cfg)
    generator, r = _draw(state)
    inputs = (torch.tensor(state.opt.t, dtype=torch.int32), r,
              torch.as_tensor(focal, dtype=torch.float32))
    new_state, stats = graph.run_event(densify_body, state, inputs, cfg, scene_extent)
    return dataclasses.replace(new_state, generator=generator), stats


@torch.no_grad()
def opacity_reset_body(state: TrainState, cfg: Config) -> tuple[TrainState, tuple]:
    """Clamp raw opacities to min(op, reset_value), zero opacity+scale
    momentum, reset density accumulators (mtl_engine.mm:1170-1193).  What
    train/graph.py captures and opacity_reset_step_eager runs; returns
    (state, ())."""
    p = state.params
    tracing.mark("opacity_reset", p.means)
    raw = p.raw_opacities.detach()
    new_op = torch.where(p.alive, torch.clamp(raw, max=cfg.density.opacity_reset_value), raw)
    params = type(p)(
        means=p.means.detach(), log_scales=p.log_scales.detach(),
        quats=p.quats.detach(), raw_opacities=new_op, sh=p.sh.detach(),
        alive=p.alive,
    )
    return dataclasses.replace(
        state,
        params=params,
        opt=optimizer.reset_opacity_and_scale_momentum(state.opt),
        accum=density.init_accum(p.capacity, device=raw.device),
    ), ()


def opacity_reset_step_eager(state: TrainState, cfg: Config) -> TrainState:
    """opacity_reset_step run op by op: the CPU's, and the yardstick of the
    captured one on the card."""
    return opacity_reset_body(state, cfg)[0]


def opacity_reset_step(state: TrainState, cfg: Config) -> TrainState:
    """The opacity reset (opacity_reset_body).  On a CUDA device a replay
    of its CUDA graph (graph.run_event: captured once per capacity, SH
    width and DensityConfig); on the CPU, opacity_reset_step_eager."""
    if state.params.means.device.type != "cuda":
        return opacity_reset_step_eager(state, cfg)
    return graph.run_event(opacity_reset_body, state, (), cfg)[0]


def should_densify(iteration: int, cfg: Config) -> bool:
    """iteration > from AND < until AND % interval == 0 (mtl_engine.mm:1112-1115)."""
    d = cfg.density
    return (
        iteration > d.densify_from_iter
        and iteration < d.densify_until_iter
        and iteration % d.densify_interval == 0
    )


def should_reset_opacity(iteration: int, cfg: Config) -> bool:
    """% 3000 == 0, > 0, < densify_until (mtl_engine.mm:1173-1176)."""
    d = cfg.density
    return (
        iteration > 0
        and iteration % d.opacity_reset_interval == 0
        and iteration < d.densify_until_iter
    )


def _steps_until_event(iteration, cfg, adaptive_pairs, adapt_interval,
                       ckpt_interval, snap_interval):
    """Largest k such that no schedule event fires strictly inside
    (iteration, iteration + k) — an event exactly at the chunk end is fine
    (the loop handles it after the chunk's steps return)."""
    d = cfg.density

    def next_mult(interval):
        return interval * (iteration // interval + 1) - iteration

    gaps = []
    j = iteration + next_mult(d.densify_interval)
    while j <= d.densify_from_iter:
        j += d.densify_interval
    if j < d.densify_until_iter:
        gaps.append(j - iteration)
    j = iteration + next_mult(d.opacity_reset_interval)
    if j < d.densify_until_iter:
        gaps.append(j - iteration)
    if adaptive_pairs:
        gaps.append(next_mult(adapt_interval))
    if ckpt_interval:
        gaps.append(next_mult(ckpt_interval))
    if snap_interval:
        gaps.append(next_mult(snap_interval))
    return min(gaps) if gaps else 1 << 30


def _metrics_at(ms: StepMetrics, i: int) -> StepMetrics:
    return StepMetrics(*(x[i] for x in ms))


def train_loop(
    state: TrainState,
    cameras: list[Camera],
    gt_images: list[torch.Tensor],
    cfg: Config,
    scene_extent: float,
    num_epochs: int | None = None,
    log_fn=None,
    metrics_fn=None,
    checkpoint_fn=None,
    checkpoint_interval: int = 0,
    mesh_devices: int = 1,
    snapshot_fn=None,
    shuffle_seed: int | None = None,
    batch_views: int = 1,
    adaptive_pairs: bool = False,
    adapt_interval: int = 50,
    min_pair_capacity: int = 1 << 16,
    adaptive_capacity: bool = False,
    max_capacity: int | None = None,
    scan_steps: int = 1,
) -> TrainState:
    """Epochs x views, densify/reset on schedule (mtl_engine.mm:1047-1221),
    as the JAX ``train_loop``: the same iteration counting (events fire
    after the step that reaches their iteration), callbacks and log lines.

    metrics_fn(iteration, StepMetrics) fires every step; checkpoint_fn
    (iteration, state) every ``checkpoint_interval`` iters; snapshot_fn
    (iteration, state, camera, gt) every cfg.train.snapshot_interval iters;
    ``shuffle_seed`` shuffles the view order per epoch with
    ``random.Random`` (the JAX package's order for the same seed).

    ``batch_views`` > 1 takes one Adam step on the mean gradient of K views
    (train_step_batched): the views of an epoch go in groups of K in view
    order, the last group wrapping around to the epoch's first views, and
    the iteration counts optimizer steps, so the schedules see ceil(views /
    K) steps per epoch; densify and snapshots take the group's first view.
    ``mesh_devices`` > 1 runs the tile-sharded step (or sharded batched
    step) of parallel/sharded.py on every rank of the initialized
    ``torch.distributed`` process group (launch.initialize or
    launch.spawn); without one it raises.

    ``scan_steps`` > 1 runs chunks of that many steps through
    ``train_steps`` (on the card, K replays of the captured step; the same
    semantics as the JAX scan) wherever no event falls inside the chunk; only the plain single-view
    path chunks (batch_views == 1, mesh_devices == 1).  ``adaptive_pairs``
    rebuckets the pair capacity every ``adapt_interval`` iters to the next
    power of two above 1.5x the recent peak (within [min_pair_capacity,
    cfg.raster.pair_capacity]), doubling on overflow.  ``adaptive_capacity``
    grows the Gaussian arrays (``state.grow``) to the next power of two when
    a densify event fills 85% of them, up to ``max_capacity`` (default: the
    density hard cap).
    """
    epochs = num_epochs if num_epochs is not None else cfg.train.epochs
    steps_per_epoch = -(-len(cameras) // batch_views)
    total_iters = epochs * steps_per_epoch
    iteration = int(state.opt.t)

    max_pair_capacity = cfg.raster.pair_capacity
    if adaptive_pairs:
        cap = min(max_pair_capacity, max(min_pair_capacity, 1))
        cfg = cfg.replace(raster=cfg.raster.replace(pair_capacity=cap))
    recent_peak = 0

    if mesh_devices > 1:
        from gaussiansplatting_tpu_torch.parallel import mesh as mesh_mod
        from gaussiansplatting_tpu_torch.parallel import sharded

        mesh = mesh_mod.make_mesh(mesh_devices)

    def build_step_fn(cfg):
        if mesh_devices > 1:
            if batch_views > 1:
                return sharded.make_sharded_train_step_batched(mesh, cfg, total_iters,
                                                               batch_views)
            return sharded.make_sharded_train_step(mesh, cfg, total_iters)
        if batch_views > 1:
            return lambda st, cams, gts: train_step_batched(st, cams, gts, cfg, total_iters)
        return lambda st, cam, gt: train_step(st, cam, gt, cfg, total_iters)

    step_fn = build_step_fn(cfg)
    order_rng = random.Random(shuffle_seed) if shuffle_seed is not None else None

    if batch_views > 1 or scan_steps > 1:
        sizes = {(c.width, c.height) for c in cameras}
        if len(sizes) > 1:
            which = "batch_views" if batch_views > 1 else "scan_steps"
            raise ValueError(f"{which} requires one resolution, got {sizes}")
    use_scan = scan_steps > 1 and mesh_devices == 1 and batch_views == 1

    for epoch in range(epochs):
        order = list(range(len(cameras)))
        if order_rng is not None:
            order_rng.shuffle(order)
        if batch_views > 1:
            # (cameras, ground truth, the first view's camera and ground
            # truth: densify needs one focal, snapshot_fn one view)
            groups = [[order[(i + j) % len(order)] for j in range(batch_views)]
                      for i in range(0, len(order), batch_views)]
            views = [([cameras[v] for v in g], [gt_images[v] for v in g],
                      cameras[g[0]], gt_images[g[0]]) for g in groups]
        else:
            views = [(cameras[v], gt_images[v], cameras[v], gt_images[v]) for v in order]
        idx = 0
        while idx < len(views):
            k = 1
            if use_scan and idx + scan_steps <= len(views):
                gap = _steps_until_event(
                    iteration, cfg, adaptive_pairs, adapt_interval,
                    checkpoint_interval if checkpoint_fn else 0,
                    cfg.train.snapshot_interval if snapshot_fn else 0,
                )
                if gap >= scan_steps:
                    k = scan_steps
            if k > 1:
                chunk = views[idx:idx + k]
                with tracing.span("loop.chunk"):
                    state, ms = train_steps(state, [c[0] for c in chunk],
                                            [c[1] for c in chunk], cfg, total_iters)
                for i in range(k):
                    iteration += 1
                    if metrics_fn:
                        metrics_fn(iteration, _metrics_at(ms, i))
                metrics = _metrics_at(ms, k - 1)
            else:
                cam, gt, _, _ = views[idx]
                with tracing.span("loop.chunk"):
                    state, metrics = step_fn(state, cam, gt)
                iteration += 1
                if metrics_fn:
                    metrics_fn(iteration, metrics)
            cam0, gt0 = views[idx + k - 1][2:]
            idx += k

            if adaptive_pairs and iteration % adapt_interval == 0:
                with tracing.span("loop.pair_read"):
                    pairs_now = int(metrics.num_pairs)
                    overflowed = bool(metrics.overflow)
                recent_peak = max(recent_peak, pairs_now)
                cur = cfg.raster.pair_capacity
                if overflowed:
                    want = min(cur * 2, max_pair_capacity)
                else:
                    want = 1 << max(int(recent_peak * 1.5) - 1, 1).bit_length()
                    want = min(max(want, min_pair_capacity), max_pair_capacity)
                if want != cur:
                    cfg = cfg.replace(raster=cfg.raster.replace(pair_capacity=want))
                    step_fn = build_step_fn(cfg)
                    recent_peak = pairs_now
                    if log_fn:
                        log_fn(
                            f"iter {iteration}: pair capacity {cur} -> {want} "
                            f"(live pairs {pairs_now})"
                        )
            if checkpoint_fn and checkpoint_interval and iteration % checkpoint_interval == 0:
                checkpoint_fn(iteration, state)
            if (
                snapshot_fn
                and cfg.train.snapshot_interval
                and iteration % cfg.train.snapshot_interval == 0
            ):
                snapshot_fn(iteration, state, cam0, gt0)

            if should_densify(iteration, cfg):
                with tracing.span("loop.densify"):
                    state, stats = densify_step(state, scene_extent, cam0.fx, cfg)
                    cap = state.params.capacity
                    limit = int(max_capacity or cfg.density.max_gaussians)
                    grow = (adaptive_capacity and int(stats.count) >= int(0.85 * cap)
                            and cap < limit)
                if log_fn:
                    log_fn(
                        f"iter {iteration}: densify pruned={int(stats.pruned)} "
                        f"cloned={int(stats.cloned)} split={int(stats.split)} "
                        f"total={int(stats.count)}"
                    )
                if grow:
                    new_cap = min(cap * 2, limit)
                    with tracing.span("loop.grow"):
                        state = state_mod.grow(state, new_cap)
                    if log_fn:
                        log_fn(f"iter {iteration}: capacity {cap} -> {new_cap}")
            if should_reset_opacity(iteration, cfg):
                with tracing.span("loop.opacity_reset"):
                    state = opacity_reset_step(state, cfg)
                if log_fn:
                    log_fn(f"iter {iteration}: opacity reset")

            if log_fn and (idx - k) % cfg.train.log_interval == 0:
                log_fn(
                    f"epoch {epoch} [{idx}/{len(cameras)}] "
                    f"loss={float(metrics.loss):.4f} psnr={float(metrics.psnr):.2f} "
                    f"n={int(metrics.num_gaussians)} pairs={int(metrics.num_pairs)}"
                )
    return state
