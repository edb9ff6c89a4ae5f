"""Training step: render, loss, gradient, Adam and the density statistics
of one view.

Counterpart of ``_train_step_impl`` / ``train_step`` / ``train_steps`` in
gaussiansplatting_tpu/train/trainer.py (reference: trainStep,
mtl_engine.mm:856-1025).  PyTorch runs eagerly, so a step is a Python
function; the gradients come from ``torch.autograd.grad`` over the five
trainable parameter groups and a zero ``vs_dummy`` whose gradient is the
view-space positional gradient.  ``train_step_batched`` and ``train_loop``
(densify / prune / opacity reset schedule) are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussiansplatting_tpu_torch.config import Config
from gaussiansplatting_tpu_torch.core import transforms as T
from gaussiansplatting_tpu_torch.core.camera import Camera
from gaussiansplatting_tpu_torch.density import control as density
from gaussiansplatting_tpu_torch.ops.losses import photometric_loss, psnr
from gaussiansplatting_tpu_torch.ops.rasterize import render
from gaussiansplatting_tpu_torch.train import optimizer, schedule
from gaussiansplatting_tpu_torch.train.state import TrainState


class StepMetrics(NamedTuple):
    loss: torch.Tensor        # combined (1-l)L1 + l*DSSIM per-pixel mean
    l1: torch.Tensor
    dssim: torch.Tensor
    psnr: torch.Tensor
    num_pairs: torch.Tensor
    overflow: torch.Tensor
    position_lr: float
    num_gaussians: torch.Tensor
    # population statistics (reference: per-200-step opacity/scale sample
    # dump, mtl_engine.mm:1009-1022)
    mean_opacity: torch.Tensor
    mean_world_scale: torch.Tensor


def train_step(
    state: TrainState,
    camera: Camera,
    gt_image: torch.Tensor,
    cfg: Config,
    total_iters: int,
) -> tuple[TrainState, StepMetrics]:
    """One optimization step on one view.  Functional: returns a new state
    and leaves ``state`` as it was."""
    params = state.params
    trainable = [getattr(params, f) for f in optimizer.TRAINABLE]
    vs_zero = torch.zeros((params.capacity, 2), dtype=torch.float32,
                          device=params.means.device, requires_grad=True)
    with torch.enable_grad():
        img, aux = render(params, camera, cfg.raster, vs_dummy=vs_zero)
        rep = photometric_loss(img, gt_image, cfg.loss)
        *grads, vs_grad = torch.autograd.grad(rep.grad_loss, trainable + [vs_zero])
    grad = dict(zip(optimizer.TRAINABLE, grads))

    # LR uses the pre-increment iteration count (mtl_engine.mm:1092-1094)
    lrs = schedule.learning_rates(cfg.optim, state.opt.t, total_iters)
    new_params, new_opt = optimizer.step(params, grad, state.opt, lrs, cfg.optim)

    # density statistics (reference: DensityController::accumulateGradients
    # after every backward, mtl_engine.mm:1000-1002)
    new_accum = density.accumulate(state.accum, vs_grad, grad["means"], cfg.density)

    with torch.no_grad():
        metrics = StepMetrics(
            loss=rep.combined_mean.detach(),
            l1=rep.l1_mean.detach(),
            dssim=rep.dssim_mean.detach(),
            psnr=psnr(img.detach(), gt_image),
            num_pairs=aux.num_pairs,
            overflow=aux.overflow,
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
    """K sequential optimization steps (one per view), the semantics of the
    JAX ``train_steps`` scan as a plain loop.  Returns (state, metrics) with
    every StepMetrics field stacked [K]."""
    steps = []
    for cam, gt in zip(cameras, gt_images):
        state, m = train_step(state, cam, gt, cfg, total_iters)
        steps.append(m)
    dev = state.params.means.device
    stacked = [
        torch.stack(xs) if isinstance(xs[0], torch.Tensor)
        else torch.tensor(xs, dtype=torch.float32, device=dev)
        for xs in zip(*steps)
    ]
    return state, StepMetrics(*stacked)


def _mean_opacity(params) -> torch.Tensor:
    alive = params.alive.to(torch.float32)
    n = torch.clamp(alive.sum(), min=1.0)
    return (T.sigmoid(params.raw_opacities) * alive).sum() / n


def _mean_world_scale(params) -> torch.Tensor:
    alive = params.alive.to(torch.float32)
    n = torch.clamp(alive.sum(), min=1.0)
    max_scale = torch.exp(torch.clamp(params.log_scales, -8.0, 8.0)).amax(-1)
    return (max_scale * alive).sum() / n
