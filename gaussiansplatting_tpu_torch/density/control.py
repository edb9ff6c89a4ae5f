"""Density-control statistics: the per-view accumulation the train step
runs.  Counterpart of gaussiansplatting_tpu/density/control.py:31-63
(densify, prune and split are not ported yet)."""

from __future__ import annotations

import dataclasses

import torch

from gaussiansplatting_tpu_torch.config import DensityConfig


@dataclasses.dataclass
class DensityAccum:
    """Per-Gaussian view-space gradient statistics
    (density_control.mm:121-185)."""

    grad_accum: torch.Tensor      # [C] sum of clamped ||dL/dscreen|| per view
    grad_count: torch.Tensor      # [C] int32 contributing views
    pos_grad_accum: torch.Tensor  # [C, 3] summed position gradients


def init_accum(capacity: int, device=None) -> DensityAccum:
    return DensityAccum(
        grad_accum=torch.zeros((capacity,), dtype=torch.float32, device=device),
        grad_count=torch.zeros((capacity,), dtype=torch.int32, device=device),
        pos_grad_accum=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
    )


@torch.no_grad()
def accumulate(
    accum: DensityAccum,
    vs_grad: torch.Tensor,   # [C, 2] this view's screen-space gradient
    pos_grad: torch.Tensor,  # [C, 3] this view's position gradient
    cfg: DensityConfig,
) -> DensityAccum:
    mag = torch.clamp(torch.linalg.norm(vs_grad, dim=-1), max=cfg.viewspace_grad_clip)
    contrib = torch.isfinite(mag) & (mag > 0.0)
    return DensityAccum(
        grad_accum=accum.grad_accum + torch.where(contrib, mag, 0.0),
        grad_count=accum.grad_count + contrib.to(torch.int32),
        pos_grad_accum=accum.pos_grad_accum
        + torch.where(contrib[:, None], pos_grad, 0.0),
    )
