"""Photometric training loss.

Counterpart of gaussiansplatting_tpu/ops/losses.py.  The reference logs
(1-lambda)*L1 + lambda*D-SSIM (shaders.metal:487-511) but backpropagates only
dL/dpixel = sign(diff)/3, the gradient of the UNWEIGHTED PER-PIXEL-SUMMED L1
(tiled_shaders.metal:417-423).  So:

  * the gradient-carrying loss is a SUM over pixels, not a mean (the Adam
    clips at +/-0.5 are tuned against that magnitude);
  * ``dssim_in_grad`` selects between strict reference-gradient parity
    (L1-sum only) and the fully differentiable combined loss (default).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussiansplatting_tpu_torch.config import LossConfig
from gaussiansplatting_tpu_torch.ops.ssim import dssim_map


class LossReport(NamedTuple):
    grad_loss: torch.Tensor       # the scalar that is differentiated
    combined_mean: torch.Tensor   # (1-l)*L1 + l*DSSIM, per-pixel mean (logged)
    l1_mean: torch.Tensor
    dssim_mean: torch.Tensor


def l1_per_pixel(rendered: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean-over-RGB absolute error per pixel (shaders.metal:320-340)."""
    return (rendered - gt).abs().mean(-1)


def photometric_loss(rendered: torch.Tensor, gt: torch.Tensor,
                     cfg: LossConfig) -> LossReport:
    l1 = l1_per_pixel(rendered, gt)
    dssim = dssim_map(
        rendered, gt, cfg.ssim_window, cfg.ssim_sigma, cfg.ssim_c1, cfg.ssim_c2
    )
    lam = cfg.lambda_dssim
    if cfg.dssim_in_grad:
        grad_loss = (1.0 - lam) * l1.sum() + lam * dssim.sum()
    else:
        # strict parity: gradient of sum(L1) only, D-SSIM observed but inert
        grad_loss = l1.sum() + 0.0 * dssim.sum().detach()
    l1_mean = l1.mean()
    dssim_mean = dssim.mean()
    return LossReport(
        grad_loss=grad_loss,
        combined_mean=(1.0 - lam) * l1_mean + lam * dssim_mean,
        l1_mean=l1_mean,
        dssim_mean=dssim_mean,
    )


def psnr(rendered: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = ((rendered - gt) ** 2).mean()
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


# -- 2D Gaussian Splatting's regularizers (Huang et al. 2024, eqs. 13-15)


def depth_to_normal(depth: torch.Tensor, camera) -> torch.Tensor:
    """The normal map [H, W, 3] of a depth map [H, W] in camera space: each
    pixel centre back-projected at its depth, P = z ((x - cx) / fx, (y -
    cy) / fy, 1), the normal normalize((P_below - P_above) x (P_right -
    P_left)) on interior pixels (facing the camera), 0 on the border, as
    2DGS's depth_to_normal takes it."""
    h, w = depth.shape
    cx = (camera.proj[0, 2] + 1.0) * (0.5 * w)
    cy = (camera.proj[1, 2] + 1.0) * (0.5 * h)
    xs = (torch.arange(w, dtype=depth.dtype, device=depth.device) + 0.5 - cx) / camera.fx
    ys = (torch.arange(h, dtype=depth.dtype, device=depth.device) + 0.5 - cy) / camera.fy
    pts = torch.stack([xs[None, :] * depth, ys[:, None] * depth, depth], dim=-1)
    d_row = pts[2:, 1:-1] - pts[:-2, 1:-1]
    d_col = pts[1:-1, 2:] - pts[1:-1, :-2]
    n = torch.nn.functional.normalize(torch.linalg.cross(d_row, d_col, dim=-1), dim=-1)
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))


class Regularizers(NamedTuple):
    grad_sum: torch.Tensor      # lambda_dist sum(dist) + lambda_normal sum(normal error)
    weighted_mean: torch.Tensor  # the same over the pixels' mean (logged)
    dist_mean: torch.Tensor
    normal_mean: torch.Tensor


def surfel_regularizers(frame, camera, cfg: LossConfig) -> Regularizers:
    """The depth distortion and the normal consistency of a surfel frame
    (ops/rasterize.SurfelFrame): the distortion map as it comes (eq. 13,
    squared form), and the normal error 1 - n . N per pixel, n the
    rendered sum w n, N depth_to_normal of the expected depth times alpha
    with no gradient through alpha (2DGS's depth_ratio 0; eq. 14 as its
    public training script takes it).  Summed over the pixels for the
    gradient, as photometric_loss sums the L1 and D-SSIM maps, so the
    weights keep their ratio to the photometric terms."""
    surf = depth_to_normal(frame.depth, camera) * frame.alpha.detach()[..., None]
    err = 1.0 - (frame.normal * surf).sum(-1)
    dist_mean, normal_mean = frame.dist.mean(), err.mean()
    return Regularizers(
        grad_sum=cfg.lambda_dist * frame.dist.sum() + cfg.lambda_normal * err.sum(),
        weighted_mean=cfg.lambda_dist * dist_mean + cfg.lambda_normal * normal_mean,
        dist_mean=dist_mean, normal_mean=normal_mean)
