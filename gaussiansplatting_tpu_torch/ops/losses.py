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
