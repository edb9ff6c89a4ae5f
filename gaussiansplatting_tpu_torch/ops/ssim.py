"""Differentiable SSIM / D-SSIM via separable Gaussian blurs.

Counterpart of gaussiansplatting_tpu/ops/ssim.py: the reference's per-pixel
SSIM (shaders.metal:380-483) — 11x11 window, sigma 1.5, grayscale =
mean(RGB), replicate boundary, C1 = 0.01^2, C2 = 0.03^2, D-SSIM =
clamp((1 - SSIM) / 2, 0, 1) — as three separable blurs (x, x^2, xy), each a
pair of band-matrix products.  The JAX package pins those products to full
float32 (``Precision.HIGHEST``); here they are float32 ``torch.matmul``,
which stays full float32 as long as TF32 matmuls are off, torch's default
(``torch.backends.cuda.matmul.allow_tf32``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _gauss_kernel_1d_np(window: int, sigma: float) -> np.ndarray:
    r = window // 2
    d = np.arange(-r, r + 1, dtype=np.float64)
    w = np.exp(-(d * d) / (2.0 * sigma * sigma))
    # normalized per pass: the same 2D normalization as the reference's
    # full-window sum (shaders.metal:430-436)
    return (w / w.sum()).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _band_matrix_np(size: int, window: int, sigma: float) -> np.ndarray:
    """[size, size] band matrix B with replicate-edge semantics:
    (x @ B)[j] = sum_d k[d] * x[clip(j + d - r, 0, size-1)]."""
    k = _gauss_kernel_1d_np(window, sigma)
    r = window // 2
    b = np.zeros((size, size), np.float32)
    for d in range(window):
        src = np.clip(np.arange(size) + d - r, 0, size - 1)
        np.add.at(b, (src, np.arange(size)), k[d])
    return b


@functools.lru_cache(maxsize=16)
def _band_matrix(size: int, window: int, sigma: float, device) -> torch.Tensor:
    """The band matrix as a tensor on ``device``, built and copied once."""
    return torch.tensor(_band_matrix_np(size, window, sigma), device=device)


def _blur_many(imgs: torch.Tensor, window: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of K stacked [K, H, W] planes with replicate
    padding: [K, H, W] @ B_w, then B_h^T @ the result."""
    _, h, w = imgs.shape
    bw = _band_matrix(w, window, sigma, imgs.device)
    bh = _band_matrix(h, window, sigma, imgs.device)
    return torch.matmul(bh.T, torch.matmul(imgs, bw))


def dssim_map(
    rendered: torch.Tensor,
    ground_truth: torch.Tensor,
    window: int = 11,
    sigma: float = 1.5,
    c1: float = 0.01 ** 2,
    c2: float = 0.03 ** 2,
) -> torch.Tensor:
    """Per-pixel D-SSIM map [H, W] from [H, W, 3] images in [0, 1]."""
    x = rendered.mean(-1)        # grayscale mean-RGB (shaders.metal:443)
    y = ground_truth.mean(-1)

    mu_x, mu_y, e_xx, e_yy, e_xy = _blur_many(
        torch.stack([x, y, x * x, y * y, x * y]), window, sigma
    )

    var_x = e_xx - mu_x * mu_x
    var_y = e_yy - mu_y * mu_y
    cov_xy = e_xy - mu_x * mu_y

    num = (2.0 * mu_x * mu_y + c1) * (2.0 * cov_xy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (var_x + var_y + c2)
    ssim = num / den
    return torch.clamp((1.0 - ssim) / 2.0, 0.0, 1.0)
