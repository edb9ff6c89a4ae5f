"""Synthetic scenes for smoke tests and benchmarks.

Counterpart of gaussiansplatting_tpu/utils/synthetic.py: the same numpy RNG
calls in the same order, so a seed gives bit-identical arrays in both
packages.
"""

from __future__ import annotations

import numpy as np

from gaussiansplatting_tpu_torch.core import gaussians as gaussians_mod
from gaussiansplatting_tpu_torch.core.camera import Camera, make_camera
from gaussiansplatting_tpu_torch.core.transforms import sh_coeffs
from gaussiansplatting_tpu_torch.core.gaussians import GaussianParams


def make_scene(
    n: int,
    seed: int = 0,
    spread: float = 1.0,
    z_center: float = 4.0,
    capacity: int | None = None,
    log_scale_range: tuple = (-4.6, -3.0),
    device=None,
    sh_degree: int = 0,
) -> GaussianParams:
    """Random Gaussians in a box in front of the canonical camera (identity
    pose looking down +z).  The default log-scale range gives ~2-8 covered
    tiles per Gaussian at the canonical camera.  The SH row holds
    core/transforms.sh_coeffs(sh_degree) coefficients, the DC drawn and the
    rest zero (the same draws at every degree)."""
    rng = np.random.default_rng(seed)
    means = np.concatenate(
        [
            rng.uniform(-spread, spread, (n, 2)),
            rng.uniform(z_center - 1.0, z_center + 1.0, (n, 1)),
        ],
        axis=1,
    ).astype(np.float32)
    log_scales = rng.uniform(*log_scale_range, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    raw_op = rng.uniform(-1.0, 3.0, (n,)).astype(np.float32)
    sh = np.zeros((n, sh_coeffs(sh_degree), 3), np.float32)
    sh[:, 0, :] = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    return gaussians_mod.from_arrays(
        means, log_scales, quats, raw_op, sh, capacity=capacity, device=device
    )


def make_canonical_camera(
    width: int = 128, height: int = 128, fov_scale: float = 1.2, device=None
) -> Camera:
    """Identity-pose camera whose intrinsics frame the make_scene unit box."""
    return make_camera(
        quat_wxyz=np.array([1.0, 0.0, 0.0, 0.0], np.float32),
        translation=np.zeros(3, np.float32),
        fx=width * fov_scale,
        fy=width * fov_scale,
        cx=width / 2.0,
        cy=height / 2.0,
        cam_width=width,
        cam_height=height,
        device=device,
    )
