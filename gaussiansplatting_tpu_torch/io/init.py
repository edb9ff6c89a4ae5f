"""Gaussian initialization from a COLMAP point cloud.

Counterpart of gaussiansplatting_tpu/io/init.py (reference:
gaussiansFromColmap, main.mm:59-187): isotropic log scales from mean 3-NN
distances (point clouds >10k: a 1000-point sample, its median assigned to
all, main.mm:87-123), clamped to [1e-4, 0.1] * scene extent, identity
quaternions, raw opacity 0 (sigmoid = 0.5), SH DC = (rgb - 0.5)/SH_C0, the
higher bands zero in a row of core/transforms.sh_coeffs(sh_degree)
coefficients.  Surfels (``scale_axes=2``) take the same scale on their two
axes.

The kNN is scipy's KD-tree (``cKDTree``), the JAX package's fallback path;
the optional native kNN of ``native/`` is not carried.  ``knn_mode='exact'``
takes every point's own kNN instead of the reference's one median.
"""

from __future__ import annotations

import numpy as np

from gaussiansplatting_tpu_torch.config import InitConfig
from gaussiansplatting_tpu_torch.core.transforms import SH_C0, sh_coeffs
from gaussiansplatting_tpu_torch.io.ply import GaussianCloud


def _knn_dist(points: np.ndarray, queries: np.ndarray, k: int) -> np.ndarray:
    """[Q, k] distances from each query to its k nearest points, the query
    itself (the nearest hit, at distance 0) excluded."""
    from scipy.spatial import cKDTree

    dist, _ = cKDTree(points).query(queries, k=k + 1, workers=-1)
    return dist[:, 1:]


def knn_mean_distances(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Mean distance to the k nearest neighbours per point."""
    return _knn_dist(points, points, k).mean(axis=1).astype(np.float32)


def initial_scales(
    points: np.ndarray, cfg: InitConfig, knn_mode: str = "reference"
) -> np.ndarray:
    n = points.shape[0]
    if knn_mode == "reference" and n > cfg.knn_sample_threshold:
        # sample at regular intervals, take the median, assign to all
        # (main.mm:92-116); each sampled point's kNN is taken against the
        # FULL cloud, as the reference does
        step = max(n // cfg.knn_sample_size, 1)
        sample = _knn_dist(points, points[np.arange(0, n, step)], cfg.knn_k).mean(axis=1)
        median = float(np.sort(sample)[sample.size // 2])
        return np.full((n,), median, np.float32)
    return knn_mean_distances(points, cfg.knn_k)


def gaussians_from_points(
    points: np.ndarray,
    colors: np.ndarray,
    scene_extent: float,
    cfg: InitConfig = InitConfig(),
    knn_mode: str = "reference",
    sh_degree: int = 0,
    scale_axes: int = 3,
) -> GaussianCloud:
    n = points.shape[0]
    scales = initial_scales(points, cfg, knn_mode)
    scales = np.clip(
        scales,
        cfg.min_scale_factor * scene_extent,
        cfg.max_scale_factor * scene_extent,
    )
    log_scales = np.repeat(np.log(scales)[:, None], scale_axes, axis=1).astype(np.float32)

    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    sh = np.zeros((n, sh_coeffs(sh_degree), 3), np.float32)
    sh[:, 0, :] = (np.asarray(colors, np.float32) - 0.5) / SH_C0

    return GaussianCloud(
        means=np.asarray(points, np.float32),
        log_scales=log_scales,
        quats=quats,
        raw_opacities=np.full((n,), cfg.init_raw_opacity, np.float32),
        sh=sh,
    )
