"""Screen-space projection of all Gaussians for one camera.

Counterpart of gaussiansplatting_tpu/ops/projection.py: every cull branch is
a mask and the output is a fixed-shape struct-of-arrays with the same fields
and dtypes (int32 tile rects and counts).
"""

from __future__ import annotations

import dataclasses

import torch

from gaussiansplatting_tpu_torch.config import RasterConfig
from gaussiansplatting_tpu_torch.core import transforms as T
from gaussiansplatting_tpu_torch.core.camera import Camera
from gaussiansplatting_tpu_torch.core.gaussians import GaussianParams
from gaussiansplatting_tpu_torch.utils import tracing


@dataclasses.dataclass
class Projected:
    """Per-Gaussian screen-space quantities (SoA).  Culled Gaussians have
    valid=False and radius=0."""

    screen_pos: torch.Tensor  # [N, 2] pixel coords
    conic: torch.Tensor       # [N, 3] (A, B, C) of the inverse 2D covariance
    depth: torch.Tensor       # [N] view-space z (positive in front)
    opacity: torch.Tensor     # [N] sigmoid opacity
    color: torch.Tensor       # [N, 3] clamped color
    radius: torch.Tensor      # [N] 3-sigma pixel radius (0 = culled)
    tile_min: torch.Tensor    # [N, 2] int32 (tx, ty) inclusive
    tile_max: torch.Tensor    # [N, 2] int32 (tx, ty) inclusive
    n_tiles: torch.Tensor     # [N] int32 tiles covered (0 = culled / skipped)
    valid: torch.Tensor       # [N] bool


def num_tiles(size: int, tile: int) -> int:
    return -(-size // tile)


# frames rendered from an SH row wider than band 1 (a configured degree of
# 2 or 3), by the degree they rendered at: "sh.degree_<d>" in
# utils/tracing.py's registry.  Counted where the frame is built, so a CUDA
# graph's capture records it and each replay adds it as it adds the kernels'
# launches (train/graph.py).
tracing.counted(*(f"sh.degree_{d}" for d in range(T.MAX_SH_DEGREE + 1)))


def count_sh_frame(degree: int) -> None:
    tracing.add_launches({f"sh.degree_{degree}": 1})


def sh_color(params: GaussianParams, camera: Camera, cfg: RasterConfig) -> torch.Tensor:
    """The clamped colour [N, 3] of SH degree ``cfg.sh_degree`` (>= 1) along
    the unit direction from the camera's centre to each mean."""
    rel = params.means - camera.cam_pos[None, :]
    norm = torch.linalg.vector_norm(rel, dim=-1, keepdim=True)
    dirs = rel / torch.clamp(norm, min=1e-8)
    return T.sh_eval(params.sh, dirs, cfg.sh_degree)


def project(params: GaussianParams, camera: Camera, cfg: RasterConfig,
            color: torch.Tensor | None = None) -> Projected:
    """Project all Gaussians; everything masked, no data-dependent shapes.
    ``color``: the Gaussians' colour [N, 3] where the caller evaluated it
    (default: here, from the SH row at ``cfg.sh_degree``)."""
    width, height = camera.width, camera.height
    tiles_x = num_tiles(width, cfg.tile_size)
    tiles_y = num_tiles(height, cfg.tile_size)

    means = params.means
    finite = torch.isfinite(means).all(-1) & torch.isfinite(params.log_scales).all(-1)
    in_range = (means.abs() <= 1e6).all(-1)
    ok = params.alive & finite & in_range

    homo = torch.cat([means, torch.ones_like(means[:, :1])], dim=-1)  # [N,4]
    view_pos = homo @ camera.view.T
    clip_pos = homo @ camera.viewproj.T
    w = clip_pos[:, 3]
    vz = view_pos[:, 2]
    ok = ok & (w > cfg.z_cull) & (vz > cfg.z_cull)

    safe_w = torch.where(ok, w, 1.0)
    ndc = clip_pos[:, :3] / safe_w[:, None]
    ok = ok & (ndc[:, 0].abs() <= cfg.ndc_cull) & (ndc[:, 1].abs() <= cfg.ndc_cull)

    screen_pos = torch.stack(
        [(ndc[:, 0] * 0.5 + 0.5) * width, (ndc[:, 1] * 0.5 + 0.5) * height],
        dim=-1,
    )

    log_scale = torch.clamp(params.log_scales, -cfg.max_log_scale, cfg.max_log_scale)
    scale = T.clamp_scale_aspect(torch.exp(log_scale), cfg.aspect_clamp)
    q = T.normalize_quat(params.quats)
    cov3d = T.covariance_3d(scale, q)

    # guard z with 'ok' to keep the division finite
    safe_view = torch.cat(
        [view_pos[:, :2], torch.where(ok, vz, 1.0)[:, None]], dim=-1
    )
    cov2d = T.ewa_project(
        cov3d, safe_view, camera.view[:3, :3], camera.fx, camera.fy,
        cfg.jacobian_clamp, cfg.lowpass,
    )
    conic, _det, det_ok = T.conic_from_cov2d(cov2d, cfg.min_det)
    ok = ok & det_ok

    radius = T.radius_from_cov2d(cov2d, cfg.max_radius)
    ok = ok & (radius > 0)

    # pixel rect -> tile rect; .to(int32) truncates toward zero like astype
    i32 = torch.int32
    min_x = torch.clamp((screen_pos[:, 0] - radius).to(i32), min=0)
    min_y = torch.clamp((screen_pos[:, 1] - radius).to(i32), min=0)
    max_x = torch.clamp((screen_pos[:, 0] + radius).to(i32), max=width - 1)
    max_y = torch.clamp((screen_pos[:, 1] + radius).to(i32), max=height - 1)
    ok = ok & (min_x <= max_x) & (min_y <= max_y)

    ts = cfg.tile_size
    tmin_x = min_x // ts
    tmin_y = min_y // ts
    tmax_x = torch.clamp(max_x // ts, max=tiles_x - 1)
    tmax_y = torch.clamp(max_y // ts, max=tiles_y - 1)

    span = (tmax_x - tmin_x + 1) * (tmax_y - tmin_y + 1)
    ok = ok & (span <= cfg.max_tiles_per_gaussian)

    opacity = T.sigmoid(
        torch.clamp(params.raw_opacities, -cfg.raw_opacity_clamp, cfg.raw_opacity_clamp)
    )
    # pair-gen opacity floor: Gaussians below it produce no pairs at all
    emit = ok & (opacity >= cfg.pair_min_opacity)

    if color is None:
        color = (sh_color(params, camera, cfg) if cfg.sh_degree >= 1
                 else T.sh_dc_to_rgb(params.sh[:, 0, :]))

    zero_i = torch.zeros_like(tmin_x)
    okc = ok[:, None]
    return Projected(
        screen_pos=torch.where(okc, screen_pos, 0.0),
        conic=torch.where(okc, conic, 0.0),
        depth=torch.where(ok, vz, 0.0),
        opacity=torch.where(ok, opacity, 0.0),
        color=torch.where(okc, color, 0.0),
        radius=torch.where(ok, radius, 0.0),
        tile_min=torch.stack(
            [torch.where(ok, tmin_x, zero_i), torch.where(ok, tmin_y, zero_i)], dim=-1
        ),
        tile_max=torch.stack(
            [torch.where(ok, tmax_x, zero_i), torch.where(ok, tmax_y, zero_i)], dim=-1
        ),
        n_tiles=torch.where(emit, span, zero_i),
        valid=ok,
    )
