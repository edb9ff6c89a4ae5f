"""Screen-space projection of all Gaussians for one camera.

Counterpart of gaussiansplatting_tpu/ops/projection.py: every cull branch is
a mask and the output is a fixed-shape struct-of-arrays with the same fields
and dtypes (int32 tile rects and counts).  ``project`` is that function, per
field; the JAX package leaves it to XLA, so no Pallas kernel stands behind it.

The render's path (ops/rasterize._plan) takes the presort's row instead,
through the autograd Function ``_Project`` (``project_rows``):

  inputs   the fields means [N, 3], log_scales [N, 3], quats [N, 4],
           raw_opacities [N] and alive [N] bool of GaussianParams, the
           colour [N, 3] (the caller evaluates it: the SH DC row, sh_color,
           or the ``sh`` stage's), optionally vs_dummy [N, 2], the camera
           and RasterConfig's constants.
  forward  rows [N, 15] = [depth, tile_min (2), tile_max (2), n_tiles,
           screen_pos + vs_dummy (2), conic (3), opacity, dead-zone colour
           (3)], the integers as float32 (exact), culled rows zero but for
           vs_dummy; and depth [N], the rows' column 0, as the stable
           argsort's key.  ``rows_plain``: ``project``, the colour's dead
           zone and one cat, as the render built them before the kernels.
  backward the cotangent of the rows' data columns (6-14) -> the gradients
           of the fields and the colour: autograd's through rows_plain
           (torch.clamp's inclusive bounds, the Jacobian clamp's tensor
           bounds carrying gradient into z where they bind, amax and amin
           sharing theirs equally among ties, the quaternion norm's where,
           the dead zone 0.01 < c < 0.99), exactly 0 on every culled row;
           vs_dummy's is the screen columns' cotangent as it is.

On a CUDA tensor ``project_fwd`` and ``project_bwd`` launch the kernels of
csrc/projection.cu (one thread a Gaussian) and count each launch under
their names in utils/tracing.py's registry; on a CPU tensor they run the
plain versions (``rows_plain``; ``project_bwd_plain``, autograd's
vector-Jacobian product of it), which are also the kernels' oracle.
Nothing falls back from one to the other.  Every launch goes to
``torch.cuda.current_stream``, so a captured step or render records it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gaussiansplatting_tpu_torch.config import RasterConfig
from gaussiansplatting_tpu_torch.core import transforms as T
from gaussiansplatting_tpu_torch.core.camera import Camera
from gaussiansplatting_tpu_torch.core.gaussians import GaussianParams
from gaussiansplatting_tpu_torch.kernels import build
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


def default_color(params: GaussianParams, camera: Camera, cfg: RasterConfig) -> torch.Tensor:
    """The colour [N, 3] a frame takes when the caller gives none: sh_color
    at ``cfg.sh_degree`` >= 1, the SH DC row's otherwise."""
    if cfg.sh_degree >= 1:
        return sh_color(params, camera, cfg)
    return T.sh_dc_to_rgb(params.sh[:, 0, :])


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
        color = default_color(params, camera, cfg)

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


# -- the presort's rows: the render's path


ROW_COLS = 15     # depth, tile_min (2), tile_max (2), n_tiles, then the data
DATA_COL = 6      # the first of the nine render data columns

tracing.counted("project_fwd", "project_bwd")


class Fields(NamedTuple):
    """The parameter fields projection reads (GaussianParams' but sh)."""
    means: torch.Tensor
    log_scales: torch.Tensor
    quats: torch.Tensor
    raw_opacities: torch.Tensor
    alive: torch.Tensor


def color_with_dead_zone(raw_color: torch.Tensor) -> torch.Tensor:
    """clamp(raw, 0, 1) whose gradient is zeroed outside (0.01, 0.99) — the
    reference zeroes dL/dColor at those margins to stop pushing saturated
    colours further (tiled_shaders.metal:505-507)."""
    c = torch.clamp(raw_color, 0.0, 1.0)
    live = (c > 0.01) & (c < 0.99)
    return torch.where(live, c, c.detach())


def rows_plain(fields, camera: Camera, cfg: RasterConfig, color: torch.Tensor,
               vs_dummy: torch.Tensor | None = None):
    """Plain PyTorch version of the forward kernel (the CPU path and the
    oracle): (rows [N, 15], depth [N], valid [N]) of ``project``, the dead
    zone and one cat (see the module docstring), in the fields' dtype and
    differentiable like them.  ``fields``: GaussianParams or Fields."""
    proj = project(fields, camera, cfg, color)
    screen_pos = proj.screen_pos if vs_dummy is None else proj.screen_pos + vs_dummy
    dt = proj.depth.dtype
    rows = torch.cat([proj.depth[:, None], proj.tile_min.to(dt), proj.tile_max.to(dt),
                      proj.n_tiles.to(dt)[:, None], screen_pos, proj.conic,
                      proj.opacity[:, None], color_with_dead_zone(proj.color)], dim=-1)
    return rows, proj.depth, proj.valid


def project_bwd_plain(g_rows, fields, color, camera: Camera, cfg: RasterConfig):
    """Plain version of the backward kernel: autograd's vector-Jacobian
    product of rows_plain's data columns (6-14) with those of ``g_rows``
    [N, 15], in the fields' dtype, each gradient set to 0 on the culled
    rows (where a non-finite field leaves autograd's NaN).  Returns
    (d_means, d_log_scales, d_quats, d_raw_opacities, d_color)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in
                  (fields.means, fields.log_scales, fields.quats, fields.raw_opacities, color)]
        rows, _, valid = rows_plain(Fields(*leaves[:4], fields.alive), camera, cfg, leaves[4])
        grads = torch.autograd.grad(rows[:, DATA_COL:], leaves, g_rows[:, DATA_COL:])
    return tuple(torch.where(valid.view(-1, *(1,) * (g.dim() - 1)), g, 0.0) for g in grads)


def _launch_consts(camera: Camera, cfg: RasterConfig):
    """The kernels' ints (width, height, tile size, tiles_x, tiles_y, the
    tile cap) and floats (RasterConfig's constants, in csrc/projection.cu's
    Consts order)."""
    ts = cfg.tile_size
    ints = (camera.width, camera.height, ts, num_tiles(camera.width, ts),
            num_tiles(camera.height, ts), cfg.max_tiles_per_gaussian)
    floats = (cfg.z_cull, cfg.ndc_cull, cfg.max_log_scale, cfg.aspect_clamp,
              cfg.jacobian_clamp, cfg.lowpass, cfg.min_det, cfg.max_radius,
              cfg.raw_opacity_clamp, cfg.pair_min_opacity)
    return tuple(int(x) for x in ints) + tuple(float(x) for x in floats)


def _check(fields, color, vs_dummy, camera: Camera, g_rows=None) -> int:
    """Validate the kernels' inputs (float32, contiguous, one CUDA device,
    the shapes of the module docstring); returns N."""
    n = fields.means.shape[0]
    dev = fields.means.device
    want = {"means": (n, 3), "log_scales": (n, 3), "quats": (n, 4), "raw_opacities": (n,),
            "color": (n, 3), "vs_dummy": (n, 2), "g_rows": (n, ROW_COLS),
            "view": (4, 4), "viewproj": (4, 4), "fx": (), "fy": ()}
    given = {**fields._asdict(), "color": color, "vs_dummy": vs_dummy, "g_rows": g_rows,
             "view": camera.view, "viewproj": camera.viewproj, "fx": camera.fx,
             "fy": camera.fy}
    for name, shape in want.items():
        t = given[name]
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != shape
                              or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {list(shape)} float32 on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    alive = fields.alive
    if (alive.dtype != torch.bool or tuple(alive.shape) != (n,) or alive.device != dev
            or not alive.is_contiguous()):
        raise ValueError(f"alive must be contiguous [{n}] bool on {dev}, got "
                         f"{tuple(alive.shape)} {alive.dtype} on {alive.device}")
    if fields.quats.data_ptr() % 16:
        raise ValueError("quats must be 16-byte aligned (the kernels read a row as a float4)")
    return n


def project_fwd(fields, color, vs_dummy, camera: Camera, cfg: RasterConfig):
    """(rows [N, 15], depth [N]) f32 (see the module docstring)."""
    if fields.means.device.type != "cuda":
        with torch.no_grad():
            rows, depth, _ = rows_plain(fields, camera, cfg, color, vs_dummy)
        return rows, depth
    n = _check(fields, color, vs_dummy, camera)
    rows = torch.empty((n, ROW_COLS), dtype=torch.float32, device=fields.means.device)
    depth = torch.empty((n,), dtype=torch.float32, device=fields.means.device)
    build.launch("projection", "gs_project_fwd", "p" * 11 + "i" * 7 + "f" * 10 + "pp",
                 rows.device, *fields[:4], fields.alive, color, vs_dummy, camera.view,
                 camera.viewproj, camera.fx, camera.fy, n, *_launch_consts(camera, cfg), rows,
                 depth, count="project_fwd")
    return rows, depth


def project_bwd(g_rows, fields, color, camera: Camera, cfg: RasterConfig):
    """(d_means, d_log_scales, d_quats, d_raw_opacities, d_color) f32 from
    the rows' cotangent ``g_rows`` [N, 15] (columns 6-14 read)."""
    if fields.means.device.type != "cuda":
        return project_bwd_plain(g_rows, fields, color, camera, cfg)
    g_rows = g_rows.contiguous()
    n = _check(fields, color, None, camera, g_rows)
    grads = tuple(torch.empty_like(t) for t in (*fields[:4], color))
    build.launch("projection", "gs_project_bwd", "p" * 11 + "i" * 7 + "f" * 10 + "p" * 5,
                 g_rows.device, g_rows, *fields[:4], fields.alive, color, camera.view,
                 camera.viewproj, camera.fx, camera.fy, n, *_launch_consts(camera, cfg), *grads,
                 count="project_bwd")
    return grads


class _Project(torch.autograd.Function):
    """The presort's rows as one differentiable unit: ``project_fwd``, and
    on the rows' cotangent ``project_bwd`` (the kernels on CUDA tensors,
    the plain versions on CPU tensors).  Differentiable in the four float
    fields, the colour and vs_dummy; the depth key is not."""

    @staticmethod
    def forward(ctx, means, log_scales, quats, raw_opacities, color, vs_dummy, alive,
                camera, cfg):
        fields = Fields(means, log_scales, quats, raw_opacities, alive)
        rows, depth = project_fwd(fields, color, vs_dummy, camera, cfg)
        ctx.camera, ctx.cfg, ctx.has_vs = camera, cfg, vs_dummy is not None
        ctx.save_for_backward(means, log_scales, quats, raw_opacities, color, alive)
        ctx.mark_non_differentiable(depth)
        return rows, depth

    @staticmethod
    def backward(ctx, g_rows, _g_depth):
        means, log_scales, quats, raw_opacities, color, alive = ctx.saved_tensors
        grads = project_bwd(g_rows, Fields(means, log_scales, quats, raw_opacities, alive),
                            color, ctx.camera, ctx.cfg)
        d_vs = g_rows[:, DATA_COL:DATA_COL + 2] if ctx.has_vs else None
        return (*grads, d_vs, None, None, None)


def project_rows(params: GaussianParams, camera: Camera, cfg: RasterConfig,
                 color: torch.Tensor, vs_dummy: torch.Tensor | None = None):
    """The presort's rows [N, 15] and the depth key [N] of ``params`` with
    the colour ``color`` [N, 3] and the optional vs_dummy [N, 2] (see the
    module docstring), differentiable in the fields, the colour and
    vs_dummy."""
    return _Project.apply(params.means, params.log_scales, params.quats,
                          params.raw_opacities, color, vs_dummy, params.alive, camera, cfg)
