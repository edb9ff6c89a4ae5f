"""Projection of 2D Gaussian surfels (Huang et al. 2024, arXiv:2403.17888,
§4): each surfel's parameter fields into the row the depth presort carries.

A surfel is a disc: centre p, tangents t_u, t_v (the first two columns of
R(q)), normal t_w = t_u x t_v, and two scales s_u, s_v (log_scales [N, 2]).
Its point (u, v) is P = p + s_u t_u u + s_v t_v v = H (u, v, 1).  With W
the world-to-pixel map (rows: x w, y w and w, from the camera's viewproj
and the viewport), the 3x3 T = W H takes (u, v, 1) to (x w, y w, w); the
blend (ops/surfel_blend.py) intersects each pixel's ray with the disc
through T (the paper's eqs. 8-10).

  inputs   means [N, 3], log_scales [N, 2], quats [N, 4], raw_opacities
           [N] and alive [N] bool, the colour [N, 3] (the caller evaluates
           it, as for the 3D Gaussian), optionally vs_dummy [N, 2], the
           camera and RasterConfig's constants.
  forward  rows [N, 22] = [depth, tile_min (2), tile_max (2), n_tiles,
           T row-major (9), opacity, dead-zone colour (3), normal (3)], the
           integers as float32 (exact), culled rows zero; and depth [N],
           column 0, the stable argsort's key.  vs_dummy translates the
           frame by (vs_x, vs_y) pixels: T's rows 0 and 1 gain vs T's row 2,
           so its gradient is the screen-space positional gradient the
           density statistics accumulate.  The normal is t_w in camera
           space, turned to face the camera (negated where n . p_cam >= 0,
           as 2DGS's public rasterizer turns it).
  culls    the 3D Gaussian's (alive, finite, |mean| <= 1e6, w and view z
           above z_cull, the centre's |ndc| <= ndc_cull, the 256-tile cap,
           the pair opacity floor), and a disc that reaches the camera's
           plane: the dual conic of the disc of radius r (r^2 = -2
           power_floor, 9: every pixel a lane can keep lies inside it),
           D = T diag(r^2, r^2, -1) T^T, needs D22 < 0.
  rect     the bounding box of that disc's image, (D02 / D22, D12 / D22)
           +- sqrt((D_i2 / D22)^2 - D_ii / D22) (2DGS's compute_aabb), joined
           with the low-pass disc of radius sqrt(-power_floor) around the
           projected centre c = (T02, T12) / T22 (eq. 11's filter reaches
           that far) and cut to max_radius around c; then the pixel and
           tile rectangles as the 3D Gaussian's.  No aspect clamp.
  backward the cotangent of the rows' data columns (6-21) -> the gradients
           of the fields and the colour (the dead zone 0.01 < c < 0.99,
           torch.clamp's inclusive bounds, the quaternion norm's where),
           exactly 0 on every culled row; vs_dummy's from T's cotangent.

On a CUDA tensor ``project_fwd`` and ``project_bwd`` launch the kernels of
csrc/surfel_projection.cu (one thread a surfel) and count each launch under
``surfel_project_fwd`` / ``surfel_project_bwd`` in utils/tracing.py's
registry; on a CPU tensor they run the plain versions (``rows_plain``;
``project_bwd_plain``, autograd's vector-Jacobian product of it), which are
also the kernels' oracle.  Nothing falls back from one to the other.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gaussiansplatting_tpu_torch.config import RasterConfig
from gaussiansplatting_tpu_torch.core import transforms as T
from gaussiansplatting_tpu_torch.core.camera import Camera
from gaussiansplatting_tpu_torch.kernels import build
from gaussiansplatting_tpu_torch.ops.projection import color_with_dead_zone, num_tiles
from gaussiansplatting_tpu_torch.utils import tracing

ROW_COLS = 22     # depth, tile_min (2), tile_max (2), n_tiles, then the data
DATA_COL = 6      # the first of the sixteen render data columns
DATA = 16         # T (9), opacity, colour (3), normal (3)

tracing.counted("surfel_project_fwd", "surfel_project_bwd")


class Fields(NamedTuple):
    """The parameter fields the projection reads (GaussianParams' but sh)."""
    means: torch.Tensor
    log_scales: torch.Tensor
    quats: torch.Tensor
    raw_opacities: torch.Tensor
    alive: torch.Tensor


def pixel_rows(camera: Camera) -> torch.Tensor:
    """W [3, 4]: world (x, 1) to (x w, y w, w) in pixels, from the camera's
    viewproj and the viewport (screen = (ndc / 2 + 1/2) size)."""
    vp = camera.viewproj
    return torch.stack([0.5 * camera.width * (vp[0] + vp[3]),
                        0.5 * camera.height * (vp[1] + vp[3]), vp[3]])


def rows_plain(fields, camera: Camera, cfg: RasterConfig, color: torch.Tensor,
               vs_dummy: torch.Tensor | None = None):
    """Plain PyTorch version of the forward kernel (the CPU path and the
    oracle): (rows [N, 22], depth [N], valid [N]) as the module docstring
    states them, in the fields' dtype and differentiable like them."""
    means = fields.means
    dt = means.dtype
    width, height, ts = camera.width, camera.height, cfg.tile_size
    tiles_x, tiles_y = num_tiles(width, ts), num_tiles(height, ts)
    finite = torch.isfinite(means).all(-1) & torch.isfinite(fields.log_scales).all(-1)
    ok = fields.alive & finite & (means.abs() <= 1e6).all(-1)

    homo = torch.cat([means, torch.ones_like(means[:, :1])], dim=-1)
    view_pos = homo @ camera.view.to(dt).T
    clip = homo @ camera.viewproj.to(dt).T
    w, vz = clip[:, 3], view_pos[:, 2]
    ok = ok & (w > cfg.z_cull) & (vz > cfg.z_cull)
    safe_w = torch.where(ok, w, 1.0)
    ok = ok & ((clip[:, :2] / safe_w[:, None]).abs() <= cfg.ndc_cull).all(-1)

    scale = torch.exp(torch.clamp(fields.log_scales, -cfg.max_log_scale, cfg.max_log_scale))
    rot = T.quat_to_rotmat(T.normalize_quat(fields.quats))           # [N, 3, 3]
    wpix = pixel_rows(camera).to(dt)                                 # [3, 4]
    a = wpix[:, :3]
    tu = rot[:, :, 0] * scale[:, :1]
    tv = rot[:, :, 1] * scale[:, 1:2]
    tmat = torch.stack([tu @ a.T, tv @ a.T, means @ a.T + wpix[:, 3]], dim=-1)  # [N, i, j]
    if vs_dummy is not None:
        tmat = torch.cat([tmat[:, :2] + vs_dummy.to(dt)[:, :, None] * tmat[:, 2:3],
                          tmat[:, 2:3]], dim=1)

    # the dual conic of the disc of radius r, D = T diag(r2, r2, -1) T^T
    r2 = -2.0 * cfg.power_floor
    t2 = tmat[:, 2]

    def dual(ti, tj):
        return r2 * (ti[:, 0] * tj[:, 0] + ti[:, 1] * tj[:, 1]) - ti[:, 2] * tj[:, 2]

    d22 = dual(t2, t2)
    ok = ok & (d22 < 0.0)
    sd22 = torch.where(ok, d22, -1.0).detach()
    sw = torch.where(ok, t2[:, 2], 1.0).detach()
    lp = math.sqrt(-cfg.power_floor)
    lo, hi = [], []
    for i in range(2):
        ti = tmat[:, i].detach()
        cen = dual(ti, t2.detach()) / sd22
        ext = torch.sqrt(torch.clamp(cen * cen - dual(ti, ti) / sd22, min=1e-4))
        c = ti[:, 2] / sw
        lo.append(torch.maximum(torch.minimum(cen - ext, c - lp), c - cfg.max_radius))
        hi.append(torch.minimum(torch.maximum(cen + ext, c + lp), c + cfg.max_radius))

    i32 = torch.int32
    min_x = torch.clamp(lo[0].to(i32), min=0)
    min_y = torch.clamp(lo[1].to(i32), min=0)
    max_x = torch.clamp(hi[0].to(i32), max=width - 1)
    max_y = torch.clamp(hi[1].to(i32), max=height - 1)
    ok = ok & (min_x <= max_x) & (min_y <= max_y)
    tmin_x, tmin_y = min_x // ts, min_y // ts
    tmax_x = torch.clamp(max_x // ts, max=tiles_x - 1)
    tmax_y = torch.clamp(max_y // ts, max=tiles_y - 1)
    span = (tmax_x - tmin_x + 1) * (tmax_y - tmin_y + 1)
    ok = ok & (span <= cfg.max_tiles_per_gaussian)
    opacity = T.sigmoid(torch.clamp(fields.raw_opacities, -cfg.raw_opacity_clamp,
                                    cfg.raw_opacity_clamp))
    emit = ok & (opacity >= cfg.pair_min_opacity)

    n_cam = rot[:, :, 2] @ camera.view[:3, :3].to(dt).T
    facing = (n_cam * view_pos[:, :3]).sum(-1) < 0.0
    normal = torch.where(facing[:, None], n_cam, -n_cam)

    okc = ok[:, None]
    z = torch.zeros_like(vz)
    rows = torch.cat([
        torch.where(ok, vz, z)[:, None],
        torch.stack([torch.where(ok, x, 0) for x in (tmin_x, tmin_y, tmax_x, tmax_y)],
                    -1).to(dt),
        torch.where(emit, span, 0).to(dt)[:, None],
        torch.where(okc, tmat.reshape(-1, 9), 0.0),
        torch.where(ok, opacity, z)[:, None],
        color_with_dead_zone(torch.where(okc, color.to(dt), 0.0)),
        torch.where(okc, normal, 0.0),
    ], dim=-1)
    return rows, rows[:, 0], ok


def project_bwd_plain(g_rows, fields, color, camera: Camera, cfg: RasterConfig):
    """Plain version of the backward kernel: autograd's vector-Jacobian
    product of rows_plain's data columns (6-21) with those of ``g_rows``
    [N, 22], each gradient set to 0 on the culled rows.  Returns (d_means,
    d_log_scales, d_quats, d_raw_opacities, d_color)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in
                  (fields.means, fields.log_scales, fields.quats, fields.raw_opacities, color)]
        rows, _, valid = rows_plain(Fields(*leaves[:4], fields.alive), camera, cfg, leaves[4])
        grads = torch.autograd.grad(rows[:, DATA_COL:], leaves, g_rows[:, DATA_COL:],
                                    allow_unused=True)
    return tuple(torch.where(valid.view(-1, *(1,) * (x.dim() - 1)),
                             torch.zeros_like(x) if g is None else g, 0.0)
                 for g, x in zip(grads, leaves))


def vs_grad(g_rows: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """vs_dummy's gradient [N, 2] from the rows' cotangent: T's rows 0 and 1
    gain vs times its row 2."""
    g = g_rows[:, DATA_COL:DATA_COL + 9].reshape(-1, 3, 3)
    t2 = rows[:, DATA_COL + 6:DATA_COL + 9]
    return (g[:, :2] * t2[:, None, :]).sum(-1)


def _launch_consts(camera: Camera, cfg: RasterConfig):
    """The kernels' ints (width, height, tile size, tiles_x, tiles_y, the
    tile cap) and floats (csrc/surfel_projection.cu's Consts order)."""
    ts = cfg.tile_size
    ints = (camera.width, camera.height, ts, num_tiles(camera.width, ts),
            num_tiles(camera.height, ts), cfg.max_tiles_per_gaussian)
    floats = (cfg.z_cull, cfg.ndc_cull, cfg.max_log_scale, cfg.power_floor, cfg.max_radius,
              cfg.raw_opacity_clamp, cfg.pair_min_opacity)
    return tuple(int(x) for x in ints) + tuple(float(x) for x in floats)


def _check(fields, color, vs_dummy, camera: Camera, g_rows=None) -> int:
    """Validate the kernels' inputs (float32, contiguous, one CUDA device);
    returns N."""
    n = fields.means.shape[0]
    dev = fields.means.device
    want = {"means": (n, 3), "log_scales": (n, 2), "quats": (n, 4), "raw_opacities": (n,),
            "color": (n, 3), "vs_dummy": (n, 2), "g_rows": (n, ROW_COLS),
            "view": (4, 4), "viewproj": (4, 4)}
    given = {**fields._asdict(), "color": color, "vs_dummy": vs_dummy, "g_rows": g_rows,
             "view": camera.view, "viewproj": camera.viewproj}
    for name, shape in want.items():
        t = given[name]
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != shape
                              or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {list(shape)} float32 on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    alive = fields.alive
    if (alive.dtype != torch.bool or tuple(alive.shape) != (n,) or alive.device != dev
            or not alive.is_contiguous()):
        raise ValueError(f"alive must be contiguous [{n}] bool on {dev}")
    if fields.quats.data_ptr() % 16:
        raise ValueError("quats must be 16-byte aligned (the kernels read a row as a float4)")
    return n


def project_fwd(fields, color, vs_dummy, camera: Camera, cfg: RasterConfig):
    """(rows [N, 22], depth [N]) f32 (see the module docstring)."""
    if fields.means.device.type != "cuda":
        with torch.no_grad():
            rows, depth, _ = rows_plain(fields, camera, cfg, color, vs_dummy)
        return rows, depth
    n = _check(fields, color, vs_dummy, camera)
    rows = torch.empty((n, ROW_COLS), dtype=torch.float32, device=fields.means.device)
    depth = torch.empty((n,), dtype=torch.float32, device=fields.means.device)
    build.launch("surfel_projection", "gs_surfel_project_fwd", "p" * 9 + "i" * 7 + "f" * 7 + "pp",
                 rows.device, *fields[:4], fields.alive, color, vs_dummy, camera.view,
                 camera.viewproj, n, *_launch_consts(camera, cfg), rows, depth,
                 count="surfel_project_fwd")
    return rows, depth


def project_bwd(g_rows, fields, color, camera: Camera, cfg: RasterConfig):
    """(d_means, d_log_scales, d_quats, d_raw_opacities, d_color) f32 from
    the rows' cotangent ``g_rows`` [N, 22] (columns 6-21 read)."""
    if fields.means.device.type != "cuda":
        return project_bwd_plain(g_rows, fields, color, camera, cfg)
    g_rows = g_rows.contiguous()
    n = _check(fields, color, None, camera, g_rows)
    grads = tuple(torch.empty_like(t) for t in (*fields[:4], color))
    build.launch("surfel_projection", "gs_surfel_project_bwd", "p" * 9 + "i" * 7 + "f" * 7 + "p" * 5,
                 g_rows.device, g_rows, *fields[:4], fields.alive, color, camera.view,
                 camera.viewproj, n, *_launch_consts(camera, cfg), *grads,
                 count="surfel_project_bwd")
    return grads


class _Project(torch.autograd.Function):
    """The presort's surfel rows as one differentiable unit: ``project_fwd``,
    and on the rows' cotangent ``project_bwd``.  Differentiable in the four
    float fields, the colour and vs_dummy; the depth key is not."""

    @staticmethod
    def forward(ctx, means, log_scales, quats, raw_opacities, color, vs_dummy, alive,
                camera, cfg):
        fields = Fields(means, log_scales, quats, raw_opacities, alive)
        rows, depth = project_fwd(fields, color, vs_dummy, camera, cfg)
        ctx.camera, ctx.cfg, ctx.has_vs = camera, cfg, vs_dummy is not None
        ctx.save_for_backward(means, log_scales, quats, raw_opacities, color, alive, rows)
        ctx.mark_non_differentiable(depth)
        return rows, depth

    @staticmethod
    def backward(ctx, g_rows, _g_depth):
        means, log_scales, quats, raw_opacities, color, alive, rows = ctx.saved_tensors
        grads = project_bwd(g_rows, Fields(means, log_scales, quats, raw_opacities, alive),
                            color, ctx.camera, ctx.cfg)
        d_vs = vs_grad(g_rows, rows) if ctx.has_vs else None
        return (*grads, d_vs, None, None, None)


def project_rows(params, camera: Camera, cfg: RasterConfig, color: torch.Tensor,
                 vs_dummy: torch.Tensor | None = None):
    """The presort's rows [N, 22] and the depth key [N] of the surfels
    ``params`` with the colour ``color`` [N, 3] and the optional vs_dummy
    [N, 2], differentiable in the fields, the colour and vs_dummy."""
    return _Project.apply(params.means, params.log_scales, params.quats,
                          params.raw_opacities, color, vs_dummy, params.alive, camera, cfg)
