"""Plain PyTorch reference of a 2D Gaussian Splatting frame, loss and
gradient (Huang et al. 2024, arXiv:2403.17888) for the port's tests.

It follows the paper's equations, every pixel against every surfel in
depth order (small frames only), in float64:

- the surfel: centre p, tangents t_u, t_v (R(q)'s first two columns), two
  scales; P(u, v) = p + s_u t_u u + s_v t_v v = H (u, v, 1);
- the ray-splat intersection (eqs. 8-10): T = W H with W world to (x w,
  y w, w) in pixels; for the pixel centre (x, y), h_u = x T_2 - T_0, h_v =
  y T_2 - T_1, (u, v) from h_u x h_v; the intersection's depth z = T_2 .
  (u, v, 1), the camera-space z of P(u, v);
- the object-space low-pass (eq. 11): G^ = max(G(u, v), G((x - c) /
  sigma)), sigma = sqrt(2)/2 px, c the projected centre; where the
  low-pass wins the depth is the centre's (2DGS's rasterizer);
- the blend (eq. 12): alpha = min(op G^, 0.99), front to back in the
  centres' depth order, with the expected depth sum w z / sum w, the
  camera-space normal sum w n (t_w turned to face the camera), alpha
  sum w and the depth distortion in the squared form of 2DGS's public
  rasterizer, sum_i w_i (m_i^2 A_i + M2_i - 2 m_i M1_i) with m = f/(f - n)
  (1 - n/z), n = 0.2, f = 100 and A, M1, M2 the running sums of w, w m,
  w m^2 in front of lane i (eq. 13's pairwise form, squared), accumulated
  lane by lane as the public rasterizer does;
- the normal consistency (eq. 14 as 2DGS's training script takes it): per
  pixel 1 - n . N, N the normal of the expected depth by central
  differences of the back-projected points (0 on the border) times alpha,
  with no gradient through alpha;
- the loss (eq. 15): the photometric loss of reference_sh plus
  lambda_dist sum(distortion) + lambda_normal sum(normal error), summed
  over pixels as the port's photometric gradient is.

Departures, each the port's semantics: the port's culls and window (the
centre's z and ndc culls, a disc that reaches the camera plane culled, the
256-tile cap over the disc's bounding box, the pair opacity floor 0.005,
the power window [-4.5, 0], alpha at least 1/255 and capped at 0.99 with
the cap passing the gradient through), the colour clamped to [0, 1] with
the dead zone (0.01, 0.99) in its gradient, a white background.  Where
h_u x h_v has no third component the intersection is taken as missing
(the low-pass alone).  TF32 is off.  Imports nothing of the port and no
JAX.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

import reference_sh as rsh

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FIELDS = rsh.FIELDS
NEAR, FAR = 0.2, 100.0
RC = dict(z_cull=0.1, ndc_cull=1.2, max_log_scale=5.0, power_floor=-4.5, alpha_cap=0.99,
          alpha_floor=1.0 / 255.0, raw_opacity_clamp=8.0, pair_min_opacity=0.005,
          max_tiles=256, max_radius=512.0, tile_size=16)


class Surfels(NamedTuple):
    tmat: torch.Tensor     # [N, 3, 3] T = W H
    normal: torch.Tensor   # [N, 3] camera space, facing the camera
    opacity: torch.Tensor  # [N]
    color: torch.Tensor    # [N, 3], the dead zone in its gradient
    depth: torch.Tensor    # [N] the centre's view z
    emit: torch.Tensor     # [N] bool


def straight_cap(a: torch.Tensor, cap: float) -> torch.Tensor:
    """min(a, cap) whose gradient is a's (the cap passes it through)."""
    return a + (torch.clamp(a, max=cap) - a).detach()


def project(p: dict, pose: dict, degree: int, vs=None) -> Surfels:
    """The surfels of ``p`` (log_scales [N, 2]) under ``pose``,
    differentiable in the fields (and ``vs`` [N, 2], a screen-space shift
    of each surfel)."""
    dt = p["means"].dtype
    view, viewproj, eye = rsh.camera(pose, dt)
    w_px, h_px = pose["width"], pose["height"]
    wpix = torch.stack([0.5 * w_px * (viewproj[0] + viewproj[3]),
                        0.5 * h_px * (viewproj[1] + viewproj[3]), viewproj[3]])
    means = p["means"]
    homo = torch.cat([means, torch.ones_like(means[:, :1])], -1)
    vpos, clip = homo @ view.T, homo @ viewproj.T
    ok = p["alive"] & (clip[:, 3] > RC["z_cull"]) & (vpos[:, 2] > RC["z_cull"])
    ndc = clip[:, :2] / torch.where(ok, clip[:, 3], torch.ones_like(clip[:, 3]))[:, None]
    ok = ok & (ndc.abs() <= RC["ndc_cull"]).all(-1)
    s = torch.exp(p["log_scales"].clamp(-RC["max_log_scale"], RC["max_log_scale"]))
    q = p["quats"]
    qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    ident = torch.zeros_like(q)
    ident[:, 0] = 1.0
    rot = rsh.quat_to_rotmat(torch.where(qn > 1e-3, q / qn.clamp(min=1e-3), ident))
    # H's columns: s_u t_u, s_v t_v (direction), p (point)
    h = torch.zeros((means.shape[0], 4, 3), dtype=dt)
    h[:, :3, 0] = rot[:, :, 0] * s[:, :1]
    h[:, :3, 1] = rot[:, :, 1] * s[:, 1:]
    h[:, :3, 2] = means
    h[:, 3, 2] = 1.0
    tmat = wpix @ h                                                   # [N, 3, 3]
    if vs is not None:
        tmat = torch.cat([tmat[:, :2] + vs[:, :, None] * tmat[:, 2:], tmat[:, 2:]], 1)
    # the disc of radius 3 (u^2 + v^2 <= -2 power_floor) must lie in front of
    # the camera plane: its dual conic's D22 < 0; its image's bounding box
    r2 = -2.0 * RC["power_floor"]
    t2 = tmat[:, 2].detach()

    def dual(a, b):
        return r2 * (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) - a[:, 2] * b[:, 2]

    d22 = dual(t2, t2)
    ok = ok & (d22 < 0)
    d22s = torch.where(ok, d22, -torch.ones_like(d22))
    lo, hi = [], []
    for i in range(2):
        ti = tmat[:, i].detach()
        cen = dual(ti, t2) / d22s
        ext = torch.sqrt(torch.clamp(cen * cen - dual(ti, ti) / d22s, min=1e-4))
        c = ti[:, 2] / torch.where(ok, t2[:, 2], torch.ones_like(d22))
        lp = math.sqrt(-RC["power_floor"])
        lo.append(torch.maximum(torch.minimum(cen - ext, c - lp), c - RC["max_radius"]))
        hi.append(torch.minimum(torch.maximum(cen + ext, c + lp), c + RC["max_radius"]))
    ts = RC["tile_size"]
    mn = [torch.trunc(lo[0]).clamp(min=0), torch.trunc(lo[1]).clamp(min=0)]
    mx = [torch.trunc(hi[0]).clamp(max=w_px - 1), torch.trunc(hi[1]).clamp(max=h_px - 1)]
    ok = ok & (mn[0] <= mx[0]) & (mn[1] <= mx[1])
    tiles = [(-(-w_px // ts)), (-(-h_px // ts))]
    span = [(torch.clamp(torch.div(mx[i], ts, rounding_mode="floor"), max=tiles[i] - 1)
             - torch.div(mn[i], ts, rounding_mode="floor") + 1) for i in range(2)]
    ok = ok & (span[0] * span[1] <= RC["max_tiles"])
    raw = p["raw_opacities"].clamp(-RC["raw_opacity_clamp"], RC["raw_opacity_clamp"])
    opacity = 1.0 / (1.0 + torch.exp(-raw))
    emit = ok & (opacity >= RC["pair_min_opacity"])
    n_cam = rot[:, :, 2] @ view[:3, :3].T
    flip = (n_cam * vpos[:, :3]).sum(-1) >= 0
    normal = torch.where(flip[:, None], -n_cam, n_cam)
    rel = means - eye
    dirs = rel / torch.linalg.vector_norm(rel, dim=-1, keepdim=True).clamp(min=1e-8)
    col = rsh.sh_color(p["sh"], dirs, degree)
    live = (col > 0.01) & (col < 0.99)
    color = torch.where(live, col, col.detach())
    return Surfels(tmat, normal, opacity, color, vpos[:, 2].detach(), emit)


class Frame(NamedTuple):
    image: torch.Tensor    # [H, W, 3]
    alpha: torch.Tensor    # [H, W]
    depth: torch.Tensor    # [H, W] expected depth
    normal: torch.Tensor   # [H, W, 3]
    dist: torch.Tensor     # [H, W]


def render(p: dict, pose: dict, degree: int = 0, vs=None, lowpass: bool = True) -> Frame:
    """The frame, every pixel against every emitting surfel in the centres'
    (stable) depth order, differentiable in the fields.  ``lowpass`` False
    leaves eq. 11's filter out (a planted fault: 3DGS's behaviour for a
    surfel seen edge-on)."""
    sf = project(p, pose, degree, vs)
    g = torch.nonzero(sf.emit).squeeze(1)
    g = g[torch.sort(sf.depth[g], stable=True).indices]
    tm = sf.tmat[g]
    w_px, h_px = pose["width"], pose["height"]
    dt = tm.dtype
    ys, xs = torch.meshgrid(torch.arange(h_px, dtype=dt) + 0.5,
                            torch.arange(w_px, dtype=dt) + 0.5, indexing="ij")
    x, y = xs.reshape(-1, 1), ys.reshape(-1, 1)                       # [P, 1]
    t0, t1, t2 = tm[:, 0], tm[:, 1], tm[:, 2]                          # [L, 3]
    hu = x[..., None] * t2[None] - t0[None]                            # [P, L, 3]
    hv = y[..., None] * t2[None] - t1[None]
    c = torch.linalg.cross(hu, hv, dim=-1)
    miss = c[..., 2] == 0
    c2 = torch.where(miss, torch.ones_like(c[..., 2]), c[..., 2])
    u, v = c[..., 0] / c2, c[..., 1] / c2
    rho3 = torch.where(miss, torch.full_like(u, math.inf), u * u + v * v)
    cx, cy = t0[:, 2] / t2[:, 2], t1[:, 2] / t2[:, 2]
    rho2 = 2.0 * ((x - cx) ** 2 + (y - cy) ** 2)
    hit = rho3 <= rho2 if lowpass else ~miss
    rho = torch.where(hit, rho3, rho2) if lowpass else rho3
    power = -0.5 * rho
    a_raw = sf.opacity[g] * torch.exp(power)
    keep = (power >= RC["power_floor"]) & (a_raw >= RC["alpha_floor"])
    alpha = torch.where(keep, straight_cap(a_raw, RC["alpha_cap"]), torch.zeros_like(a_raw))
    z = torch.where(keep & hit, t2[:, 0] * u + t2[:, 1] * v + t2[:, 2], t2[:, 2].expand_as(u))
    z = torch.where(keep, z, torch.ones_like(z))
    m = FAR / (FAR - NEAR) * (1.0 - NEAR / z)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha], 1), 1)
    w = alpha * trans[:, :-1]                                           # [P, L]
    acc_a = torch.cumsum(w, 1) - w                                      # in front of lane i
    acc_m1 = torch.cumsum(w * m, 1) - w * m
    acc_m2 = torch.cumsum(w * m * m, 1) - w * m * m
    dist = (w * (m * m * acc_a + acc_m2 - 2.0 * m * acc_m1)).sum(1)
    a = w.sum(1)
    img = w @ sf.color[g] + trans[:, -1:]                               # white background
    depth = torch.where(a > 0, (w * z).sum(1) / torch.where(a > 0, a, torch.ones_like(a)),
                        torch.zeros_like(a))
    normal = w @ sf.normal[g]
    shape = (h_px, w_px)
    return Frame(img.reshape(*shape, 3), a.reshape(shape), depth.reshape(shape),
                 normal.reshape(*shape, 3), dist.reshape(shape))


def depth_normal(depth: torch.Tensor, pose: dict) -> torch.Tensor:
    """The normal of a depth map [H, W] by central differences of the
    back-projected pixel centres, 0 on the border (2DGS's depth_to_normal)."""
    h, w = depth.shape
    dt = depth.dtype
    x = (torch.arange(w, dtype=dt) + 0.5 - pose["cx"]) / pose["fx"]
    y = (torch.arange(h, dtype=dt) + 0.5 - pose["cy"]) / pose["fy"]
    pts = torch.stack([x[None, :] * depth, y[:, None] * depth, depth], -1)
    n = torch.linalg.cross(pts[2:, 1:-1] - pts[:-2, 1:-1], pts[1:-1, 2:] - pts[1:-1, :-2], dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp(min=1e-12)
    out = torch.zeros((h, w, 3), dtype=dt)
    out[1:-1, 1:-1] = n
    return out


class Loss(NamedTuple):
    grad_loss: torch.Tensor
    combined_mean: torch.Tensor
    dist_mean: torch.Tensor
    normal_mean: torch.Tensor


def loss(fr: Frame, gt: torch.Tensor, pose: dict, lambda_dist: float,
         lambda_normal: float) -> Loss:
    """The photometric loss and both regularizers (see the module
    docstring)."""
    photo = rsh.photometric_loss(fr.image, gt.to(fr.image.dtype))
    surf = depth_normal(fr.depth, pose) * fr.alpha.detach()[..., None]
    err = 1.0 - (fr.normal * surf).sum(-1)
    return Loss(photo.grad_loss + lambda_dist * fr.dist.sum() + lambda_normal * err.sum(),
                photo.combined_mean + lambda_dist * fr.dist.mean()
                + lambda_normal * err.mean(), fr.dist.mean(), err.mean())


def render_grad(p: dict, pose: dict, gt: torch.Tensor, degree: int, lambda_dist: float,
                lambda_normal: float, lowpass: bool = True):
    """(Frame, Loss, gradients {field: tensor}, vs gradient [N, 2]) in float64."""
    leaves = {f: p[f].detach().to(torch.float64).requires_grad_(True) for f in FIELDS}
    vs = torch.zeros((p["means"].shape[0], 2), dtype=torch.float64, requires_grad=True)
    fr = render(dict(leaves, alive=p["alive"]), pose, degree, vs, lowpass)
    ls = loss(fr, gt, pose, lambda_dist, lambda_normal)
    grads = torch.autograd.grad(ls.grad_loss, [leaves[f] for f in FIELDS] + [vs],
                                allow_unused=True)
    out = {f: torch.zeros_like(leaves[f]) if gr is None else gr
           for f, gr in zip(FIELDS, grads[:-1])}
    return fr, ls, out, grads[-1]


def step(st: rsh.State, pose: dict, gt: torch.Tensor, degree: int, total_iters: int,
         lambda_dist: float, lambda_normal: float, oc: dict | None = None):
    """One training step on one view: (state, logged loss, gradients)."""
    _, ls, grads, _ = render_grad(st.params, pose, gt, degree, lambda_dist, lambda_normal)
    return rsh.adam(st, grads, oc or rsh.OPTIM, total_iters), float(ls.combined_mean), grads
