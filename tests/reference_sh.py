"""Plain PyTorch reference of the published 3DGS colour (Kerbl et al. 2023,
arXiv:2308.04079): spherical harmonics of degree 0 to 3, and a frame, its
loss, its gradient and an Adam step that use it, for the port's tests.

The colour follows the authors' ``utils/sh_utils.py`` ``eval_sh`` and the
CUDA rasterizer's ``computeColorFromSH``: evaluated along the unit direction
from the camera's centre to the mean, 0.5 added, the real SH constants and
basis below.  Where the port departs from 3DGS, this follows the port:

- the colour is clamped to [0, 1] (3DGS clamps at 0 only), and its gradient
  is zeroed outside (0.01, 0.99) (the port's dead zone, from the Metal
  reference it ports);
- Adam clamps the coefficients to +/-2 (``sh_clamp``), with the port's other
  clips: gradients to +/-0.5, the position update's norm to 0.1, log-scales
  to +/-4, raw opacity to +/-8, rotations renormalised, a Gaussian with a
  non-finite gradient left as it is;
- the frame has the port's culls and blend: the 3-sigma tile rectangle, the
  256-tile cap, the pair opacity floor 0.005, the power window [-4.5, 0],
  alpha in [1/255, 0.99], no early termination, a white background.

The bands above the DC train at ``sh_rest_lr`` (3DGS: ``feature_lr / 20``).
Everything computes in float64 by default and blends every pixel against
every Gaussian in depth order (small frames only).  TF32 is off.  Imports
nothing of the port and no JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)
FIELDS = ("means", "log_scales", "quats", "raw_opacities", "sh")


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """[N, (degree + 1)^2] the real SH basis of 3DGS at unit ``dirs`` [N, 3]."""
    x, y, z = dirs.unbind(-1)
    out = [torch.full_like(x, C0)]
    if degree >= 1:
        out += [-C1 * y, C1 * z, -C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        out += [C2[0] * x * y, C2[1] * y * z, C2[2] * (2 * zz - xx - yy), C2[3] * x * z,
                C2[4] * (xx - yy)]
    if degree >= 3:
        out += [C3[0] * y * (3 * xx - yy), C3[1] * x * y * z, C3[2] * y * (4 * zz - xx - yy),
                C3[3] * z * (2 * zz - 3 * xx - 3 * yy), C3[4] * x * (4 * zz - xx - yy),
                C3[5] * z * (xx - yy), C3[6] * x * (xx - 3 * yy)]
    return torch.stack(out, -1)


def sh_color(sh: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """clamp(sum_k basis_k sh[:, k] + 0.5, 0, 1): [N, 3] from sh [N, K, 3]."""
    k = (degree + 1) ** 2
    return torch.clamp(torch.einsum("nk,nkc->nc", sh_basis(dirs, degree), sh[:, :k]) + 0.5,
                       0.0, 1.0)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def camera(pose: dict, dtype=torch.float64):
    """(view [4, 4], viewproj [4, 4], eye [3]) of a pose {quat, t, fx, fy,
    cx, cy, width, height}: x_cam = R x + t, near 0.1, far 1000."""
    view = torch.eye(4, dtype=dtype)
    view[:3, :3] = quat_to_rotmat(torch.tensor(pose["quat"], dtype=dtype))
    view[:3, 3] = torch.tensor(pose["t"], dtype=dtype)
    w, h, near, far = pose["width"], pose["height"], 0.1, 1000.0
    proj = torch.zeros((4, 4), dtype=dtype)
    proj[0, 0], proj[1, 1] = 2.0 * pose["fx"] / w, 2.0 * pose["fy"] / h
    proj[0, 2], proj[1, 2] = 2.0 * pose["cx"] / w - 1.0, 2.0 * pose["cy"] / h - 1.0
    proj[2, 2], proj[2, 3], proj[3, 2] = far / (far - near), -(far * near) / (far - near), 1.0
    return view, proj @ view, -view[:3, :3].T @ view[:3, 3]


class Projected(NamedTuple):
    screen: torch.Tensor   # [N, 2]
    conic: torch.Tensor    # [N, 3]
    opacity: torch.Tensor  # [N]
    color: torch.Tensor    # [N, 3], the dead zone in its gradient
    depth: torch.Tensor    # [N]
    emit: torch.Tensor     # [N] bool
    tmin: torch.Tensor     # [N, 2] int64 tile rectangle
    tmax: torch.Tensor


def project(p: dict, pose: dict, degree: int) -> Projected:
    """The port's projection of ``p`` (means, log_scales, quats,
    raw_opacities, sh [N, K, 3], alive) with the colour of SH ``degree``."""
    means, log_scales = p["means"], p["log_scales"]
    dt = means.dtype
    width, height, ts = pose["width"], pose["height"], 16
    tiles_x, tiles_y = -(-width // ts), -(-height // ts)
    view, viewproj, eye = camera(pose, dt)
    fx, fy = float(pose["fx"]), float(pose["fy"])
    ok = p["alive"] & torch.isfinite(means).all(-1) & (means.abs() <= 1e6).all(-1)
    homo = torch.cat([means, torch.ones_like(means[:, :1])], -1)
    vpos, clip = homo @ view.T, homo @ viewproj.T
    w, z = clip[:, 3], vpos[:, 2]
    ok = ok & (w > 0.1) & (z > 0.1)
    w = torch.where(ok, w, torch.ones_like(w))
    z = torch.where(ok, z, torch.ones_like(z))
    ndc = clip[:, :2] / w[:, None]
    ok = ok & (ndc.abs() <= 1.2).all(-1)
    screen = torch.stack([(ndc[:, 0] * 0.5 + 0.5) * width, (ndc[:, 1] * 0.5 + 0.5) * height], -1)

    scale = torch.exp(log_scales.clamp(-5.0, 5.0))
    smax, smin = scale.amax(-1, keepdim=True), scale.amin(-1, keepdim=True)
    scale = scale * torch.where(smax > 20.0 * smin, 20.0 * smin / smax, torch.ones_like(smax))
    q = p["quats"]
    qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    ident = torch.zeros_like(q)
    ident[:, 0] = 1.0
    q = torch.where(qn > 1e-3, q / qn.clamp(min=1e-3), ident)
    m = quat_to_rotmat(q) * scale[:, None, :]
    sigma = m @ m.transpose(-1, -2)
    limx, limy = 1.3 * fx / z, 1.3 * fy / z
    txtz = torch.maximum(torch.minimum(vpos[:, 0] / z, limx), -limx)
    tytz = torch.maximum(torch.minimum(vpos[:, 1] / z, limy), -limy)
    zero = torch.zeros_like(z)
    jac = torch.stack([torch.stack([fx / z, zero, -fx * txtz / z], -1),
                       torch.stack([zero, fy / z, -fy * tytz / z], -1)], -2)
    t2 = jac @ view[:3, :3]
    cov = t2 @ sigma @ t2.transpose(-1, -2)
    a, b, c = cov[:, 0, 0] + 0.3, cov[:, 0, 1], cov[:, 1, 1] + 0.3
    det = a * c - b * b
    ok = ok & (det >= 1e-4)
    det = torch.where(ok, det, torch.ones_like(det))
    conic = torch.stack([c / det, -b / det, a / det], -1)
    mid = 0.5 * (a + c)
    radius = torch.clamp(torch.ceil(3.0 * torch.sqrt(mid + torch.sqrt(
        torch.clamp(mid * mid - det, min=0.1)))), max=512.0).detach()
    ok = ok & (radius > 0)
    sx, sy = screen[:, 0].detach(), screen[:, 1].detach()
    min_x = torch.trunc(sx - radius).clamp(min=0).long()
    min_y = torch.trunc(sy - radius).clamp(min=0).long()
    max_x = torch.trunc(sx + radius).clamp(max=width - 1).long()
    max_y = torch.trunc(sy + radius).clamp(max=height - 1).long()
    ok = ok & (min_x <= max_x) & (min_y <= max_y)
    tmin = torch.stack([min_x // ts, min_y // ts], -1)
    tmax = torch.stack([(max_x // ts).clamp(max=tiles_x - 1), (max_y // ts).clamp(max=tiles_y - 1)],
                       -1)
    ok = ok & ((tmax - tmin + 1).prod(-1) <= 256)
    opacity = 1.0 / (1.0 + torch.exp(-p["raw_opacities"].clamp(-8.0, 8.0)))
    emit = ok & (opacity >= 0.005)
    rel = means - eye
    dirs = rel / torch.linalg.vector_norm(rel, dim=-1, keepdim=True).clamp(min=1e-8)
    col = sh_color(p["sh"], dirs, degree)
    live = (col > 0.01) & (col < 0.99)
    color = torch.where(live, col, col.detach())
    return Projected(screen, conic, opacity, color, z.detach(), emit, tmin, tmax)


def _blend_rows(pr: Projected, order: torch.Tensor, pose: dict, y0: int, y1: int):
    """Pixel rows [y0, y1): [rows, W, 3] front to back over the emitting
    Gaussians ``order`` (depth order), each over the pixels of its tiles."""
    dt = pr.screen.dtype
    ts, width = 16, pose["width"]
    ys = torch.arange(y0, y1, dtype=dt) + 0.5
    xs = torch.arange(width, dtype=dt) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    px, py = px.reshape(-1, 1), py.reshape(-1, 1)
    tx, ty = (px // ts).long(), (py // ts).long()
    s, cn, op = pr.screen[order], pr.conic[order], pr.opacity[order]
    inside = ((tx >= pr.tmin[order, 0]) & (tx <= pr.tmax[order, 0])
              & (ty >= pr.tmin[order, 1]) & (ty <= pr.tmax[order, 1]))
    dx, dy = px - s[:, 0], py - s[:, 1]
    power = -0.5 * (cn[:, 0] * dx * dx + cn[:, 2] * dy * dy) - cn[:, 1] * (dx * dy)
    op = torch.where(cn.abs().sum(-1) >= 1e-4, op, torch.zeros_like(op))
    a_raw = op * torch.exp(power)
    mask = inside & (power <= 0.0) & (power >= -4.5) & (a_raw >= 1.0 / 255.0)
    alpha = torch.where(mask, a_raw.clamp(max=0.99), torch.zeros_like(a_raw))
    log1m = torch.log1p(-alpha)
    trans = torch.exp(torch.cumsum(log1m, -1) - log1m)
    rgb = (alpha * trans) @ pr.color[order] + torch.exp(log1m.sum(-1))[:, None]
    return rgb.reshape(y1 - y0, width, 3)


def _order(pr: Projected) -> torch.Tensor:
    """The emitting Gaussians by depth, equal depths by index."""
    idx = torch.nonzero(pr.emit).squeeze(1)
    return idx[torch.sort(pr.depth[idx], stable=True).indices]


ROWS = 8


def render(p: dict, pose: dict, degree: int) -> torch.Tensor:
    """The frame [H, W, 3], without autograd."""
    with torch.no_grad():
        pr = project(p, pose, degree)
        order = _order(pr)
        return torch.cat([_blend_rows(pr, order, pose, y, min(y + ROWS, pose["height"]))
                          for y in range(0, pose["height"], ROWS)])


def render_grad(p: dict, pose: dict, degree: int, loss_fn):
    """(image, loss_fn(image), {field: gradient}) for the leaves of ``p``:
    the image rendered without autograd, the loss differentiated in it, and
    each band of rows rendered again under autograd with its slice of that
    cotangent, then through the projection."""
    leaves = {f: p[f].detach().clone().requires_grad_(True) for f in FIELDS}
    with torch.enable_grad():
        pr = project(dict(leaves, alive=p["alive"]), pose, degree)
    order = _order(pr)
    held = [pr.screen, pr.conic, pr.opacity, pr.color]
    det = [x.detach().requires_grad_(True) for x in held]
    prd = pr._replace(screen=det[0], conic=det[1], opacity=det[2], color=det[3])
    bands = [(y, min(y + ROWS, pose["height"])) for y in range(0, pose["height"], ROWS)]
    with torch.no_grad():
        img = torch.cat([_blend_rows(prd, order, pose, y0, y1) for y0, y1 in bands])
    img_leaf = img.requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(img_leaf)
        (d_img,) = torch.autograd.grad(loss.grad_loss, img_leaf)
        for y0, y1 in bands:
            _blend_rows(prd, order, pose, y0, y1).backward(d_img[y0:y1])
        torch.autograd.backward(held, [d.grad if d.grad is not None else torch.zeros_like(d)
                                       for d in det])
    grads = {f: leaves[f].grad if leaves[f].grad is not None else torch.zeros_like(leaves[f])
             for f in FIELDS}
    return img.detach(), loss, grads


class Loss(NamedTuple):
    grad_loss: torch.Tensor      # (1 - l) sum L1 + l sum D-SSIM
    combined_mean: torch.Tensor  # (1 - l) mean L1 + l mean D-SSIM


def _blur(x: torch.Tensor) -> torch.Tensor:
    """Separable 11-tap Gaussian blur (sigma 1.5, normalised) of [K, H, W]
    planes, replicated edges."""
    d = torch.arange(-5, 6, dtype=x.dtype)
    k = torch.exp(-(d * d) / (2.0 * 1.5 * 1.5))
    k = k / k.sum()
    y = F.conv2d(F.pad(x[:, None], (5, 5, 5, 5), mode="replicate"), k.reshape(1, 1, 1, -1))
    return F.conv2d(y, k.reshape(1, 1, -1, 1))[:, 0]


def photometric_loss(img: torch.Tensor, gt: torch.Tensor, lam: float = 0.2) -> Loss:
    """L1 (mean over RGB) and D-SSIM (grey = mean RGB, clamp((1 - SSIM) / 2,
    0, 1)) per pixel."""
    l1 = (img - gt).abs().mean(-1)
    x, y = img.mean(-1), gt.mean(-1)
    mu_x, mu_y, e_xx, e_yy, e_xy = _blur(torch.stack([x, y, x * x, y * y, x * y]))
    var_x, var_y, cov = e_xx - mu_x * mu_x, e_yy - mu_y * mu_y, e_xy - mu_x * mu_y
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim = ((2 * mu_x * mu_y + c1) * (2 * cov + c2)) / ((mu_x * mu_x + mu_y * mu_y + c1)
                                                        * (var_x + var_y + c2))
    dssim = torch.clamp((1.0 - ssim) / 2.0, 0.0, 1.0)
    return Loss((1 - lam) * l1.sum() + lam * dssim.sum(), (1 - lam) * l1.mean() + lam * dssim.mean())


OPTIM = dict(position_lr_init=1.6e-4, position_lr_final=1.6e-6, scale_lr=5e-3,
             rotation_lr=1e-3, opacity_lr=0.025, sh_lr=2.5e-3, sh_rest_lr=2.5e-3 / 20,
             beta1=0.9, beta2=0.999, eps=1e-8)


class State(NamedTuple):
    params: dict   # the five fields and alive
    m: dict
    v: dict
    t: int         # completed steps


def init_state(params: dict, t: int = 0, dtype=torch.float64) -> State:
    p = {f: params[f].detach().to(dtype).clone() for f in FIELDS}
    p["alive"] = params["alive"].clone()
    return State(p, {f: torch.zeros_like(p[f]) for f in FIELDS},
                 {f: torch.zeros_like(p[f]) for f in FIELDS}, t)


@torch.no_grad()
def adam(st: State, grads: dict, oc: dict, total_iters: int) -> State:
    """One Adam step with the port's clips and clamps, the SH rest bands at
    ``sh_rest_lr``."""
    t = st.t + 1
    bc1, bc2 = 1.0 - oc["beta1"] ** t, 1.0 - oc["beta2"] ** t
    p = st.params
    bad = (~torch.isfinite(grads["means"]).all(-1) | ~torch.isfinite(grads["raw_opacities"])
           | ~torch.isfinite(grads["sh"]).flatten(1).all(-1) | ~torch.isfinite(p["means"]).all(-1)
           | (p["means"].abs() > 1e6).any(-1))
    active = p["alive"] & ~bad
    pos_lr = (oc["position_lr_final"] if st.t >= total_iters else oc["position_lr_init"] * (
        oc["position_lr_final"] / oc["position_lr_init"]) ** (st.t / max(total_iters, 1)))
    new_p, new_m, new_v = {"alive": p["alive"]}, {}, {}
    for f in FIELDS:
        g = grads[f].clamp(-0.5, 0.5)
        m = oc["beta1"] * st.m[f] + (1.0 - oc["beta1"]) * g
        v = oc["beta2"] * st.v[f] + (1.0 - oc["beta2"]) * g * g
        d = (m / bc1) / (torch.sqrt(v / bc2) + oc["eps"])
        keep = active.reshape(active.shape + (1,) * (g.ndim - 1))
        if f == "means":
            upd = pos_lr * d
            norm = torch.linalg.vector_norm(upd, dim=-1, keepdim=True)
            upd = upd * torch.where(norm > 0.1, 0.1 / norm.clamp(min=1e-20), torch.ones_like(norm))
            x = p[f] - upd
            keep = keep & (torch.isfinite(x).all(-1, keepdim=True)
                           & (x.abs().amax(-1, keepdim=True) < 1e6))
        elif f == "quats":
            x = p[f] - oc["rotation_lr"] * d
            n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
            ident = torch.zeros_like(x)
            ident[:, 0] = 1.0
            x = torch.where(n > 1e-3, x / n.clamp(min=1e-3), ident)
        elif f == "sh":
            lr = torch.full_like(d[:1, :, :1], oc["sh_rest_lr"])
            lr[:, 0] = oc["sh_lr"]
            x = torch.clamp(p[f] - lr * d, -2.0, 2.0)
        else:
            lr, lim = {"log_scales": (oc["scale_lr"], 4.0),
                       "raw_opacities": (oc["opacity_lr"], 8.0)}[f]
            x = torch.clamp(p[f] - lr * d, -lim, lim)
        new_p[f] = torch.where(keep, x, p[f])
        mom = active.reshape(active.shape + (1,) * (g.ndim - 1))
        new_m[f] = torch.where(mom, m, st.m[f])
        new_v[f] = torch.where(mom, v, st.v[f])
    return State(new_p, new_m, new_v, t)


class StepOut(NamedTuple):
    state: State
    loss: float
    grads: dict     # before the clip
    image: torch.Tensor


def step(st: State, pose: dict, gt: torch.Tensor, degree: int, total_iters: int,
         oc: dict | None = None) -> StepOut:
    """One training step on one view at SH ``degree``."""
    img, loss, grads = render_grad(st.params, pose, degree,
                                   lambda im: photometric_loss(im, gt.to(im.dtype)))
    return StepOut(adam(st, grads, oc or OPTIM, total_iters), float(loss.combined_mean.detach()),
                   grads, img)
