"""Plain PyTorch reference of the published 3DGS colour (Kerbl et al. 2023,
arXiv:2308.04079) in the frame and the training step of reference/raster.py
and reference/train.py: spherical harmonics of degree 0 to 3 in place of
``Projected.color``, and Adam with the bands above the DC at their own
learning rate.

The colour follows the authors' ``utils/sh_utils.py`` ``eval_sh`` and the
CUDA rasterizer's ``computeColorFromSH``: the real SH basis and constants
below, evaluated along the unit direction from the camera's centre to the
mean, 0.5 added.  The frame reuses raster.py's projection (every cull), its
pairs, its blocked blend and its backward; the step reuses train.py's loss
and Adam.  Where the system departs from 3DGS, this follows the system:

- the colour is clamped to [0, 1] (3DGS clamps at 0 only), and its gradient
  is zeroed outside (0.01, 0.99) (the system's dead zone);
- Adam clamps the coefficients to +/-2 (``sh_clamp``), with train.py's
  other clips;
- the cull and blend semantics are raster.py's (the 3-sigma tile
  rectangle, the 256-tile cap, the pair opacity floor, the power window,
  the alpha floor and cap, no early termination).

The bands above the DC step at ``optim.sh_rest_lr`` (3DGS: ``feature_lr /
20``; the DC's ``sh_lr`` where it is not set).  Computes in the precision it
is given (float64 for the check; "tf32" for the control, raster.py's).
TF32 is off.  Nothing here imports the system.
"""

from __future__ import annotations

import torch

from gsbench.reference import raster
from gsbench.reference import train as rtrain

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

C0 = raster.SH_C0
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def basis(dirs: torch.Tensor, degree: int) -> list:
    """The (degree + 1)^2 real SH basis functions of 3DGS at unit ``dirs``
    [N, 3], each [N]."""
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
    return out


def color(sh: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """clamp(sum_k basis_k(dirs) sh[:, k] + 0.5, 0, 1) [N, 3] of sh [N, K, 3]
    (K >= (degree + 1)^2), summed band by band in elementwise products."""
    rgb = 0.5 + torch.zeros_like(sh[:, 0])
    for k, b in enumerate(basis(dirs, degree)):
        rgb = rgb + b[:, None] * sh[:, k]
    return torch.clamp(rgb, 0.0, 1.0)


def project(p: dict, pose: dict, rc: dict, degree: int, prec=torch.float64) -> raster.Projected:
    """raster.project with the colour of SH ``degree`` along the direction
    from the camera's centre (x_cam = R x + t: -R^T t) to each mean, with
    the dead zone in its gradient."""
    pr = raster.project(p, pose, rc, prec)
    dtype = raster.real(prec)
    means = p["means"].to(dtype)
    view, _ = raster.camera_matrices(pose, dtype, means.device)
    eye = -view[:3, :3].T @ view[:3, 3]
    rel = means - eye
    dirs = rel / torch.linalg.vector_norm(rel, dim=-1, keepdim=True).clamp(min=1e-8)
    col = color(p["sh"].to(dtype), dirs, degree)
    live = (col > 0.01) & (col < 0.99)
    return pr._replace(color=torch.where(live, col, col.detach()))


def render_grad(p: dict, pose: dict, rc: dict, degree: int, loss_fn, prec=torch.float64,
                budget: int = raster.BLOCK_BUDGET):
    """raster.render_grad with the colour of SH ``degree``: (loss report,
    gradients {field: tensor}, Frame)."""
    ts = rc["tile_size"]
    dtype = raster.real(prec)
    leaves = {f: p[f].detach().to(dtype).requires_grad_(True) for f in raster.FIELDS}
    with torch.enable_grad():
        pr = project(dict(leaves, alive=p["alive"]), pose, rc, degree, prec)
    pa = raster.pairs(pr, pose, rc)
    groups = raster._group_tiles(pa, budget, ts * ts)
    held = [pr.screen, pr.conic, pr.opacity, pr.color]
    det = [x.detach().requires_grad_(True) for x in held]
    prd = pr._replace(screen=det[0], conic=det[1], opacity=det[2], color=det[3])
    tiles = torch.empty((pa.start.numel() - 1, ts * ts, 3), dtype=dtype, device=pr.depth.device)
    kept = 0
    with torch.no_grad():
        for t0, t1, longest in groups:
            blk = raster.blend_tiles(prd, pa, pose, rc, t0, t1, longest, prec)
            tiles[t0:t1] = blk.rgb
            kept += blk.kept
    img = raster._tiles_to_image(tiles, ts, pose["width"], pose["height"])
    img_leaf = img.detach().requires_grad_(True)
    with torch.enable_grad():
        report = loss_fn(img_leaf)
        (d_img,) = torch.autograd.grad(report.grad_loss, img_leaf)
    d_tiles = raster._image_to_tiles(d_img, ts)
    with torch.enable_grad():
        for t0, t1, longest in groups:
            blk = raster.blend_tiles(prd, pa, pose, rc, t0, t1, longest, prec)
            blk.rgb.backward(d_tiles[t0:t1])
        torch.autograd.backward(held, [d.grad if d.grad is not None else torch.zeros_like(d)
                                       for d in det])
    grads = {f: (leaves[f].grad if leaves[f].grad is not None else torch.zeros_like(leaves[f]))
             for f in raster.FIELDS}
    frame = raster.Frame(img, int(pa.gid.numel()), kept, raster.pixel_tests(pr, pose),
                         int(p["alive"].sum()))
    return report, grads, frame


def rest_lr(cfg: dict) -> float:
    """The learning rate of the SH bands above the DC: ``optim.sh_rest_lr``,
    else ``optim.sh_lr``."""
    oc = cfg.get("optim", {})
    lr = oc.get("sh_rest_lr")
    return rtrain.optim_constants(cfg)["sh_lr"] if lr is None else lr


@torch.no_grad()
def adam(st: rtrain.State, grads: dict, oc: dict, total_iters: int, sh_rest: float) -> rtrain.State:
    """train.adam, the SH bands above the DC stepped at ``sh_rest``: the
    same moments, the coefficients' update taken again with the rate of
    each band, on the Gaussians train.adam moved."""
    out = rtrain.adam(st, grads, oc, total_iters)
    if sh_rest == oc["sh_lr"]:
        return out
    p = st.params
    bad = (~torch.isfinite(grads["means"]).all(-1) | ~torch.isfinite(grads["raw_opacities"])
           | ~torch.isfinite(grads["sh"]).flatten(1).all(-1) | ~torch.isfinite(p["means"]).all(-1)
           | (p["means"].abs() > 1e6).any(-1))
    active = (p["alive"] & ~bad)[:, None, None]
    bc1, bc2 = 1.0 - oc["beta1"] ** out.t, 1.0 - oc["beta2"] ** out.t
    d = (out.m["sh"] / bc1) / (torch.sqrt(out.v["sh"] / bc2) + oc["eps"])
    lr = torch.full_like(d[:1, :, :1], sh_rest)
    lr[:, 0] = oc["sh_lr"]
    x = torch.clamp(p["sh"] - lr * d, -oc["sh_clamp"], oc["sh_clamp"])
    return out._replace(params=dict(out.params, sh=torch.where(active, x, p["sh"])))


def step(st: rtrain.State, pose: dict, gt: torch.Tensor, cfg: dict, total_iters: int,
         degree: int, loss_fn=None) -> rtrain.StepOut:
    """train.step with the colour of SH ``degree`` and the rest bands'
    learning rate; ``loss_fn(img, gt, lc, prec)`` replaces the photometric
    loss (a planted fault)."""
    rc = raster.raster_constants(cfg.get("raster", {}))
    lc = rtrain.loss_constants(cfg)
    gt = gt.to(raster.real(st.prec))
    fn = loss_fn or rtrain.photometric_loss
    report, grads, frame = render_grad(st.params, pose, rc, degree,
                                       lambda img: fn(img, gt, lc, st.prec), st.prec)
    state = adam(st, grads, rtrain.optim_constants(cfg), total_iters, rest_lr(cfg))
    return rtrain.StepOut(state, float(report.combined_mean.detach()), grads, frame)
