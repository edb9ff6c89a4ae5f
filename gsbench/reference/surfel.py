"""Plain PyTorch reference of one training step of 2D Gaussian Splatting
(Huang et al. 2024, arXiv:2403.17888): the surfel frame, its maps (colour,
alpha, expected depth, normal, depth distortion), the loss with the two
regularizers, its gradient by autograd and Adam.

The equations, per pixel centre (x, y) and surfel, in the centres' depth
order:

- T = W H: W world to (x w, y w, w) in pixels (the camera's viewproj and
  the viewport), H the surfel's columns (s_u t_u, s_v t_v, p), t_u, t_v
  the first two columns of R(q) (eqs. 5-7);
- the ray-splat intersection (eqs. 8-10): h_u = x T_2 - T_0, h_v = y T_2 -
  T_1, (u, v) = (c0, c1) / c2 for c = h_u x h_v, G = exp(-(u^2 + v^2)/2),
  the intersection's depth T_2 . (u, v, 1);
- the object-space low-pass (eq. 11): G^ = max(G, exp(-|(x, y) - c|^2 /
  (2 sigma^2))), sigma = sqrt(2)/2 px, c = (T02, T12) / T22 the projected
  centre; where it wins, the depth is T22 (2DGS's rasterizer);
- the blend (eq. 12): alpha = min(op G^, 0.99), w = alpha T, the colour
  sum w c over a white background, alpha sum w, the expected depth sum w z
  / sum w, the normal sum w n (t_w in camera space, turned to face the
  camera);
- the depth distortion as 2DGS's public rasterizer computes eq. 13:
  sum_i w_i (m_i^2 A_i + M2_i - 2 m_i M1_i), m = f/(f - n) (1 - n/z), n =
  0.2, f = 100, A_i, M1_i, M2_i the sums of w, w m, w m^2 over the surfels
  in front of i, accumulated lane by lane;
- the normal consistency (eq. 14 as 2DGS's training script takes it): 1 -
  n . N per pixel, N the normal of the expected depth from central
  differences of the back-projected pixel centres (0 on the border) times
  alpha, no gradient through alpha;
- the loss (eq. 15): reference/train.py's photometric loss (its sums over
  pixels carry the gradient) plus lambda_dist sum(distortion) +
  lambda_normal sum(normal error); logged as the means.

Where the system departs from 2DGS, this follows the system: its culls
(the centre's z and ndc, a disc of radius 3 (u^2 + v^2 <= -2 power_floor)
that reaches the camera plane, the 256-tile cap over that disc's bounding
box joined with the low-pass disc, the pair opacity floor), the power
window [-4.5, 0], alpha at least 1/255 and its cap passing the gradient
through (as 2DGS's backward and the system's kernels do), the SH colour
of reference/sh.py clamped to [0, 1] with its dead zone, Adam with
reference/sh.py's clips and rest-band rate.  Where c2 = 0 the intersection
is missing and the low-pass alone applies.

Every surfel is blended into the pixels of the tiles of its rectangle, in
groups of tiles so that a frame of tens of millions of pairs fits (the
pairs and the groups of reference/raster.py); the maps are rendered without
autograd, the loss differentiated in them, and each group rendered again
under autograd with its slice of the cotangent.  Computes in the precision
it is given (float64 for the check; "tf32" for the control: float32 with
every matrix product's operands rounded to TF32).  TF32 is off.  Nothing
here imports the system.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gsbench.reference import raster
from gsbench.reference import sh as rsh
from gsbench.reference import train as rtrain

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NEAR, FAR = 0.2, 100.0
BLOCK_BUDGET = 1 << 22


class Surfels(NamedTuple):
    tmat: torch.Tensor     # [N, 3, 3]
    normal: torch.Tensor   # [N, 3]
    opacity: torch.Tensor  # [N]
    color: torch.Tensor    # [N, 3]
    pr: raster.Projected   # depth, emit and the tile rectangle (reference/raster.pairs reads them)
    tests: torch.Tensor    # [N] pixels of the disc's box (the floor's power tests)


def _mm(a, b, prec):
    return raster.mm_in(a, prec) @ raster.mm_in(b, prec)


def project(p: dict, pose: dict, rc: dict, degree: int, prec=torch.float64, vs=None) -> Surfels:
    """The surfels of ``p`` (log_scales [N, 2]), differentiable in the
    fields (and ``vs`` [N, 2], a screen-space shift)."""
    dtype = raster.real(prec)
    means = p["means"].to(dtype)
    dev = means.device
    w_px, h_px, ts = pose["width"], pose["height"], rc["tile_size"]
    view, viewproj = raster.camera_matrices(pose, dtype, dev)
    wpix = torch.stack([0.5 * w_px * (viewproj[0] + viewproj[3]),
                        0.5 * h_px * (viewproj[1] + viewproj[3]), viewproj[3]])
    homo = torch.cat([means, torch.ones_like(means[:, :1])], -1)
    vpos, clip = _mm(homo, view.T, prec), _mm(homo, viewproj.T, prec)
    ok = (p["alive"] & torch.isfinite(means).all(-1) & (means.abs() <= 1e6).all(-1)
          & (clip[:, 3] > rc["z_cull"]) & (vpos[:, 2] > rc["z_cull"]))
    ndc = clip[:, :2] / torch.where(ok, clip[:, 3], torch.ones_like(clip[:, 3]))[:, None]
    ok = ok & (ndc.abs() <= rc["ndc_cull"]).all(-1)
    s = torch.exp(p["log_scales"].to(dtype).clamp(-rc["max_log_scale"], rc["max_log_scale"]))
    q = p["quats"].to(dtype)
    qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    ident = torch.zeros_like(q)
    ident[:, 0] = 1.0
    rot = raster.quat_to_rotmat(torch.where(qn > 1e-3, q / qn.clamp(min=1e-3), ident))
    cols = torch.stack([rot[:, :, 0] * s[:, :1], rot[:, :, 1] * s[:, 1:], means], -1)  # [N, 3, 3]
    tmat = _mm(wpix[:, :3], cols, prec)
    tmat = torch.cat([tmat[:, :, :2], tmat[:, :, 2:] + wpix[:, 3][None, :, None]], -1)
    if vs is not None:
        tmat = torch.cat([tmat[:, :2] + vs[:, :, None] * tmat[:, 2:], tmat[:, 2:]], 1)
    r2 = -2.0 * rc["power_floor"]
    t2 = tmat[:, 2].detach()

    def dual(a, b):
        return r2 * (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) - a[:, 2] * b[:, 2]

    d22 = dual(t2, t2)
    ok = ok & (d22 < 0)
    d22s = torch.where(ok, d22, -torch.ones_like(d22))
    w22 = torch.where(ok, t2[:, 2], torch.ones_like(d22))
    lp = math.sqrt(-rc["power_floor"])
    lo, hi, blo, bhi = [], [], [], []
    for i in range(2):
        ti = tmat[:, i].detach()
        cen = dual(ti, t2) / d22s
        ext = torch.sqrt(torch.clamp(cen * cen - dual(ti, ti) / d22s, min=1e-4))
        c = ti[:, 2] / w22
        lo.append(torch.maximum(torch.minimum(cen - ext, c - lp), c - rc["max_radius"]))
        hi.append(torch.minimum(torch.maximum(cen + ext, c + lp), c + rc["max_radius"]))
    mn = [torch.trunc(lo[0]).clamp(min=0), torch.trunc(lo[1]).clamp(min=0)]
    mx = [torch.trunc(hi[0]).clamp(max=w_px - 1), torch.trunc(hi[1]).clamp(max=h_px - 1)]
    ok = ok & (mn[0] <= mx[0]) & (mn[1] <= mx[1])
    tiles = (-(-w_px // ts), -(-h_px // ts))
    tmin = torch.stack([torch.div(mn[i], ts, rounding_mode="floor") for i in range(2)], -1).long()
    tmax = torch.stack([torch.div(mx[i], ts, rounding_mode="floor").clamp(max=tiles[i] - 1)
                        for i in range(2)], -1).long()
    ok = ok & ((tmax - tmin + 1).prod(-1) <= rc["max_tiles_per_gaussian"])
    raw = p["raw_opacities"].to(dtype).clamp(-rc["raw_opacity_clamp"], rc["raw_opacity_clamp"])
    opacity = 1.0 / (1.0 + torch.exp(-raw))
    emit = ok & (opacity >= rc["pair_min_opacity"])
    n_cam = _mm(rot[:, :, 2], view[:3, :3].T, prec)
    flip = (n_cam * vpos[:, :3]).sum(-1) >= 0
    normal = torch.where(flip[:, None], -n_cam, n_cam)
    eye = -view[:3, :3].T @ view[:3, 3]
    rel = means - eye
    dirs = rel / torch.linalg.vector_norm(rel, dim=-1, keepdim=True).clamp(min=1e-8)
    col = rsh.color(p["sh"].to(dtype), dirs, degree)
    live = (col > 0.01) & (col < 0.99)
    color = torch.where(live, col, col.detach())
    # the pixels whose centre lies in the box [lo, hi] (the floor's tests)
    nx = (torch.floor(hi[0] - 0.5) - torch.ceil(lo[0] - 0.5) + 1).clamp(min=0)
    ny = (torch.floor(hi[1] - 0.5) - torch.ceil(lo[1] - 0.5) + 1).clamp(min=0)
    tests = torch.where(emit, nx * ny, torch.zeros_like(nx))
    zero = torch.zeros_like(means[:, :2])
    pr = raster.Projected(zero, zero, opacity, color, vpos[:, 2].detach(), emit, tmin, tmax, zero)
    return Surfels(tmat, normal, opacity, color, pr, tests)


class Block(NamedTuple):
    maps: torch.Tensor     # [G, P2, 9]: rgb with the background, A, sum w z, sum w n, distortion
    kept: int


def blend_tiles(sf: Surfels, pa: raster.Pairs, pose: dict, rc: dict, t0: int, t1: int,
                longest: int, prec=torch.float64, lowpass: bool = True) -> Block:
    """Pixels of tiles [t0, t1), front to back over each tile's pairs."""
    dev = sf.tmat.device
    dtype = sf.tmat.dtype
    ts = rc["tile_size"]
    tiles_x = -(-pose["width"] // ts)
    tiles = torch.arange(t0, t1, device=dev)
    lane = torch.arange(max(longest, 1), device=dev)
    s, e = pa.start[t0:t1], pa.start[t0 + 1:t1 + 1]
    valid = lane[None, :] < (e - s)[:, None]                            # [G, L]
    idx = torch.where(valid, s[:, None] + lane[None, :], 0)
    g = torch.where(valid, pa.gid[idx] if pa.gid.numel() else idx, 0)
    pix = torch.arange(ts, device=dev, dtype=dtype) + 0.5
    x = (((tiles % tiles_x)[:, None] * ts).to(dtype) + pix.repeat(ts)[None, :])[:, :, None]
    y = (((tiles // tiles_x)[:, None] * ts).to(dtype) + pix.repeat_interleave(ts)[None, :])[:, :, None]
    tm = sf.tmat[g]                                                      # [G, L, 3, 3]
    t = [[tm[:, None, :, i, j] for j in range(3)] for i in range(3)]     # [G, 1, L]
    hu = [x * t[2][j] - t[0][j] for j in range(3)]                        # [G, P2, L]
    hv = [y * t[2][j] - t[1][j] for j in range(3)]
    c0 = hu[1] * hv[2] - hu[2] * hv[1]
    c1 = hu[2] * hv[0] - hu[0] * hv[2]
    c2 = hu[0] * hv[1] - hu[1] * hv[0]
    miss = c2 == 0
    c2s = torch.where(miss, torch.ones_like(c2), c2)
    u, v = c0 / c2s, c1 / c2s
    big = torch.full_like(u, 1e300 if dtype == torch.float64 else 1e36)
    rho3 = torch.where(miss, big, u * u + v * v)
    w22 = torch.where(valid, tm[..., 2, 2], torch.ones_like(tm[..., 2, 2]))[:, None, :]
    cx, cy = t[0][2] / w22, t[1][2] / w22
    rho2 = 2.0 * ((x - cx) ** 2 + (y - cy) ** 2)
    hit = (rho3 <= rho2) if lowpass else ~miss
    rho = torch.where(hit, rho3, rho2) if lowpass else rho3
    power = -0.5 * rho
    op = torch.where(valid, raster.payload(sf.opacity[g], prec), torch.zeros_like(w22[:, 0]))
    a_raw = op[:, None, :] * torch.exp(power)
    keep = (power >= rc["power_floor"]) & (a_raw >= rc["alpha_floor"])
    capped = a_raw + (torch.clamp(a_raw, max=rc["alpha_cap"]) - a_raw).detach()
    alpha = torch.where(keep, capped, torch.zeros_like(a_raw))
    z = torch.where(keep & hit, t[2][0] * u + t[2][1] * v + t[2][2], w22.expand_as(u))
    z = torch.where(keep, z, torch.ones_like(z))
    m = FAR / (FAR - NEAR) * (1.0 - NEAR / z)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha], -1), -1)
    w = alpha * trans[..., :-1]                                          # [G, P2, L]
    wm, wmm = w * m, w * m * m
    acc_a, acc_m1, acc_m2 = (torch.cumsum(q, -1) - q for q in (w, wm, wmm))
    dist = (w * (m * m * acc_a + acc_m2 - 2.0 * m * acc_m1)).sum(-1)
    rgb = torch.einsum("gpl,glc->gpc", raster.mm_in(w, prec), raster.mm_in(sf.color[g], prec))
    bg = 1.0 if rc["white_background"] else 0.0
    nrm = torch.einsum("gpl,glc->gpc", raster.mm_in(w, prec), raster.mm_in(sf.normal[g], prec))
    maps = torch.cat([rgb + bg * trans[..., -1:], w.sum(-1, keepdim=True),
                      (w * z).sum(-1, keepdim=True), nrm, dist[..., None]], -1)
    return Block(maps, int(keep.sum()))


def depth_normal(depth: torch.Tensor, pose: dict) -> torch.Tensor:
    """The normal [H, W, 3] of the expected depth by central differences of
    the back-projected pixel centres, 0 on the border."""
    h, w = depth.shape
    dt, dev = depth.dtype, depth.device
    x = (torch.arange(w, dtype=dt, device=dev) + 0.5 - pose["cx"]) / pose["fx"]
    y = (torch.arange(h, dtype=dt, device=dev) + 0.5 - pose["cy"]) / pose["fy"]
    pts = torch.stack([x[None, :] * depth, y[:, None] * depth, depth], -1)
    n = torch.linalg.cross(pts[2:, 1:-1] - pts[:-2, 1:-1], pts[1:-1, 2:] - pts[1:-1, :-2], dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp(min=1e-12)
    return torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))


class Loss(NamedTuple):
    grad_loss: torch.Tensor
    combined_mean: torch.Tensor


def loss(maps: torch.Tensor, gt: torch.Tensor, pose: dict, cfg: dict, prec,
         regularizers: bool = True, photometric=None) -> Loss:
    """The loss of the full maps [H, W, 9]: the photometric loss of
    reference/train.py (or ``photometric(img, gt, lc, prec)``, a planted
    fault) and, unless ``regularizers`` is False (a planted fault), the
    two regularizers at the configuration's weights."""
    lc = rtrain.loss_constants(cfg)
    fn = photometric or rtrain.photometric_loss
    photo = fn(maps[..., :3], gt, lc, prec)
    if not regularizers:
        return Loss(photo.grad_loss, photo.combined_mean)
    a = maps[..., 3]
    depth = torch.where(a > 0, maps[..., 4] / torch.where(a > 0, a, torch.ones_like(a)),
                        torch.zeros_like(a))
    surf = depth_normal(depth, pose) * a.detach()[..., None]
    err = 1.0 - (maps[..., 5:8] * surf).sum(-1)
    dist = maps[..., 8]
    ld = cfg.get("loss", {}).get("lambda_dist", 0.0)
    ln = cfg.get("loss", {}).get("lambda_normal", 0.0)
    return Loss(photo.grad_loss + ld * dist.sum() + ln * err.sum(),
                photo.combined_mean + ld * dist.mean() + ln * err.mean())


def render_grad(p: dict, pose: dict, gt: torch.Tensor, cfg: dict, degree: int, prec=torch.float64,
                budget: int = BLOCK_BUDGET, lowpass: bool = True, regularizers: bool = True,
                photometric=None):
    """(Loss, gradients {field: tensor}, Frame counts) of one view."""
    rc = raster.raster_constants(cfg.get("raster", {}))
    ts = rc["tile_size"]
    dtype = raster.real(prec)
    leaves = {f: p[f].detach().to(dtype).requires_grad_(True) for f in raster.FIELDS}
    with torch.enable_grad():
        sf = project(dict(leaves, alive=p["alive"]), pose, rc, degree, prec)
    pa = raster.pairs(sf.pr, pose, rc)
    groups = raster._group_tiles(pa, budget, ts * ts)
    held = [sf.tmat, sf.normal, sf.opacity, sf.color]
    det = [x.detach().requires_grad_(True) for x in held]
    sfd = sf._replace(tmat=det[0], normal=det[1], opacity=det[2], color=det[3])
    tiles = torch.empty((pa.start.numel() - 1, ts * ts, 9), dtype=dtype, device=sf.tmat.device)
    kept = 0
    with torch.no_grad():
        for t0, t1, longest in groups:
            blk = blend_tiles(sfd, pa, pose, rc, t0, t1, longest, prec, lowpass)
            tiles[t0:t1] = blk.maps
            kept += blk.kept
    maps = _tiles_to_maps(tiles, ts, pose["width"], pose["height"])
    leaf = maps.detach().requires_grad_(True)
    with torch.enable_grad():
        report = loss(leaf, gt.to(dtype), pose, cfg, prec, regularizers, photometric)
        (d_maps,) = torch.autograd.grad(report.grad_loss, leaf)
    d_tiles = _maps_to_tiles(d_maps, ts)
    with torch.enable_grad():
        for t0, t1, longest in groups:
            blk = blend_tiles(sfd, pa, pose, rc, t0, t1, longest, prec, lowpass)
            blk.maps.backward(d_tiles[t0:t1])
        torch.autograd.backward(held, [d.grad if d.grad is not None else torch.zeros_like(d)
                                       for d in det])
    grads = {f: (leaves[f].grad if leaves[f].grad is not None else torch.zeros_like(leaves[f]))
             for f in raster.FIELDS}
    counts = dict(live=int(p["alive"].sum()), pairs=int(pa.gid.numel()), kept=kept,
                  tests=int(sf.tests.sum()), pixels=pose["width"] * pose["height"])
    return report, grads, counts


def _tiles_to_maps(tiles: torch.Tensor, ts: int, width: int, height: int) -> torch.Tensor:
    tx, ty = -(-width // ts), -(-height // ts)
    k = tiles.shape[-1]
    img = tiles.reshape(ty, tx, ts, ts, k).permute(0, 2, 1, 3, 4).reshape(ty * ts, tx * ts, k)
    return img[:height, :width]


def _maps_to_tiles(maps: torch.Tensor, ts: int) -> torch.Tensor:
    h, w, k = maps.shape
    tx, ty = -(-w // ts), -(-h // ts)
    pad = torch.zeros((ty * ts, tx * ts, k), dtype=maps.dtype, device=maps.device)
    pad[:h, :w] = maps
    return pad.reshape(ty, ts, tx, ts, k).permute(0, 2, 1, 3, 4).reshape(-1, ts * ts, k)


class StepOut(NamedTuple):
    state: rtrain.State
    loss: float
    grads: dict
    counts: dict


def step(st: rtrain.State, pose: dict, gt: torch.Tensor, cfg: dict, total_iters: int,
         degree: int, lowpass: bool = True, regularizers: bool = True,
         photometric=None) -> StepOut:
    """One training step on one view at the state's precision, Adam with
    reference/sh.py's rest-band rate; ``lowpass``, ``regularizers`` and
    ``photometric`` plant the faults."""
    report, grads, counts = render_grad(st.params, pose, gt, cfg, degree, st.prec,
                                        lowpass=lowpass, regularizers=regularizers,
                                        photometric=photometric)
    state = rsh.adam(st, grads, rtrain.optim_constants(cfg), total_iters, rsh.rest_lr(cfg))
    return StepOut(state, float(report.combined_mean.detach()), grads, counts)
