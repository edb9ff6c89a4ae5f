"""Plain PyTorch reference of one frame of 3D Gaussian Splatting: projection,
the (tile, Gaussian) pairs, a per-pixel front-to-back blend and the
composite over a white background.

It follows the rasterization semantics of the system under test (the Metal
reference's tiled_shaders.metal:102-385, as ``tests/reference_renderer.py``
states them one Gaussian and one pixel at a time): every cull of the
projection, the 3-sigma tile rectangle, the 256-tile cap, the pair opacity
floor, the power window [-4.5, 0], the alpha floor 1/255 and cap 0.99, no
early termination (the port's default mode), the colour's dead zone in the
gradient.  Nothing here imports the port.  It computes in the dtype it is
given: float64 for the check; for the control, "tf32" (float32 with the
operands of every matrix product rounded to TF32's 10-bit mantissa, as the
tensor cores take them with TF32 on) or "fp8" (float32 with each pair's
render data and its cotangent rounded to fp8 e4m3's 3-bit mantissa), both
emulated so that the control reads the same on any device.  It blends
tile groups in blocks so that a frame of millions of pairs fits, and runs
under autograd, so a training step's gradient is one ``backward``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

SH_C0 = 0.28209479177387814
FIELDS = ("means", "log_scales", "quats", "raw_opacities", "sh")

# RasterConfig's semantics (tile size and the constants the frame uses)
RASTER_DEFAULTS = dict(
    tile_size=16, max_radius=512.0, max_log_scale=5.0, ndc_cull=1.2, z_cull=0.1,
    lowpass=0.3, min_det=1e-4, aspect_clamp=20.0, jacobian_clamp=1.3, power_floor=-4.5,
    alpha_cap=0.99, alpha_floor=1.0 / 255.0, raw_opacity_clamp=8.0, pair_min_opacity=0.005,
    max_tiles_per_gaussian=256, white_background=True,
)


def real(prec) -> torch.dtype:
    """The floating dtype of a precision: float64, float32, "tf32" or
    "fp8" (float32 with the pairs' payload at fp8's mantissa)."""
    return torch.float32 if prec in ("tf32", "fp8") else prec


def control_precision(cfg: dict):
    """The precision below a configuration's, in which the control runs:
    TF32 for a float32 payload, fp8 for a bfloat16 one."""
    return {"f32": "tf32", "bf16": "fp8"}[cfg.get("raster", {}).get("payload_dtype", "f32")]


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 values rounded to ``bits`` mantissa bits (ties away from
    zero), the exponent's range kept."""
    drop = 23 - bits
    i = x.contiguous().view(torch.int32)
    return ((i + (1 << (drop - 1))) & ~((1 << drop) - 1)).view(torch.float32)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits); the gradient passes
    straight through."""
    return x + (round_mantissa(x.detach(), 10) - x).detach()


class _RoundFP8(torch.autograd.Function):
    """Rounds values to fp8 e4m3's 3 mantissa bits and their cotangents
    alike (the exponent's range kept, so the control never saturates)."""

    @staticmethod
    def forward(ctx, x):
        return round_mantissa(x, 3)

    @staticmethod
    def backward(ctx, g):
        return round_mantissa(g, 3)


def mm_in(x: torch.Tensor, prec) -> torch.Tensor:
    """An operand of a matrix product at precision ``prec``."""
    return round_tf32(x) if prec == "tf32" else x


def payload(x: torch.Tensor, prec) -> torch.Tensor:
    """A pair's render data (conic, opacity, colour) at precision ``prec``:
    "fp8" rounds it and its cotangent to fp8's mantissa, the control of a
    configuration whose payload is bfloat16."""
    return _RoundFP8.apply(x) if prec == "fp8" else x


def raster_constants(raster: dict) -> dict:
    """The constants a frame uses, from a configuration's ``raster`` dict."""
    return {k: raster.get(k, v) for k, v in RASTER_DEFAULTS.items()}


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) -> [..., 3, 3], not normalized."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def camera_matrices(pose: dict, dtype, device, near: float = 0.1, far: float = 1000.0):
    """(view, viewproj) [4, 4] of a pose {quat, t, fx, fy, cx, cy, width,
    height}: x_cam = R x + t, COLMAP intrinsics, w = z_cam."""
    q = torch.tensor(pose["quat"], dtype=dtype, device=device)
    view = torch.eye(4, dtype=dtype, device=device)
    view[:3, :3] = quat_to_rotmat(q)
    view[:3, 3] = torch.tensor(pose["t"], dtype=dtype, device=device)
    w, h = pose["width"], pose["height"]
    proj = torch.zeros((4, 4), dtype=dtype, device=device)
    proj[0, 0] = 2.0 * pose["fx"] / w
    proj[1, 1] = 2.0 * pose["fy"] / h
    proj[0, 2] = 2.0 * pose["cx"] / w - 1.0
    proj[1, 2] = 2.0 * pose["cy"] / h - 1.0
    proj[2, 2] = far / (far - near)
    proj[2, 3] = -(far * near) / (far - near)
    proj[3, 2] = 1.0
    return view, proj @ view


class Projected(NamedTuple):
    screen: torch.Tensor    # [N, 2]
    conic: torch.Tensor     # [N, 3]
    opacity: torch.Tensor   # [N]
    color: torch.Tensor     # [N, 3], the dead zone in its gradient
    depth: torch.Tensor     # [N]
    emit: torch.Tensor      # [N] bool: the Gaussian emits pairs
    tile_min: torch.Tensor  # [N, 2] int64 (tx, ty)
    tile_max: torch.Tensor  # [N, 2] int64
    extent: torch.Tensor    # [N, 2] half-extents of the 3-sigma ellipse's box (pixels)


def project(p: dict, pose: dict, rc: dict, prec=torch.float64) -> Projected:
    """Project the Gaussians of ``p`` (means, log_scales, quats,
    raw_opacities, sh [N, 4, 3], alive), differentiable in the five fields."""
    dev = p["means"].device
    dtype = real(prec)
    means = p["means"].to(dtype)
    log_scales = p["log_scales"].to(dtype)
    width, height, ts = pose["width"], pose["height"], rc["tile_size"]
    tiles_x, tiles_y = -(-width // ts), -(-height // ts)
    view, viewproj = camera_matrices(pose, dtype, dev)
    fx, fy = float(pose["fx"]), float(pose["fy"])

    ok = (p["alive"] & torch.isfinite(means).all(-1) & torch.isfinite(log_scales).all(-1)
          & (means.abs() <= 1e6).all(-1))
    homo = torch.cat([means, torch.ones_like(means[:, :1])], -1)
    vpos = mm_in(homo, prec) @ mm_in(view.T, prec)
    clip = mm_in(homo, prec) @ mm_in(viewproj.T, prec)
    w, z = clip[:, 3], vpos[:, 2]
    ok = ok & (w > rc["z_cull"]) & (z > rc["z_cull"])
    w = torch.where(ok, w, torch.ones_like(w))
    z = torch.where(ok, z, torch.ones_like(z))
    ndc = clip[:, :2] / w[:, None]
    ok = ok & (ndc.abs() <= rc["ndc_cull"]).all(-1)
    screen = torch.stack([(ndc[:, 0] * 0.5 + 0.5) * width, (ndc[:, 1] * 0.5 + 0.5) * height], -1)

    scale = torch.exp(log_scales.clamp(-rc["max_log_scale"], rc["max_log_scale"]))
    smax, smin = scale.amax(-1, keepdim=True), scale.amin(-1, keepdim=True)
    top = rc["aspect_clamp"] * smin
    scale = scale * torch.where(smax > top, top / smax, torch.ones_like(smax))
    q = p["quats"].to(dtype)
    qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    ident = torch.zeros_like(q)
    ident[:, 0] = 1.0
    q = torch.where(qn > 1e-3, q / qn.clamp(min=1e-3), ident)
    m = quat_to_rotmat(q) * scale[:, None, :]
    m = mm_in(m, prec)
    sigma = m @ m.transpose(-1, -2)

    limx, limy = rc["jacobian_clamp"] * fx / z, rc["jacobian_clamp"] * fy / z
    txtz = torch.maximum(torch.minimum(vpos[:, 0] / z, limx), -limx)
    tytz = torch.maximum(torch.minimum(vpos[:, 1] / z, limy), -limy)
    zero = torch.zeros_like(z)
    jac = torch.stack([torch.stack([fx / z, zero, -fx * txtz / z], -1),
                       torch.stack([zero, fy / z, -fy * tytz / z], -1)], -2)   # [N, 2, 3]
    t2 = mm_in(mm_in(jac, prec) @ mm_in(view[:3, :3], prec), prec)
    cov = mm_in(t2 @ mm_in(sigma, prec), prec) @ t2.transpose(-1, -2)
    a = cov[:, 0, 0] + rc["lowpass"]
    b = cov[:, 0, 1]
    c = cov[:, 1, 1] + rc["lowpass"]
    det = a * c - b * b
    ok = ok & (det >= rc["min_det"])
    det = torch.where(ok, det, torch.ones_like(det))
    conic = torch.stack([c / det, -b / det, a / det], -1)
    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.clamp(torch.ceil(3.0 * torch.sqrt(lam1)), max=rc["max_radius"]).detach()
    ok = ok & (radius > 0)

    sx, sy = screen[:, 0].detach(), screen[:, 1].detach()
    min_x = torch.trunc(sx - radius).clamp(min=0).long()
    min_y = torch.trunc(sy - radius).clamp(min=0).long()
    max_x = torch.trunc(sx + radius).clamp(max=width - 1).long()
    max_y = torch.trunc(sy + radius).clamp(max=height - 1).long()
    ok = ok & (min_x <= max_x) & (min_y <= max_y)
    tmin = torch.stack([min_x // ts, min_y // ts], -1)
    tmax = torch.stack([(max_x // ts).clamp(max=tiles_x - 1), (max_y // ts).clamp(max=tiles_y - 1)], -1)
    span = (tmax - tmin + 1).prod(-1)
    ok = ok & (span <= rc["max_tiles_per_gaussian"])

    raw = p["raw_opacities"].to(dtype).clamp(-rc["raw_opacity_clamp"], rc["raw_opacity_clamp"])
    opacity = 1.0 / (1.0 + torch.exp(-raw))
    emit = ok & (opacity >= rc["pair_min_opacity"])
    col = torch.clamp(SH_C0 * p["sh"][:, 0, :].to(dtype) + 0.5, 0.0, 1.0)
    live = (col > 0.01) & (col < 0.99)
    color = torch.where(live, col, col.detach())
    extent = 3.0 * torch.sqrt(torch.stack([a, c], -1).detach().clamp(min=0))
    return Projected(screen, conic, opacity, color, z.detach(), emit, tmin, tmax, extent)


class Pairs(NamedTuple):
    gid: torch.Tensor      # [P] int64, sorted by (tile, depth, index)
    start: torch.Tensor    # [tiles + 1] int64: tile t's pairs are gid[start[t]:start[t+1]]


def pairs(pr: Projected, pose: dict, rc: dict) -> Pairs:
    """Every (tile, Gaussian) pair of the emitting Gaussians, ordered by tile,
    then depth (a stable order: equal depths by index)."""
    dev = pr.depth.device
    ts = rc["tile_size"]
    tiles_x = -(-pose["width"] // ts)
    tiles = tiles_x * -(-pose["height"] // ts)
    n = pr.depth.shape[0]
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[torch.sort(pr.depth, stable=True).indices] = torch.arange(n, device=dev)
    g = torch.nonzero(pr.emit).squeeze(1)
    span = pr.tile_max[g] - pr.tile_min[g] + 1
    count = span.prod(-1)
    gid = torch.repeat_interleave(g, count)
    first = torch.cumsum(count, 0) - count
    off = torch.arange(gid.shape[0], device=dev) - torch.repeat_interleave(first, count)
    sxr = torch.repeat_interleave(span[:, 0], count)
    tx = torch.repeat_interleave(pr.tile_min[g, 0], count) + off % sxr
    ty = torch.repeat_interleave(pr.tile_min[g, 1], count) + off // sxr
    tile = ty * tiles_x + tx
    order = torch.sort(tile * n + rank[gid]).indices
    gid, tile = gid[order], tile[order]
    start = torch.searchsorted(tile, torch.arange(tiles + 1, device=dev))
    return Pairs(gid, start)


def _group_tiles(pa: Pairs, budget: int, p2: int):
    """Consecutive tile ranges [t0, t1) whose padded block (tiles x pixels
    x longest run) stays within ``budget`` elements."""
    counts = (pa.start[1:] - pa.start[:-1]).tolist()
    groups, t0, longest = [], 0, 0
    for t, c in enumerate(counts):
        longest2 = max(longest, c)
        if t > t0 and (t + 1 - t0) * p2 * max(longest2, 1) > budget:
            groups.append((t0, t, longest))
            t0, longest2 = t, c
        longest = longest2
    groups.append((t0, len(counts), longest))
    return groups


class Block(NamedTuple):
    rgb: torch.Tensor      # [G, P2, 3] colour with the background
    kept: int              # (pixel, pair) terms with alpha > 0


def blend_tiles(pr: Projected, pa: Pairs, pose: dict, rc: dict, t0: int, t1: int,
                longest: int, prec=torch.float64) -> Block:
    """Pixels of tiles [t0, t1): front-to-back over each tile's pairs."""
    dev = pr.depth.device
    dtype = pr.screen.dtype
    ts = rc["tile_size"]
    tiles_x = -(-pose["width"] // ts)
    tiles = torch.arange(t0, t1, device=dev)
    lane = torch.arange(max(longest, 1), device=dev)
    s, e = pa.start[t0:t1], pa.start[t0 + 1:t1 + 1]
    valid = lane[None, :] < (e - s)[:, None]                           # [G, L]
    idx = torch.where(valid, s[:, None] + lane[None, :], 0)
    g = torch.where(valid, pa.gid[idx] if pa.gid.numel() else idx, 0)
    pix = torch.arange(ts, device=dev, dtype=dtype) + 0.5
    px = ((tiles % tiles_x)[:, None] * ts).to(dtype) + pix.repeat(ts)[None, :]            # [G, P2]
    py = ((tiles // tiles_x)[:, None] * ts).to(dtype) + pix.repeat_interleave(ts)[None, :]
    dx = px[:, :, None] - pr.screen[g, 0][:, None, :]                   # [G, P2, L]
    dy = py[:, :, None] - pr.screen[g, 1][:, None, :]
    conic = payload(pr.conic[g], prec)
    ca, cb, cc = (conic[..., i][:, None, :] for i in range(3))
    mag = conic.abs().sum(-1)
    op = torch.where(valid & (mag >= 1e-4), payload(pr.opacity[g], prec), torch.zeros_like(mag))
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * (dx * dy)
    a_raw = op[:, None, :] * torch.exp(power)
    mask = (power <= 0.0) & (power >= rc["power_floor"]) & (a_raw >= rc["alpha_floor"])
    alpha = torch.where(mask, a_raw.clamp(max=rc["alpha_cap"]), torch.zeros_like(a_raw))
    log1m = torch.log1p(-alpha)
    trans = torch.exp(torch.cumsum(log1m, -1) - log1m)
    rgb = torch.einsum("gpl,glc->gpc", mm_in(alpha * trans, prec),
                       mm_in(payload(pr.color[g], prec), prec))
    bg = 1.0 if rc["white_background"] else 0.0
    rgb = rgb + bg * torch.exp(log1m.sum(-1))[..., None]
    return Block(rgb, int(mask.sum()))


def _tiles_to_image(tiles: torch.Tensor, ts: int, width: int, height: int) -> torch.Tensor:
    """[tiles, P2, 3] (row-major tiles, p = y * ts + x) -> [H, W, 3]."""
    tx, ty = -(-width // ts), -(-height // ts)
    img = tiles.reshape(ty, tx, ts, ts, 3).permute(0, 2, 1, 3, 4).reshape(ty * ts, tx * ts, 3)
    return img[:height, :width]


def _image_to_tiles(img: torch.Tensor, ts: int) -> torch.Tensor:
    """[H, W, 3] -> [tiles, P2, 3], zero-padded to whole tiles."""
    h, w = img.shape[:2]
    tx, ty = -(-w // ts), -(-h // ts)
    pad = torch.zeros((ty * ts, tx * ts, 3), dtype=img.dtype, device=img.device)
    pad[:h, :w] = img
    return pad.reshape(ty, ts, tx, ts, 3).permute(0, 2, 1, 3, 4).reshape(-1, ts * ts, 3)


class Frame(NamedTuple):
    image: torch.Tensor    # [H, W, 3]
    pairs: int
    kept: int
    tests: int             # (pixel, pair) power tests at pixel granularity (work/)
    live: int


BLOCK_BUDGET = 1 << 24


def render(p: dict, pose: dict, rc: dict, prec=torch.float64,
           budget: int = BLOCK_BUDGET) -> Frame:
    """The frame, without autograd."""
    dtype = real(prec)
    with torch.no_grad():
        pr = project(p, pose, rc, prec)
        pa = pairs(pr, pose, rc)
        ts = rc["tile_size"]
        tiles = torch.empty((pa.start.numel() - 1, ts * ts, 3), dtype=dtype,
                            device=pr.depth.device)
        kept = 0
        for t0, t1, longest in _group_tiles(pa, budget, ts * ts):
            blk = blend_tiles(pr, pa, pose, rc, t0, t1, longest, prec)
            tiles[t0:t1] = blk.rgb
            kept += blk.kept
        img = _tiles_to_image(tiles, ts, pose["width"], pose["height"])
        return Frame(img, int(pa.gid.numel()), kept, pixel_tests(pr, pose),
                     int(p["alive"].sum()))


def pixel_tests(pr: Projected, pose: dict) -> int:
    """Power tests the frame needs at pixel granularity: for each emitting
    Gaussian, the pixels whose centre lies in the axis-aligned box of its
    3-sigma ellipse (no pixel outside it can pass the power window)."""
    s = pr.screen.detach()
    lo = torch.ceil(s - pr.extent - 0.5).clamp(min=0)
    hi = torch.floor(s + pr.extent - 0.5)
    hi = torch.stack([hi[:, 0].clamp(max=pose["width"] - 1), hi[:, 1].clamp(max=pose["height"] - 1)], -1)
    n = (hi - lo + 1).clamp(min=0).prod(-1)
    return int(torch.where(pr.emit, n, torch.zeros_like(n)).sum())


def render_grad(p: dict, pose: dict, rc: dict, loss_fn, prec=torch.float64,
                budget: int = BLOCK_BUDGET):
    """(loss report, gradients {field: tensor}, Frame) of ``loss_fn(image)``
    for the leaves of ``p``: the image is rendered in blocks without
    autograd, the loss differentiated in the image, and each block rendered
    again under autograd and back-propagated with its slice of that
    cotangent into the projected quantities, then through the projection."""
    ts = rc["tile_size"]
    dtype = real(prec)
    leaves = {f: p[f].detach().to(dtype).requires_grad_(True) for f in FIELDS}
    q = dict(leaves, alive=p["alive"])
    with torch.enable_grad():
        pr = project(q, pose, rc, prec)
    pa = pairs(pr, pose, rc)
    groups = _group_tiles(pa, budget, ts * ts)
    held = [pr.screen, pr.conic, pr.opacity, pr.color]
    det = [x.detach().requires_grad_(True) for x in held]
    prd = pr._replace(screen=det[0], conic=det[1], opacity=det[2], color=det[3])
    tiles = torch.empty((pa.start.numel() - 1, ts * ts, 3), dtype=dtype, device=pr.depth.device)
    kept = 0
    with torch.no_grad():
        for t0, t1, longest in groups:
            blk = blend_tiles(prd, pa, pose, rc, t0, t1, longest, prec)
            tiles[t0:t1] = blk.rgb
            kept += blk.kept
    img = _tiles_to_image(tiles, ts, pose["width"], pose["height"])
    img_leaf = img.detach().requires_grad_(True)
    with torch.enable_grad():
        report = loss_fn(img_leaf)
        (d_img,) = torch.autograd.grad(report.grad_loss, img_leaf)
    d_tiles = _image_to_tiles(d_img, ts)
    with torch.enable_grad():
        for t0, t1, longest in groups:
            blk = blend_tiles(prd, pa, pose, rc, t0, t1, longest, prec)
            blk.rgb.backward(d_tiles[t0:t1])
        torch.autograd.backward(held, [d.grad if d.grad is not None else torch.zeros_like(d)
                                       for d in det])
    grads = {f: (leaves[f].grad if leaves[f].grad is not None else torch.zeros_like(leaves[f]))
             for f in FIELDS}
    frame = Frame(img, int(pa.gid.numel()), kept, pixel_tests(pr, pose), int(p["alive"].sum()))
    return report, grads, frame


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """A [0, 1] image as the frame a viewer receives: round(255 x), clamped."""
    return torch.clamp(img * 255.0 + 0.5, 0, 255).to(torch.uint8)
