"""The benchmark's frozen copy of the port's garden generator
(``utils/scenegen.py``: the scene, the ray tracer, the surface sampler and the
ring of cameras), rewritten so that every input is drawn here from the seed
and on the device: the views' ground truth (traced, then rounded to 8 bits as
the dataset's PNGs are), the SfM-like point cloud and its colours, the poses.
Nothing here imports the port.

A procedurally textured garden (ground plane, stone spheres, box
structures), Lambertian with hard sun shadows and a sky, 4-octave value-noise
textures; 200 views on two jittered rings at 800 x 608 with a 60 degree field
of view (BASELINE.md config #4).  ``initial_gaussians`` is the trainer's
initialisation of a point cloud (io/init.py's rule), ``render_inputs`` a
render cell's scene and camera path.  The tracer replays a CUDA graph of its own
on a CUDA device (one capture per run), so the 200 views take ~1 s.
"""

from __future__ import annotations

import numpy as np
import torch

SPHERES = np.array(
    [
        # cx, cy, cz, radius, palette
        [1.8, 0.45, 0.6, 0.45, 2],
        [-1.2, 0.35, 1.4, 0.35, 3],
        [0.4, 0.25, -1.6, 0.25, 2],
        [-2.1, 0.55, -0.8, 0.55, 4],
        [2.6, 0.3, -1.9, 0.3, 3],
        [-0.3, 0.2, 2.3, 0.2, 4],
        [1.0, 1.05, 1.9, 0.28, 5],
        [-1.7, 0.9, -2.4, 0.9, 5],
    ],
    np.float32,
)
BOXES = np.array(
    [
        # min xyz, max xyz, palette
        [-0.9, 0.0, -0.5, 0.9, 1.1, 0.5, 1],
        [-1.1, 1.1, -0.7, 1.1, 1.45, 0.7, 6],
        [0.7, 0.0, 1.6, 1.3, 0.8, 2.2, 1],
        [-2.9, 0.0, 1.8, -2.3, 1.3, 2.4, 6],
        [2.2, 0.0, 0.9, 3.0, 0.5, 1.7, 4],
    ],
    np.float32,
)
SUN_DIR = np.array([0.45, 0.8, 0.35], np.float32)
SUN_DIR /= np.linalg.norm(SUN_DIR)
GROUND_EXTENT = 14.0
PALETTES = np.array(
    [
        # base rgb, noise rgb amplitude, noise scale
        [0.23, 0.42, 0.16, 0.10, 0.14, 0.06, 2.6],
        [0.58, 0.34, 0.24, 0.16, 0.10, 0.08, 6.0],
        [0.46, 0.46, 0.48, 0.14, 0.14, 0.14, 4.0],
        [0.62, 0.52, 0.30, 0.12, 0.12, 0.10, 8.0],
        [0.30, 0.34, 0.52, 0.10, 0.10, 0.16, 3.2],
        [0.55, 0.16, 0.14, 0.14, 0.08, 0.06, 9.0],
        [0.42, 0.30, 0.20, 0.12, 0.10, 0.08, 5.0],
    ],
    np.float32,
)
SKY = np.array([[0.82, 0.86, 0.92], [0.35, 0.52, 0.82], [1.2, 1.1, 0.9]], np.float32)


def constants(device):
    return tuple(torch.as_tensor(a, device=device) for a in (SPHERES, BOXES, PALETTES, SUN_DIR, SKY))


def _hash3(ix, iy, iz):
    h = ix * 127.1 + iy * 311.7 + iz * 74.7
    return torch.remainder(torch.sin(h) * 43758.5453, 1.0)


def _value_noise(p):
    pi = torch.floor(p)
    pf = p - pi
    w = pf * pf * (3.0 - 2.0 * pf)
    ix, iy, iz = pi[..., 0], pi[..., 1], pi[..., 2]
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]

    def h(dx, dy, dz):
        return _hash3(ix + dx, iy + dy, iz + dz)

    x00 = h(0, 0, 0) * (1 - wx) + h(1, 0, 0) * wx
    x10 = h(0, 1, 0) * (1 - wx) + h(1, 1, 0) * wx
    x01 = h(0, 0, 1) * (1 - wx) + h(1, 0, 1) * wx
    x11 = h(0, 1, 1) * (1 - wx) + h(1, 1, 1) * wx
    y0 = x00 * (1 - wy) + x10 * wy
    y1 = x01 * (1 - wy) + x11 * wy
    return y0 * (1 - wz) + y1 * wz


def _fbm(p):
    v, amp = 0.0, 0.5
    for _ in range(4):
        v = v + amp * _value_noise(p)
        p = p * 2.03 + 11.31
        amp *= 0.5
    return v


def _texture(palettes, pal_id, p):
    row = palettes[pal_id.long()]
    base, amp, scale = row[..., 0:3], row[..., 3:6], row[..., 6:7]
    n = _fbm(p * scale)[..., None]
    n2 = _fbm(p * scale * 3.7 + 5.0)[..., None]
    return torch.clamp(base + amp * (n - 0.5) * 2.0 + amp * (n2 - 0.5) * 0.7, 0.02, 0.98)


def _intersect(spheres, boxes, origins, dirs, t_max=1e9):
    """Nearest hit over the ground plane, the spheres and the boxes:
    (t, hit, normal, palette)."""
    big = float(np.float32(t_max))
    shape = dirs.shape[:-1]
    up = torch.zeros_like(dirs)
    up[..., 1] = 1.0
    best_t = torch.full(shape, big, dtype=torch.float32, device=dirs.device)
    best_n = up
    best_pal = torch.zeros(shape, dtype=torch.int32, device=dirs.device)

    dy = dirs[..., 1]
    t_pl = torch.where(dy.abs() > 1e-6, -origins[..., 1] / dy, big)
    p_pl = origins + t_pl[..., None] * dirs
    ok_pl = ((t_pl > 1e-3) & (p_pl[..., 0].abs() < GROUND_EXTENT)
             & (p_pl[..., 2].abs() < GROUND_EXTENT))
    upd = ok_pl & (t_pl < best_t)
    best_t = torch.where(upd, t_pl, best_t)
    best_pal = torch.where(upd, 0, best_pal)
    best_n = torch.where(upd[..., None], up, best_n)

    for i in range(spheres.shape[0]):
        c, r, pal = spheres[i, 0:3], spheres[i, 3], spheres[i, 4].to(torch.int32)
        oc = origins - c
        b = (oc * dirs).sum(-1)
        disc = b * b - ((oc * oc).sum(-1) - r * r)
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0, t1 = -b - sq, -b + sq
        t_s = torch.where(t0 > 1e-3, t0, t1)
        upd = (disc > 0.0) & (t_s > 1e-3) & (t_s < best_t)
        n = (origins + t_s[..., None] * dirs - c) / r
        best_t = torch.where(upd, t_s, best_t)
        best_pal = torch.where(upd, pal, best_pal)
        best_n = torch.where(upd[..., None], n, best_n)

    inv = 1.0 / torch.where(dirs.abs() > 1e-9, dirs, 1e-9)
    sign = -torch.sign(dirs)
    for i in range(boxes.shape[0]):
        bmin, bmax, pal = boxes[i, 0:3], boxes[i, 3:6], boxes[i, 6].to(torch.int32)
        t_lo, t_hi = (bmin - origins) * inv, (bmax - origins) * inv
        t1, t2 = torch.minimum(t_lo, t_hi), torch.maximum(t_lo, t_hi)
        t_near, t_far = t1.amax(-1), t2.amin(-1)
        t_b = torch.where(t_near > 1e-3, t_near, t_far)
        upd = (t_near < t_far) & (t_far > 1e-3) & (t_b < best_t)
        axis = torch.argmax(t1, -1)
        n = torch.stack([sign[..., k] * (axis == k) for k in range(3)], -1)
        best_t = torch.where(upd, t_b, best_t)
        best_pal = torch.where(upd, pal, best_pal)
        best_n = torch.where(upd[..., None], n, best_n)
    return best_t, best_t < big * 0.5, best_n, best_pal


def _sky(dirs, sun_dir, colours):
    up = torch.clamp(dirs[..., 1], -1.0, 1.0)
    horizon, zenith, sun_rgb = colours
    t = torch.clamp(up * 0.5 + 0.5, 0.0, 1.0)[..., None]
    sun = torch.clamp((dirs * sun_dir).sum(-1), 0.0, 1.0) ** 256
    return torch.clamp(horizon * (1 - t) + zenith * t + sun[..., None] * sun_rgb, 0.0, 1.0)


def shade(points, normals, pal_id, consts):
    spheres, boxes, palettes, sun_dir, _ = consts
    alb = _texture(palettes, pal_id, points)
    ndl = torch.clamp((normals * sun_dir).sum(-1), 0.0, 1.0)
    _, s_hit, _, _ = _intersect(spheres, boxes, points + normals * 1e-3, sun_dir.expand(points.shape))
    lit = ndl * (1.0 - s_hit.to(torch.float32))
    ambient = 0.35 + 0.1 * torch.clamp(normals[..., 1], 0.0, 1.0)
    return torch.clamp(alb * (ambient + 0.85 * lit)[..., None], 0.0, 1.0)


def trace(rows, eye, fx, fy, cx, cy, width, height, consts):
    """[H, W, 3] of the view whose rotation rows and eye are ``rows``,
    ``eye`` (x_cam = R x + t, eye = -R^T t)."""
    spheres, boxes, _, sun_dir, sky = consts
    dev = rows.device
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5 - cx) / fx
    ys = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5 - cy) / fy
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    d = gx[..., None] * rows[0] + gy[..., None] * rows[1] + rows[2]
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    o = eye.expand(d.shape)
    t_hit, hit, n, pal = _intersect(spheres, boxes, o, d)
    col = shade(o + t_hit[..., None] * d, n, pal, consts)
    return torch.where(hit[..., None], col, _sky(d, sun_dir, sky))


def quat_to_rotmat_np(q) -> np.ndarray:
    w, x, y, z = np.asarray(q, np.float32)
    one, two = np.float32(1.0), np.float32(2.0)
    return np.array([[one - two * (y * y + z * z), two * (x * y - w * z), two * (x * z + w * y)],
                     [two * (x * y + w * z), one - two * (x * x + z * z), two * (y * z - w * x)],
                     [two * (x * z - w * y), two * (y * z + w * x), one - two * (x * x + y * y)]],
                    np.float32)


def ring_poses(num_views: int, rng: np.random.Generator, width: int, height: int,
               fov_deg: float = 60.0) -> list[dict]:
    """Poses on two jittered rings looking at the scene's centre, world up
    (0, 1, 0), as the dataset's cameras: {quat, t, fx, fy, cx, cy, width,
    height} in float32 values."""
    from gsbench.scene.synthetic import rotmat_to_quat

    f = float(np.float32(0.5 * width / np.tan(0.5 * np.deg2rad(fov_deg))))
    target = np.array([0.0, 0.6, 0.0], np.float32)
    poses = []
    for i in range(num_views):
        az = 2 * np.pi * i / num_views + rng.uniform(-0.02, 0.02)
        ring = i % 2
        radius = (5.2, 6.8)[ring] + rng.uniform(-0.3, 0.3)
        h = (1.4, 2.6)[ring] + rng.uniform(-0.2, 0.2)
        eye = np.array([radius * np.cos(az), h, radius * np.sin(az)], np.float32)
        tgt = target + rng.uniform(-0.08, 0.08, 3).astype(np.float32)
        fwd = tgt - eye
        fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
        down = -np.array([0.0, 1.0, 0.0], np.float32) - fwd * np.dot(
            -np.array([0.0, 1.0, 0.0], np.float32), fwd)
        down = down / np.linalg.norm(down)
        r = np.stack([np.cross(down, fwd), down, fwd]).astype(np.float32)
        q = np.asarray(rotmat_to_quat(r), np.float32)
        t = (-r @ eye).astype(np.float32)
        poses.append(dict(quat=[float(v) for v in q], t=[float(v) for v in t], fx=f, fy=f,
                          cx=width / 2.0, cy=height / 2.0, width=int(width), height=int(height)))
    return poses


def pose_rows(pose: dict, device):
    """(R's rows, the eye) of a pose as float32 tensors; R from its
    quaternion as the cameras' matrices take it."""
    r = quat_to_rotmat_np(pose["quat"])
    eye = -r.T @ np.asarray(pose["t"], np.float32)
    return torch.as_tensor(r, device=device), torch.as_tensor(eye.astype(np.float32), device=device)


class Tracer:
    """Traces views of one resolution and field of view; on a CUDA device
    one captured graph replayed per view."""

    def __init__(self, width: int, height: int, fx: float, fy: float, device):
        self.args = (fx, fy, width / 2.0, height / 2.0, width, height)
        self.device = torch.device(device)
        self.consts = constants(self.device)
        self.rows = torch.zeros((3, 3), device=self.device)
        self.eye = torch.zeros(3, device=self.device)
        self.graph = None
        if self.device.type == "cuda":
            s = torch.cuda.Stream(self.device)
            s.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(s):
                trace(self.rows, self.eye, *self.args, self.consts)
            torch.cuda.current_stream(self.device).wait_stream(s)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = trace(self.rows, self.eye, *self.args, self.consts)

    def __call__(self, pose: dict) -> torch.Tensor:
        rows, eye = pose_rows(pose, self.device)
        if self.graph is None:
            return trace(rows, eye, *self.args, self.consts)
        self.rows.copy_(rows)
        self.eye.copy_(eye)
        self.graph.replay()
        return self.out.clone()

    def close(self) -> None:
        if self.graph is not None:
            self.graph.reset()
            self.graph = self.out = None


def surface_points(n: int, g: torch.Generator, device, noise: float = 0.01):
    """An SfM-like cloud: n surface samples (a third on the ground, the rest
    on the spheres and boxes by area) with shaded colours, position noise
    N(0, noise) and colour noise N(0, 0.02).  Returns (points [n, 3], colours
    [n, 3]) float32 on the device."""
    consts = constants(device)
    spheres, boxes = consts[0], consts[1]
    n_ground = n // 3
    u = torch.rand((n_ground, 2), generator=g, device=device)
    gx = (u * 2 - 1) * (0.55 * GROUND_EXTENT)
    pts = [torch.stack([gx[:, 0], torch.zeros_like(gx[:, 0]), gx[:, 1]], -1)]
    nrm = [torch.tensor([0.0, 1.0, 0.0], device=device).expand(n_ground, 3)]
    pal = [torch.zeros(n_ground, dtype=torch.int64, device=device)]
    n_rest = n - n_ground
    area_s = 4 * np.pi * SPHERES[:, 3] ** 2
    ext = BOXES[:, 3:6] - BOXES[:, 0:3]
    area_b = 2 * (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 0] * ext[:, 2])
    areas = torch.as_tensor(np.concatenate([area_s, area_b]), dtype=torch.float32, device=device)
    which = torch.multinomial(areas / areas.sum(), n_rest, replacement=True, generator=g)
    which = torch.sort(which).values
    is_sphere = which < len(SPHERES)
    si = which[is_sphere]
    v = torch.randn((si.numel(), 3), generator=g, device=device)
    v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-9)
    pts.append(spheres[si, 0:3] + v * spheres[si, 3:4])
    nrm.append(v)
    pal.append(spheres[si, 4].long())
    bi = which[~is_sphere] - len(SPHERES)
    bmin, bmax = boxes[bi, 0:3], boxes[bi, 3:6]
    face = torch.randint(0, 6, (bi.numel(),), generator=g, device=device)
    p = bmin + torch.rand((bi.numel(), 3), generator=g, device=device) * (bmax - bmin)
    nv = torch.zeros_like(p)
    for axis in range(3):
        lo, hi = face == 2 * axis, face == 2 * axis + 1
        p[:, axis] = torch.where(lo, bmin[:, axis], torch.where(hi, bmax[:, axis], p[:, axis]))
        nv[:, axis] = torch.where(lo, -1.0, torch.where(hi, 1.0, 0.0))
    pts.append(p)
    nrm.append(nv)
    pal.append(boxes[bi, 6].long())
    pts, nrm, pal = torch.cat(pts), torch.cat(nrm), torch.cat(pal)
    cols = shade(pts, nrm, pal, consts)
    pts = pts + noise * torch.randn(pts.shape, generator=g, device=device)
    cols = torch.clamp(cols + 0.02 * torch.randn(cols.shape, generator=g, device=device), 0, 1)
    return pts, cols


SH_C0 = 0.28209479177387814   # the DC band of the spherical harmonics


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def initial_gaussians(points, colors, extent: float, init: dict, max_gaussians: int,
                      capacity_factor: float = 1.5) -> dict:
    """The port's initialisation of a point cloud (reference:
    gaussiansFromColmap, main.mm:59-187) at the adaptive capacity (the next
    power of two above 1.5 x the points, at least 2^17)."""
    n = points.shape[0]
    k = int(init.get("knn_k", 3))
    if n > int(init.get("knn_sample_threshold", 10_000)):
        step = max(n // int(init.get("knn_sample_size", 1000)), 1)
        q = points[::step].double()
        rows = max(1, (1 << 25) // n)          # queries per block: ~256 MB of distances
        dist = torch.cat([torch.cdist(q[i:i + rows], points.double(),
                                      compute_mode="donot_use_mm_for_euclid_dist")
                          .topk(k + 1, largest=False).values[:, 1:]
                          for i in range(0, q.shape[0], rows)])
        sample = torch.sort(dist.mean(1)).values
        scale = torch.full((n,), float(sample[sample.numel() // 2]), device=points.device)
    else:
        raise ValueError("the benchmark's configurations sample the 3-NN scale")
    scale = scale.clamp(init.get("min_scale_factor", 1e-4) * extent,
                        init.get("max_scale_factor", 0.1) * extent)
    cap = min(max_gaussians, max(_next_pow2(int(capacity_factor * n)), 1 << 17))
    dev = points.device
    out = dict(means=torch.zeros((cap, 3), device=dev), log_scales=torch.zeros((cap, 3), device=dev),
               quats=torch.zeros((cap, 4), device=dev), raw_opacities=torch.zeros(cap, device=dev),
               sh=torch.zeros((cap, 4, 3), device=dev),
               alive=torch.zeros(cap, dtype=torch.bool, device=dev))
    out["quats"][:, 0] = 1.0
    out["means"][:n] = points
    out["log_scales"][:n] = torch.log(scale.float())[:, None]
    out["raw_opacities"][:n] = float(init.get("init_raw_opacity", 0.0))
    out["sh"][:n, 0] = (colors - 0.5) / SH_C0
    out["alive"][:n] = True
    return out


def scene_extent(poses: list[dict], multiplier: float) -> float:
    """``multiplier`` x the largest distance of a camera from the cameras'
    centroid (colmap_loader.cpp:232-264)."""
    eyes = np.stack([pose_rows(p, "cpu")[1].numpy() for p in poses]).astype(np.float32)
    return float(np.linalg.norm(eyes - eyes.mean(0), axis=1).max() * multiplier)


def render_inputs(cfg: dict, traffic: dict, seed: int, device):
    """(the scene's arrays, the camera path) of a render cell on the garden:
    ``render.gaussians`` Gaussians on the garden's surfaces, initialised as
    the trainer initialises an SfM cloud (the traced colours, one median
    3-NN scale), seen from the dataset's held-out views and from
    ``render.ring_views`` of its other views (evenly spaced), visited in an
    order drawn from the seed."""
    sc, rd = cfg["scene"], cfg["render"]
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    poses = ring_poses(sc["views"], np.random.default_rng(seed), sc["width"], sc["height"],
                       sc.get("fov_deg", 60.0))
    held = [p for i, p in enumerate(poses) if i % sc["eval_split"] == 0]
    rest = [p for i, p in enumerate(poses) if i % sc["eval_split"]]
    ring = [rest[int(i)] for i in np.linspace(0, len(rest) - 1, rd["ring_views"])]
    path = held + ring
    extent = scene_extent(poses, cfg["config"]["init"]["extent_multiplier"])
    pts, cols = surface_points(rd["gaussians"], g, device)
    arrays = initial_gaussians(pts, cols, extent, cfg["config"]["init"], rd["gaussians"],
                               capacity_factor=1.0)
    order = torch.randperm(len(path), generator=torch.Generator().manual_seed(
        int(seed) % (1 << 63))).tolist()
    return arrays, [path[i] for i in order]
