"""Photoreal-ish synthetic COLMAP dataset generator: a procedurally textured
"garden" (ground plane, stone spheres, box structures) ray-traced with soft
sky + sun lighting into N posed views, an SfM-like noisy surface point
cloud, and the COLMAP binary files (cameras.bin / images.bin /
points3D.bin) that io/colmap.py reads.

Counterpart of gaussiansplatting_tpu/utils/scenegen.py: the renderer and
the dataset (``_scene_arrays`` .. ``sample_surface_points``,
``camera_ring_poses``, ``generate_dataset``) on torch tensors on an explicit
``device``, and the writers byte for byte.  Lambertian, hard shadows, no
bounces, 4-octave value-noise textures.

The texture hash is ill-conditioned: ``_hash3`` takes ``mod(sin(h) *
43758.5453, 1)`` of a float32 ``h`` that reaches ~1e6, so one ulp of ``sin``
becomes ~2^-8 in the hash, and torch's ``sin`` on either device is not
JAX's.  A colour matches the JAX functions evaluated op by op to ~2e-3 per
channel (the texture amplitudes, at most 0.16 times 2.7 for the two fbm
terms, times the light, at most 1.2), not bit for bit; where ``sin(h) *
43758.5453`` lands within that of an integer, the hash wraps from ~1 to ~0
(a few in 1e5 lattice points).  The surface positions, drawn with numpy
alone, match exactly.  The JAX renderer runs under jax.jit, whose rounding
of ``h`` is XLA's (see ``_hash3``).

The tracer (``trace``) takes the pose as tensors, as JAX's
``_render_view_jit`` takes it as arguments: on a CUDA device
``render_view_tensor`` replays it captured as a CUDA graph, once per
resolution, intrinsics and device (train/graph.run_trace), with the scene's
constants made before the capture; on the CPU it runs op by op
(``render_view_tensor_eager``).  A graph fuses no ops, so a replay rounds
``h`` as the eager ops do, bit for bit.
"""

from __future__ import annotations

import itertools
import os
import struct
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gaussiansplatting_tpu_torch.train import graph

# ---------------------------------------------------------------------------
# scene description (world units ~metres, y up)
# ---------------------------------------------------------------------------

SPHERES = np.array(
    [
        # cx, cy, cz, radius, palette
        [1.8, 0.45, 0.6, 0.45, 2],
        [-1.2, 0.35, 1.4, 0.35, 3],
        [0.4, 0.25, -1.6, 0.25, 2],
        [-2.1, 0.55, -0.8, 0.55, 4],
        [2.6, 0.3, -1.9, 0.3, 3],
        [-0.3, 0.2, 2.3, 0.2, 4],
        [1.0, 1.05, 1.9, 0.28, 5],   # "fruit" on the hedge
        [-1.7, 0.9, -2.4, 0.9, 5],   # bush
    ],
    np.float32,
)

BOXES = np.array(
    [
        # min xyz, max xyz, palette
        [-0.9, 0.0, -0.5, 0.9, 1.1, 0.5, 1],    # house core
        [-1.1, 1.1, -0.7, 1.1, 1.45, 0.7, 6],   # roof slab
        [0.7, 0.0, 1.6, 1.3, 0.8, 2.2, 1],      # hedge block
        [-2.9, 0.0, 1.8, -2.3, 1.3, 2.4, 6],    # pillar
        [2.2, 0.0, 0.9, 3.0, 0.5, 1.7, 4],      # low wall
    ],
    np.float32,
)

SUN_DIR = np.array([0.45, 0.8, 0.35], np.float32)
SUN_DIR /= np.linalg.norm(SUN_DIR)
GROUND_EXTENT = 14.0
# generate_dataset's PNG writer threads
PNG_WRITERS = 8

_PALETTES = np.array(
    [
        # base rgb, noise rgb amplitude, noise scale
        [0.23, 0.42, 0.16, 0.10, 0.14, 0.06, 2.6],   # 0 grass
        [0.58, 0.34, 0.24, 0.16, 0.10, 0.08, 6.0],   # 1 brick
        [0.46, 0.46, 0.48, 0.14, 0.14, 0.14, 4.0],   # 2 stone
        [0.62, 0.52, 0.30, 0.12, 0.12, 0.10, 8.0],   # 3 sand
        [0.30, 0.34, 0.52, 0.10, 0.10, 0.16, 3.2],   # 4 slate blue
        [0.55, 0.16, 0.14, 0.14, 0.08, 0.06, 9.0],   # 5 berry red
        [0.42, 0.30, 0.20, 0.12, 0.10, 0.08, 5.0],   # 6 wood
    ],
    np.float32,
)


# the sky's horizon, zenith and sun colours
_SKY = np.array([[0.82, 0.86, 0.92], [0.35, 0.52, 0.82], [1.2, 1.1, 0.9]], np.float32)


def _scene_arrays(device=None):
    """(spheres, boxes, palettes, sun_dir) as float32 tensors on ``device``."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in (SPHERES, BOXES, _PALETTES, SUN_DIR))


def scene_constants(device=None):
    """The tracer's constants on ``device``: _scene_arrays and the sky's
    colours [3, 3]."""
    return _scene_arrays(device) + (torch.as_tensor(_SKY, device=device),)


def _hash3(ix, iy, iz):
    """mod(sin(h) * 43758.5453, 1) of h = 127.1 ix + 311.7 iy + 74.7 iz,
    each product and sum rounded on its own, as the source states it.

    h reaches ~1e6, where one float32 ulp of h moves the hash anywhere.
    Under jax.jit, XLA's CPU backend contracts h into FMAs in a way that
    depends on the fusion around it (alone: fma(iz, 74.7, fma(ix, 127.1,
    iy * 311.7)); inside _value_noise: not at all; inside the renderer:
    neither form throughout), so the JAX renderer's jitted hash is a
    compiler's choice; the tests hold the port to the JAX functions
    evaluated op by op (jax.disable_jit)."""
    h = ix * 127.1 + iy * 311.7 + iz * 74.7
    return torch.remainder(torch.sin(h) * 43758.5453, 1.0)


def _value_noise(p):
    """Trilinear value noise in [0,1] over the integer lattice."""
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
    v = 0.0
    amp = 0.5
    for _ in range(4):
        v = v + amp * _value_noise(p)
        p = p * 2.03 + 11.31
        amp *= 0.5
    return v


def _texture(palettes, pal_id, p):
    """Albedo at world point p for palette pal_id ([..., 3])."""
    row = palettes[pal_id.long()]
    base = row[..., 0:3]
    amp = row[..., 3:6]
    scale = row[..., 6:7]
    n = _fbm(p * scale)[..., None]
    n2 = _fbm(p * scale * 3.7 + 5.0)[..., None]
    alb = base + amp * (n - 0.5) * 2.0 + amp * (n2 - 0.5) * 0.7
    return torch.clamp(alb, 0.02, 0.98)


def _intersect(spheres, boxes, origins, dirs, t_max=1e9):
    """Nearest hit over plane / spheres / boxes.

    Returns (t, hit_mask, normal, pal_id).  origins/dirs [..., 3]."""
    big = float(np.float32(t_max))
    shape = dirs.shape[:-1]
    up = torch.zeros_like(dirs)
    up[..., 1] = 1.0
    best_t = torch.full(shape, big, dtype=torch.float32, device=dirs.device)
    best_n = up
    best_pal = torch.zeros(shape, dtype=torch.int32, device=dirs.device)

    # ground plane y=0 (finite square)
    dy = dirs[..., 1]
    t_pl = torch.where(dy.abs() > 1e-6, -origins[..., 1] / dy, big)
    p_pl = origins + t_pl[..., None] * dirs
    ok_pl = ((t_pl > 1e-3) & (p_pl[..., 0].abs() < GROUND_EXTENT)
             & (p_pl[..., 2].abs() < GROUND_EXTENT))
    upd = ok_pl & (t_pl < best_t)
    best_t = torch.where(upd, t_pl, best_t)
    best_pal = torch.where(upd, 0, best_pal)
    best_n = torch.where(upd[..., None], up, best_n)

    # spheres
    for i in range(spheres.shape[0]):
        c = spheres[i, 0:3]
        r = spheres[i, 3]
        pal = spheres[i, 4].to(torch.int32)
        oc = origins - c
        b = (oc * dirs).sum(-1)
        cc = (oc * oc).sum(-1) - r * r
        disc = b * b - cc
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0 = -b - sq
        t1 = -b + sq
        t_s = torch.where(t0 > 1e-3, t0, t1)
        ok = (disc > 0.0) & (t_s > 1e-3)
        upd = ok & (t_s < best_t)
        p = origins + t_s[..., None] * dirs
        n = (p - c) / r
        best_t = torch.where(upd, t_s, best_t)
        best_pal = torch.where(upd, pal, best_pal)
        best_n = torch.where(upd[..., None], n, best_n)

    # axis-aligned boxes (slab test)
    inv = 1.0 / torch.where(dirs.abs() > 1e-9, dirs, 1e-9)
    sign = -torch.sign(dirs)
    for i in range(boxes.shape[0]):
        bmin = boxes[i, 0:3]
        bmax = boxes[i, 3:6]
        pal = boxes[i, 6].to(torch.int32)
        t_lo = (bmin - origins) * inv
        t_hi = (bmax - origins) * inv
        t1 = torch.minimum(t_lo, t_hi)
        t2 = torch.maximum(t_lo, t_hi)
        t_near = t1.amax(-1)
        t_far = t2.amin(-1)
        ok = (t_near < t_far) & (t_far > 1e-3)
        t_b = torch.where(t_near > 1e-3, t_near, t_far)
        upd = ok & (t_b < best_t)
        # normal: axis of the entering slab (argmax takes the first maximum,
        # as jnp.argmax does)
        axis = torch.argmax(t1, -1)
        n = torch.stack([sign[..., k] * (axis == k) for k in range(3)], -1)
        best_t = torch.where(upd, t_b, best_t)
        best_pal = torch.where(upd, pal, best_pal)
        best_n = torch.where(upd[..., None], n, best_n)

    hit = best_t < big * 0.5
    return best_t, hit, best_n, best_pal


def _sky(dirs, sun_dir, colours):
    """The sky's colour along ``dirs``; ``colours``: _SKY on their device."""
    up = torch.clamp(dirs[..., 1], -1.0, 1.0)
    horizon, zenith, sun_rgb = colours
    t = torch.clamp(up * 0.5 + 0.5, 0.0, 1.0)[..., None]
    sky = horizon * (1 - t) + zenith * t
    sun = torch.clamp((dirs * sun_dir).sum(-1), 0.0, 1.0) ** 256
    return torch.clamp(sky + sun[..., None] * sun_rgb, 0.0, 1.0)


def shade(points, normals, pal_id, spheres, boxes, palettes, sun_dir):
    alb = _texture(palettes, pal_id, points)
    ndl = torch.clamp((normals * sun_dir).sum(-1), 0.0, 1.0)
    # hard shadow ray
    s_org = points + normals * 1e-3
    s_dir = sun_dir.expand(points.shape)
    _, s_hit, _, _ = _intersect(spheres, boxes, s_org, s_dir)
    lit = ndl * (1.0 - s_hit.to(torch.float32))
    ambient = 0.35 + 0.1 * torch.clamp(normals[..., 1], 0.0, 1.0)
    return torch.clamp(alb * (ambient + 0.85 * lit)[..., None], 0.0, 1.0)


def pose_tensors(R, t, device=None):
    """(R's rows [3, 3], the eye -R^T t [3]) of a COLMAP pose (x_cam = R x +
    t) as float32 tensors on ``device``; the eye is computed on the host in
    float32."""
    R = np.asarray(R, np.float32)
    return (torch.as_tensor(R, device=device),
            torch.as_tensor(-R.T @ np.asarray(t, np.float32), device=device))


def _rays(rows, eye, fx, fy, cx, cy, width, height):
    """(origins, unit directions) [H, W, 3] of the pixel centres on the
    pose tensors' device.  The rotation d_cam @ R is written out as three
    products, so no matmul (and no TF32) touches it."""
    device = rows.device
    xs = (torch.arange(width, dtype=torch.float32, device=device) + 0.5 - cx) / fx
    ys = (torch.arange(height, dtype=torch.float32, device=device) + 0.5 - cy) / fy
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    d_world = gx[..., None] * rows[0] + gy[..., None] * rows[1] + rows[2]
    d_world = d_world / torch.linalg.vector_norm(d_world, dim=-1, keepdim=True)
    return eye.expand(d_world.shape), d_world


def camera_rays(R, t, fx, fy, cx, cy, width, height, device=None):
    """(origins, unit directions) [H, W, 3] of the pixel centres of a
    COLMAP-posed pinhole view (x_cam = R x + t) on ``device``."""
    return _rays(*pose_tensors(R, t, device), fx, fy, cx, cy, width, height)


def texture_lattice(points, pal_id):
    """[..., 64, 3] the integer lattice points whose hashes _texture reads
    at ``points`` (2 fbm x 4 octaves x 8 corners), by the same float32
    operations: where two evaluations of the hash differ by ~1 (a wrap),
    the texture near that lattice point differs by up to its amplitude."""
    palettes = torch.as_tensor(_PALETTES, device=points.device)
    scale = palettes[pal_id.long()][..., 6:7]
    corners = torch.tensor(list(itertools.product((0.0, 1.0), repeat=3)), device=points.device)
    out = []
    for q in (points * scale, points * scale * 3.7 + 5.0):
        for _ in range(4):
            out.append(torch.floor(q)[..., None, :] + corners)
            q = q * 2.03 + 11.31
    return torch.cat(out, -2)


def shading_flags(points, normals, pal_id):
    """The discrete decisions a surface colour rests on, on the points'
    device: each point's shadow-ray hit [...] and the hashes its texture
    reads [..., 64] (texture_lattice).  Two evaluations of the shading whose
    shadow flags differ, or whose hashes differ by ~1 (a wrap), may differ
    in colour by up to the light or the texture amplitude; elsewhere only
    by the hash's rounding (~2e-3)."""
    spheres, boxes, _, sun_dir = _scene_arrays(points.device)
    s_hit = _intersect(spheres, boxes, points + normals * 1e-3, sun_dir.expand(points.shape))[1]
    return s_hit, _hash3(*texture_lattice(points, pal_id).unbind(-1))


def trace(rows, eye, fx, fy, cx, cy, width, height, constants) -> torch.Tensor:
    """Ray-trace one view from its pose tensors (pose_tensors) with the
    scene's ``constants`` (scene_constants), all on one device; returns
    [H, W, 3] float32 in [0, 1] there.  The body of JAX's
    ``_render_view_jit``: what train/graph.run_trace captures and
    render_view_tensor_eager runs; it makes no tensor from host data."""
    spheres, boxes, palettes, sun_dir, sky_colours = constants
    origins, d_world = _rays(rows, eye, fx, fy, cx, cy, width, height)
    t_hit, hit, n, pal = _intersect(spheres, boxes, origins, d_world)
    p = origins + t_hit[..., None] * d_world
    col = shade(p, n, pal, spheres, boxes, palettes, sun_dir)
    sky = _sky(d_world, sun_dir, sky_colours)
    return torch.where(hit[..., None], col, sky)


def render_view_tensor_eager(R, t, fx, fy, cx, cy, width, height,
                             device=None) -> torch.Tensor:
    """render_view_tensor run op by op: the CPU's, and the yardstick of the
    captured one on the card."""
    return trace(*pose_tensors(R, t, device), fx, fy, cx, cy, width, height,
                 scene_constants(device))


def render_view_tensor(R, t, fx, fy, cx, cy, width, height, device=None) -> torch.Tensor:
    """Ray-trace one COLMAP-posed view (x_cam = R x + t) on ``device``;
    returns [H, W, 3] float32 in [0, 1] there.  On a CUDA device a replay
    of ``trace``'s CUDA graph (captured at the first view of this
    resolution and intrinsics; the pose copied in, the image cloned out);
    on the CPU, render_view_tensor_eager."""
    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda":
        return render_view_tensor_eager(R, t, fx, fy, cx, cy, width, height, device)
    rows, eye = pose_tensors(R, t)
    return graph.run_trace(trace, rows, eye, fx, fy, cx, cy, width, height, device,
                           scene_constants)


def render_view(R: np.ndarray, t: np.ndarray, fx: float, fy: float,
                cx: float, cy: float, width: int, height: int,
                device=None) -> np.ndarray:
    """Ray-trace one COLMAP-posed view (x_cam = R x + t) on ``device``;
    returns [H, W, 3] float32 in [0, 1] as a host array."""
    return render_view_tensor(R, t, fx, fy, cx, cy, width, height, device).cpu().numpy()


def surface_samples(n: int, rng):
    """The noiseless surface points [n, 3], normals [n, 3] (float32) and
    palettes [n] (int64) that sample_surface_points draws from ``rng``: a
    third on the ground, the rest on the spheres and boxes by area."""
    pts, nrm, pal = [], [], []

    n_ground = n // 3
    g = rng.uniform(-0.55 * GROUND_EXTENT, 0.55 * GROUND_EXTENT, (n_ground, 2))
    pts.append(np.stack([g[:, 0], np.zeros(n_ground), g[:, 1]], axis=1))
    nrm.append(np.tile([0.0, 1.0, 0.0], (n_ground, 1)))
    pal.append(np.zeros(n_ground, np.int64))

    n_rest = n - n_ground
    area_s = 4 * np.pi * SPHERES[:, 3] ** 2
    ext = BOXES[:, 3:6] - BOXES[:, 0:3]
    area_b = 2 * (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 0] * ext[:, 2])
    areas = np.concatenate([area_s, area_b])
    counts = rng.multinomial(n_rest, areas / areas.sum())
    for i, cnt in enumerate(counts[: len(SPHERES)]):
        v = rng.standard_normal((cnt, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
        pts.append(SPHERES[i, 0:3] + v * SPHERES[i, 3])
        nrm.append(v)
        pal.append(np.full(cnt, int(SPHERES[i, 4]), np.int64))
    for i, cnt in enumerate(counts[len(SPHERES):]):
        bmin, bmax = BOXES[i, 0:3], BOXES[i, 3:6]
        face = rng.integers(0, 6, cnt)
        u = rng.uniform(0, 1, (cnt, 3))
        p = bmin + u * (bmax - bmin)
        nv = np.zeros((cnt, 3), np.float32)
        for axis in range(3):
            lo = face == 2 * axis
            hi = face == 2 * axis + 1
            p[lo, axis] = bmin[axis]
            p[hi, axis] = bmax[axis]
            nv[lo, axis] = -1.0
            nv[hi, axis] = 1.0
        pts.append(p)
        nrm.append(nv)
        pal.append(np.full(cnt, int(BOXES[i, 6]), np.int64))

    return (np.concatenate(pts).astype(np.float32), np.concatenate(nrm).astype(np.float32),
            np.concatenate(pal))


def sample_surface_points(n: int, seed: int = 0, noise: float = 0.01, device=None):
    """SfM-like sparse cloud: surface samples with shaded colors + position
    noise, weighted toward textured geometry like real feature matching.
    The draws are numpy's alone (the JAX package's, bit for bit); the
    colours are shaded on ``device``."""
    rng = np.random.default_rng(seed)
    spheres, boxes, palettes, sun_dir = _scene_arrays(device)
    pts, nrm, pal = surface_samples(n, rng)
    cols = shade(torch.as_tensor(pts, device=device), torch.as_tensor(nrm, device=device),
                 torch.as_tensor(pal, device=device), spheres, boxes, palettes,
                 sun_dir).cpu().numpy()
    pts = pts + rng.normal(0, noise, pts.shape).astype(np.float32)
    cols = np.clip(
        cols + rng.normal(0, 0.02, cols.shape).astype(np.float32), 0, 1
    )
    return pts, cols


# ---------------------------------------------------------------------------
# COLMAP binary writers (inverse of io/colmap.py parsers), byte for byte the
# JAX package's
# ---------------------------------------------------------------------------

def write_cameras_bin(path: str, fx, fy, cx, cy, width, height) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<Ii", 1, 1))  # camera 1, model 1 = PINHOLE fx fy cx cy
        f.write(struct.pack("<QQ", width, height))
        f.write(struct.pack("<4d", fx, fy, cx, cy))


def write_images_bin(path: str, poses: list[tuple[np.ndarray, np.ndarray, str]]) -> None:
    """poses: [(quat_wxyz, translation, image_name)] with x_cam = R x + t."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(poses)))
        for i, (q, t, name) in enumerate(poses):
            f.write(struct.pack("<I", i + 1))
            f.write(struct.pack("<7d", *[float(v) for v in q], *[float(v) for v in t]))
            f.write(struct.pack("<I", 1))
            f.write(name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))  # no 2D points


# one points3D.bin record with an empty track: id, xyz, rgb, error, track length
_POINT_RECORD = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                          ("error", "<f8"), ("track", "<u8")])


def write_points_bin(path: str, positions: np.ndarray, colors: np.ndarray) -> None:
    """Colours are floats in [0, 1]; every point gets error 0.5 and an
    empty track."""
    positions = np.asarray(positions, np.float64)
    rec = np.zeros(len(positions), _POINT_RECORD)
    rec["id"] = np.arange(1, len(positions) + 1)
    rec["xyz"] = positions
    rec["rgb"] = np.clip(np.asarray(colors) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    rec["error"] = 0.5
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(positions)))
        f.write(rec.tobytes())


def camera_ring_poses(num_views: int, seed: int = 0):
    """Camera poses on two jittered rings looking at the scene center,
    world up (0, 1, 0).  Returns [(quat_wxyz, t, name)]."""
    from gaussiansplatting_tpu_torch.core.camera import look_at_view, rotmat_to_quat_wxyz

    rng = np.random.default_rng(seed)
    poses = []
    target = np.array([0.0, 0.6, 0.0], np.float32)
    for i in range(num_views):
        az = 2 * np.pi * i / num_views + rng.uniform(-0.02, 0.02)
        ring = i % 2
        radius = (5.2, 6.8)[ring] + rng.uniform(-0.3, 0.3)
        h = (1.4, 2.6)[ring] + rng.uniform(-0.2, 0.2)
        eye = np.array(
            [radius * np.cos(az), h, radius * np.sin(az)], np.float32
        )
        tgt = target + rng.uniform(-0.08, 0.08, 3).astype(np.float32)
        R, t = look_at_view(eye, tgt, up=(0.0, 1.0, 0.0))
        q = rotmat_to_quat_wxyz(R)
        poses.append((q, t, f"view_{i:04d}.png"))
    return poses


def generate_dataset(
    out_dir: str,
    num_views: int = 200,
    width: int = 800,
    height: int = 608,
    num_points: int = 150_000,
    seed: int = 0,
    fov_deg: float = 60.0,
    log=print,
    device=None,
) -> dict:
    """Write <out_dir>/images/*.png and <out_dir>/sparse/0/*.bin, ray-traced
    on ``device``.  Returns the times: ``render_ms_per_view`` (CUDA events
    around each view's trace on a CUDA device, the host clock on the CPU),
    ``png_s`` (writing the PNGs, summed over the PNG_WRITERS threads that
    write them while the next views trace), ``views_s`` (tracing and
    writing every view), ``points_s`` (the point cloud and the three .bin
    files) and ``total_s`` (host clock)."""
    from gaussiansplatting_tpu_torch.core.camera import quat_to_rotmat_np
    from gaussiansplatting_tpu_torch.io.images import save_png

    t_start = time.perf_counter()
    device = torch.device("cpu" if device is None else device)
    img_dir = os.path.join(out_dir, "images")
    sparse_dir = os.path.join(out_dir, "sparse", "0")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(sparse_dir, exist_ok=True)

    fx = fy = 0.5 * width / np.tan(0.5 * np.deg2rad(fov_deg))
    cx, cy = width / 2.0, height / 2.0

    poses = camera_ring_poses(num_views, seed=seed)

    def write(path, img):
        t0 = time.perf_counter()
        save_png(path, img)
        return time.perf_counter() - t0

    # the PNGs are written by a thread pool while the next views trace (PIL
    # encodes without the interpreter lock)
    render_ms, written = 0.0, []
    t_views = time.perf_counter()
    with ThreadPoolExecutor(max_workers=PNG_WRITERS) as pool:
        for i, (q, t, name) in enumerate(poses):
            R = quat_to_rotmat_np(q)
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                img = render_view_tensor(R, t, fx, fy, cx, cy, width, height, device)
                end.record()
                img = img.cpu().numpy()                 # synchronizes
                render_ms += start.elapsed_time(end)
            else:
                t0 = time.perf_counter()
                img = render_view(R, t, fx, fy, cx, cy, width, height, device)
                render_ms += 1e3 * (time.perf_counter() - t0)
            written.append(pool.submit(write, os.path.join(img_dir, name), img))
            if (i + 1) % 25 == 0:
                log(f"rendered {i + 1}/{num_views} views")
        png_s = sum(f.result() for f in written)
    views_s = time.perf_counter() - t_views

    t0 = time.perf_counter()
    pts, cols = sample_surface_points(num_points, seed=seed + 1, device=device)
    write_cameras_bin(os.path.join(sparse_dir, "cameras.bin"), fx, fy, cx, cy, width, height)
    write_images_bin(os.path.join(sparse_dir, "images.bin"), poses)
    write_points_bin(os.path.join(sparse_dir, "points3D.bin"), pts, cols)
    points_s = time.perf_counter() - t0
    log(f"dataset at {out_dir}: {num_views} views {width}x{height}, "
        f"{len(pts)} SfM points")
    return {"render_ms_per_view": render_ms / max(num_views, 1), "png_s": png_s,
            "views_s": views_s, "points_s": points_s,
            "total_s": time.perf_counter() - t_start}
