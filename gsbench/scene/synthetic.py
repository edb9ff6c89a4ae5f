"""The benchmark's synthetic scene and its cameras, made from the seed.

The scene is the port's canonical workload (``synthetic.make_scene``'s
distributions): Gaussians uniform in a box in front of the canonical camera,
log-scales uniform in [-4.6, -3], normal quaternions normalised, raw
opacities uniform in [-1, 3], DC colour coefficients uniform in [-1, 1].
It is drawn on the device with a ``torch.Generator`` seeded from the seed,
in a few large calls, so it is the benchmark's own input and never something
the port made.

A pose is a plain dict {quat (w, x, y, z), t, fx, fy, cx, cy, width,
height} of float32 values: the port builds its camera from it and the
reference its matrices.
"""

from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def make_scene(spec: dict, g: torch.Generator, device) -> dict:
    """{means, log_scales, quats, raw_opacities, sh [N, 4, 3], alive} on the
    device, float32."""
    n = int(spec["gaussians"])
    spread, zc = float(spec.get("spread", 1.0)), float(spec.get("z_center", 4.0))
    lo, hi = spec.get("log_scale_range", (-4.6, -3.0))
    u = torch.rand((n, 10), generator=g, device=device)
    means = torch.stack([(2 * u[:, 0] - 1) * spread, (2 * u[:, 1] - 1) * spread,
                         zc - 1.0 + 2.0 * u[:, 2]], -1)
    log_scales = lo + (hi - lo) * u[:, 3:6]
    quats = torch.randn((n, 4), generator=g, device=device)
    quats = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    raw_op = -1.0 + 4.0 * u[:, 6]
    sh = torch.zeros((n, 4, 3), device=device)
    sh[:, 0, :] = 2 * u[:, 7:10] - 1
    return dict(means=means.contiguous(), log_scales=log_scales.contiguous(),
                quats=quats.contiguous(), raw_opacities=raw_op.contiguous(), sh=sh,
                alive=torch.ones(n, dtype=torch.bool, device=device))


def _f32(x) -> list:
    return [float(v) for v in np.asarray(x, np.float32).ravel()]


def canonical_pose(width: int, height: int, fov_scale: float = 1.2) -> dict:
    """The identity pose looking down +z whose intrinsics frame the box."""
    f = float(np.float32(width * fov_scale))
    return dict(quat=[1.0, 0.0, 0.0, 0.0], t=[0.0, 0.0, 0.0], fx=f, fy=f,
                cx=width / 2.0, cy=height / 2.0, width=int(width), height=int(height))


def rotmat_to_quat(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z), Shepperd's method."""
    r = np.asarray(r, np.float64)
    tr = np.trace(r)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s]
    elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
        q = [(r[2, 1] - r[1, 2]) / s, 0.25 * s, (r[0, 1] + r[1, 0]) / s, (r[0, 2] + r[2, 0]) / s]
    elif r[1, 1] > r[2, 2]:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
        q = [(r[0, 2] - r[2, 0]) / s, (r[0, 1] + r[1, 0]) / s, 0.25 * s, (r[1, 2] + r[2, 1]) / s]
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
        q = [(r[1, 0] - r[0, 1]) / s, (r[0, 2] + r[2, 0]) / s, (r[1, 2] + r[2, 1]) / s, 0.25 * s]
    q = np.asarray(q)
    return q / np.linalg.norm(q)


def look_at_pose(eye, target, fx, fy, width, height, up=(0.0, -1.0, 0.0)) -> dict:
    """A pose at ``eye`` looking at ``target``: +z forward, +y down in the
    image (COLMAP's convention)."""
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    down = -up - fwd * np.dot(-up, fwd)
    down /= np.linalg.norm(down)
    right = np.cross(down, fwd)
    r = np.stack([right, down, fwd])
    q = np.asarray(rotmat_to_quat(r), np.float32)
    # the translation of the rotation the quaternion stands for
    w, x, y, z = q.astype(np.float64)
    rq = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                   [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                   [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    return dict(quat=_f32(q), t=_f32(-rq @ eye), fx=float(np.float32(fx)),
                fy=float(np.float32(fy)), cx=width / 2.0, cy=height / 2.0,
                width=int(width), height=int(height))


def orbit_poses(spec: dict, width: int, height: int, fov_scale: float = 1.2) -> list[dict]:
    """A fixed grid of poses on a sphere around the box's centre, the
    canonical camera at azimuth and elevation 0: ``orbit.azimuths`` x
    ``orbit.elevations`` (radians, evenly spaced in +/- the given range) at
    ``orbit.distance``."""
    o = spec["orbit"]
    centre = np.array([0.0, 0.0, float(spec.get("z_center", 4.0))])
    f = width * fov_scale
    poses = []
    for el in np.linspace(-o["elevation"], o["elevation"], o["elevations"]):
        for az in np.linspace(-o["azimuth"], o["azimuth"], o["azimuths"]):
            d = np.array([np.sin(az) * np.cos(el), np.sin(el), -np.cos(az) * np.cos(el)])
            poses.append(look_at_pose(centre + o["distance"] * d, centre, f, f, width, height))
    return poses


def render_inputs(cfg: dict, traffic: dict, seed: int, device):
    """(the scene's arrays, the camera path) of a render cell: the traffic's
    fixed grid of orbit poses, visited in an order drawn from the seed."""
    sc = cfg["scene"]
    arrays = make_scene(sc, generator(seed, device), device)
    poses = orbit_poses(dict(sc, orbit=traffic["orbit"]), sc["width"], sc["height"])
    order = torch.randperm(len(poses), generator=torch.Generator().manual_seed(
        int(seed) % (1 << 63))).tolist()
    return arrays, [poses[i] for i in order]
