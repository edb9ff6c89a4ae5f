"""The reference against a float64 loop over every pixel and every Gaussian,
written here one scalar at a time, at a tiny size."""

import math

import numpy as np
import torch

from gsbench.reference import raster
from gsbench.scene import synthetic

SH_C0 = 0.28209479177387814


def _loop(arrays, pose, rc):
    a = {k: v.double().numpy() for k, v in arrays.items()}
    w, h, ts = pose["width"], pose["height"], 16
    view, viewproj = (m.numpy() for m in raster.camera_matrices(pose, torch.float64, "cpu"))
    fx, fy = pose["fx"], pose["fy"]
    proj = []
    for i in range(len(a["means"])):
        homo = np.append(a["means"][i], 1.0)
        vp, cl = view @ homo, viewproj @ homo
        if cl[3] <= 0.1 or vp[2] <= 0.1:
            continue
        ndc = cl[:2] / cl[3]
        if abs(ndc[0]) > 1.2 or abs(ndc[1]) > 1.2:
            continue
        sx, sy = (ndc[0] * 0.5 + 0.5) * w, (ndc[1] * 0.5 + 0.5) * h
        s = np.exp(np.clip(a["log_scales"][i], -5, 5))
        if s.max() > 20 * s.min():
            s = s * (20 * s.min() / s.max())
        q = a["quats"][i] / np.linalg.norm(a["quats"][i])
        r = raster.quat_to_rotmat(torch.tensor(q)).numpy()
        m = r @ np.diag(s)
        z = vp[2]
        tx = np.clip(vp[0] / z, -1.3 * fx / z, 1.3 * fx / z)
        ty = np.clip(vp[1] / z, -1.3 * fy / z, 1.3 * fy / z)
        j = np.array([[fx / z, 0, -fx * tx / z], [0, fy / z, -fy * ty / z]]) @ view[:3, :3]
        cov = j @ m @ m.T @ j.T
        ca, cb, cc = cov[0, 0] + 0.3, cov[0, 1], cov[1, 1] + 0.3
        det = ca * cc - cb * cb
        if det < 1e-4:
            continue
        mid = 0.5 * (ca + cc)
        rad = min(math.ceil(3 * math.sqrt(mid + math.sqrt(max(0.1, mid * mid - det)))), 512)
        x0, y0 = max(0, int(sx - rad)), max(0, int(sy - rad))
        x1, y1 = min(w - 1, int(sx + rad)), min(h - 1, int(sy + rad))
        if x0 > x1 or y0 > y1:
            continue
        span = (min(x1 // ts, -(-w // ts) - 1) - x0 // ts + 1) * (min(y1 // ts, -(-h // ts) - 1) - y0 // ts + 1)
        op = 1 / (1 + math.exp(-np.clip(a["raw_opacities"][i], -8, 8)))
        if span > 256 or op < 0.005:
            continue
        col = np.clip(SH_C0 * a["sh"][i, 0] + 0.5, 0, 1)
        proj.append((z, i, sx, sy, cc / det, -cb / det, ca / det, op, col))
    proj.sort(key=lambda p: (p[0], p[1]))
    img = np.ones((h, w, 3))
    for py in range(h):
        for px in range(w):
            c, t = np.zeros(3), 1.0
            for _, _, sx, sy, A, B, C, op, col in proj:
                dx, dy = px + 0.5 - sx, py + 0.5 - sy
                power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
                if power > 0 or power < -4.5:
                    continue
                alpha = min(op * math.exp(power), 0.99)
                if alpha < 1 / 255:
                    continue
                c += col * alpha * t
                t *= 1 - alpha
            img[py, px] = c + t
    return img


def test_reference_frame_matches_a_float64_loop():
    g = synthetic.generator(7, "cpu")
    arrays = synthetic.make_scene({"gaussians": 60, "spread": 0.5}, g, "cpu")
    pose = synthetic.look_at_pose([0.4, -0.3, 0.2], [0.0, 0.0, 4.0], 38.4, 38.4, 32, 24)
    rc = raster.raster_constants({})
    got = raster.render(arrays, pose, rc).image.numpy()
    assert np.abs(got - _loop(arrays, pose, rc)).max() < 1e-9
