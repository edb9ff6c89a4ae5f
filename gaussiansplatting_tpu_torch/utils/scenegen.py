"""COLMAP binary writers (the inverse of io/colmap.py's parsers), for
writing a synthetic scene that the trainer loads like a real one.

Counterpart of the writers in gaussiansplatting_tpu/utils/scenegen.py
(:335-365), byte for byte; the JAX module's procedural ray-traced scene
renderer is not ported yet (ROADMAP.md §A).
"""

from __future__ import annotations

import struct

import numpy as np


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
