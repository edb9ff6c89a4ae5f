"""What the drivers hand the system under test, and how: the port's
``Config`` from a configuration's ``config`` dict, its ``GaussianParams``
from the benchmark's arrays, its ``Camera`` from a pose.  The port is
imported here, inside functions, and nowhere in ``gsbench/reference``.
"""

from __future__ import annotations

import json


def config(cfg: dict):
    from gaussiansplatting_tpu_torch.config import Config

    return Config.from_json(json.dumps(cfg))


def params(arrays: dict):
    """A GaussianParams holding copies of the benchmark's arrays."""
    import torch

    from gaussiansplatting_tpu_torch.core.gaussians import GaussianParams

    with torch.no_grad():
        return GaussianParams(*(arrays[f].clone() for f in
                                ("means", "log_scales", "quats", "raw_opacities", "sh", "alive")))


def camera(pose: dict, device):
    from gaussiansplatting_tpu_torch.core.camera import make_camera

    return make_camera(pose["quat"], pose["t"], pose["fx"], pose["fy"], pose["cx"], pose["cy"],
                       pose["width"], pose["height"], device=device)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
