"""Offline renderer CLI on PyTorch: renders a 3DGS PLY (or a 2D Gaussian
Splatting PLY of surfels, two scales a row) from an orbit path
around the scene or from the training cameras of a COLMAP reconstruction,
writing PNG/PPM.  Counterpart of gaussiansplatting_tpu/tools/render.py, with
the same flags plus ``--device``.

Usage:
  python -m gaussiansplatting_tpu_torch.tools.render --ply model.ply \
      --output out/ [--orbit N | --colmap sparse/0] [--width 800 --height 600] \
      [--fov 60] [--device cuda]

``--device cuda`` (the default) raises if CUDA is unavailable; the CPU runs
only when asked for with ``--device cpu``.  On the card every frame replays
the render's CUDA graph (train/graph.render_frame, the counterpart of the
JAX tool's ``jax.jit(render)``); the launch count it logs includes the
capture's eager warm-up frame.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ply", required=True, help="3DGS PLY to render")
    p.add_argument("--output", required=True, help="output directory")
    p.add_argument("--orbit", type=int, default=0, help="render N orbit views")
    p.add_argument("--colmap", default=None, help="render from COLMAP training cameras")
    p.add_argument("--width", type=int, default=None,
                   help="render width (default: 800 for orbit, native camera size for --colmap)")
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--fov", type=float, default=60.0, help="vertical FoV degrees (orbit)")
    p.add_argument("--elevation", type=float, default=15.0, help="orbit elevation degrees")
    p.add_argument("--radius-scale", type=float, default=1.0)
    p.add_argument("--format", choices=("png", "ppm"), default="png")
    p.add_argument("--gif", default=None,
                   help="additionally write all views as an animated GIF")
    p.add_argument("--pair-capacity", type=int, default=1 << 21)
    p.add_argument("--sh-degree", type=int, default=0, choices=(0, 1, 2, 3),
                   help="0 = reference parity (DC only); 1-3 = view-dependent color "
                        "(3: a 3DGS .ply's 16 coefficients)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; no fallback)")
    return p


def _device(name: str):
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"error: --device {name} requested but CUDA is not available "
            "(pass --device cpu to render on the CPU)"
        )
    return dev


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not os.path.exists(args.ply):
        raise SystemExit(f"error: PLY not found: {args.ply}")
    if args.colmap and not os.path.isdir(args.colmap):
        raise SystemExit(f"error: COLMAP dir not found: {args.colmap}")

    from gaussiansplatting_tpu_torch.config import Config, RasterConfig
    from gaussiansplatting_tpu_torch.core import camera as camera_mod
    from gaussiansplatting_tpu_torch.core import gaussians as gaussians_mod
    from gaussiansplatting_tpu_torch.io import images as images_mod
    from gaussiansplatting_tpu_torch.io import ply as ply_mod
    from gaussiansplatting_tpu_torch.train.graph import render_frame
    from gaussiansplatting_tpu_torch.utils import tracing
    from gaussiansplatting_tpu_torch.utils.metrics import MetricsLogger

    device = _device(args.device)
    log = MetricsLogger()

    cloud = ply_mod.load_gaussian_ply(args.ply)
    params = gaussians_mod.from_arrays(
        cloud.means, cloud.log_scales, cloud.quats, cloud.raw_opacities, cloud.sh,
        device=device,
    )
    # a PLY of two scales a row holds surfels (2D Gaussian Splatting's)
    cfg = Config(
        raster=RasterConfig(
            pair_capacity=args.pair_capacity, sh_degree=args.sh_degree,
            primitive=gaussians_mod.primitive_of(params),
        )
    )
    log.log("load", n_gaussians=cloud.means.shape[0], ply=args.ply,
            device=str(device))

    os.makedirs(args.output, exist_ok=True)

    cameras = []
    names = []
    if args.colmap:
        from gaussiansplatting_tpu_torch.io import colmap as colmap_mod

        data = colmap_mod.load_colmap(args.colmap)
        for im in data.images:
            cam_info = data.cameras[im.camera_id]
            # default: native COLMAP resolution
            cameras.append(
                camera_mod.make_camera(
                    im.quat_wxyz,
                    im.translation,
                    cam_info.fx,
                    cam_info.fy,
                    cam_info.cx,
                    cam_info.cy,
                    cam_info.width,
                    cam_info.height,
                    render_width=args.width or cam_info.width,
                    render_height=args.height or cam_info.height,
                    device=device,
                )
            )
            names.append(os.path.splitext(im.name)[0])
    else:
        if args.width is None:
            args.width = 800
        if args.height is None:
            args.height = 600
        n_views = args.orbit if args.orbit > 0 else 8
        center = cloud.means.mean(axis=0)
        spread = float(np.percentile(np.linalg.norm(cloud.means - center, axis=1), 90))
        radius = max(spread * 2.5, 1e-3) * args.radius_scale
        fy = args.height / (2.0 * math.tan(math.radians(args.fov) / 2.0))
        for i in range(n_views):
            cameras.append(
                camera_mod.orbit_camera(
                    center,
                    radius,
                    azimuth=2.0 * math.pi * i / n_views,
                    elevation=math.radians(args.elevation),
                    fx=fy,
                    fy=fy,
                    width=args.width,
                    height=args.height,
                    device=device,
                )
            )
            names.append(f"orbit_{i:03d}")

    launches0 = tracing.launch_counts()["windowed_blend_fwd"]
    t0 = time.time()
    frames = []
    for cam, name in zip(cameras, names):
        img, aux = render_frame(params, cam, cfg.raster)
        img = img.cpu().numpy()
        path = os.path.join(args.output, f"{name}.{args.format}")
        if args.format == "png":
            images_mod.save_png(path, img)
        else:
            images_mod.save_ppm(path, img)
        if args.gif:
            frames.append(img)
        log.log("render", view=name, num_pairs=int(aux.num_pairs),
                overflow=bool(aux.overflow), path=path)
    if args.gif and frames:
        from PIL import Image

        pil = [
            Image.fromarray(
                np.clip(f * 255.0 + 0.5, 0, 255).astype(np.uint8)
            )
            for f in frames
        ]
        pil[0].save(
            args.gif, save_all=True, append_images=pil[1:], duration=100, loop=0
        )
        log.log("gif", path=args.gif, frames=len(pil))
    dt = time.time() - t0
    log.log("done", views=len(cameras), seconds=round(dt, 2),
            views_per_sec=round(len(cameras) / max(dt, 1e-9), 3),
            blend_kernel_launches=tracing.launch_counts()["windowed_blend_fwd"] - launches0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
