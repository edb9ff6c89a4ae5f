"""Evaluation CLI on PyTorch: render a trained model from its training
cameras and score PSNR / SSIM / L1 against the ground-truth images.
Counterpart of gaussiansplatting_tpu/tools/evaluate.py with the same flags
plus ``--device``; the trainer's companion (the reference has no
quantitative evaluation, SURVEY.md §4).

  python -m gaussiansplatting_tpu_torch.tools.evaluate --ply out.ply \
      --colmap scene/sparse/0 --images scene/images [--downscale 4] \
      [--device cuda]

``--device cuda`` (the default) exits with an error if CUDA is unavailable;
the CPU runs only when asked for with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ply", required=True)
    p.add_argument("--colmap", required=True)
    p.add_argument("--images", required=True)
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--pair-capacity", type=int, default=1 << 21)
    p.add_argument("--sh-degree", type=int, default=0, choices=(0, 1, 2, 3),
                   help="SH degree to render at (the PLY must hold its bands)")
    p.add_argument("--metrics", default=None, help="JSONL output path")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; no fallback)")
    args = p.parse_args(argv)
    if not os.path.exists(args.ply):
        raise SystemExit(f"error: PLY not found: {args.ply}")
    if not os.path.isdir(args.colmap):
        raise SystemExit(f"error: COLMAP dir not found: {args.colmap}")

    import torch

    from gaussiansplatting_tpu_torch.config import RasterConfig
    from gaussiansplatting_tpu_torch.core import camera as camera_mod
    from gaussiansplatting_tpu_torch.core import gaussians as gaussians_mod
    from gaussiansplatting_tpu_torch.io import colmap as colmap_mod
    from gaussiansplatting_tpu_torch.io import images as images_mod
    from gaussiansplatting_tpu_torch.io import ply as ply_mod
    from gaussiansplatting_tpu_torch.ops.losses import psnr as psnr_fn
    from gaussiansplatting_tpu_torch.ops.ssim import dssim_map
    from gaussiansplatting_tpu_torch.tools.render import _device
    from gaussiansplatting_tpu_torch.train.graph import render_frame
    from gaussiansplatting_tpu_torch.utils.metrics import MetricsLogger

    device = _device(args.device)
    raster = RasterConfig(pair_capacity=args.pair_capacity, sh_degree=args.sh_degree)
    log = MetricsLogger(path=args.metrics)

    cloud = ply_mod.load_gaussian_ply(args.ply)
    params = gaussians_mod.from_arrays(
        cloud.means, cloud.log_scales, cloud.quats, cloud.raw_opacities, cloud.sh,
        device=device,
    )
    data = colmap_mod.load_colmap(args.colmap)

    rows = []
    for im in data.images:
        cam_info = data.cameras[im.camera_id]
        path = images_mod.find_image(args.images, im.name)
        if path is None:
            continue
        rw = cam_info.width // args.downscale
        rh = cam_info.height // args.downscale
        gt = torch.from_numpy(images_mod.load_image(path, target_size=(rw, rh))).to(device)
        cam = camera_mod.make_camera(
            im.quat_wxyz, im.translation,
            cam_info.fx, cam_info.fy, cam_info.cx, cam_info.cy,
            cam_info.width, cam_info.height,
            render_width=rw, render_height=rh, device=device,
        )
        img, _ = render_frame(params, cam, raster)
        view_psnr = float(psnr_fn(img, gt))
        view_ssim = 1.0 - 2.0 * float(dssim_map(img, gt).mean())
        view_l1 = float((img - gt).abs().mean())
        rows.append((im.name, view_psnr, view_ssim, view_l1))
        log.log("view", name=im.name, psnr=round(view_psnr, 3),
                ssim=round(view_ssim, 4), l1=round(view_l1, 5))

    if not rows:
        raise SystemExit(f"no evaluable views under {args.images}")
    mean_psnr = sum(r[1] for r in rows) / len(rows)
    mean_ssim = sum(r[2] for r in rows) / len(rows)
    mean_l1 = sum(r[3] for r in rows) / len(rows)
    summary = {
        "metric": "eval",
        "views": len(rows),
        "psnr": round(mean_psnr, 3),
        "ssim": round(mean_ssim, 4),
        "l1": round(mean_l1, 5),
    }
    print(json.dumps(summary))
    log.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
