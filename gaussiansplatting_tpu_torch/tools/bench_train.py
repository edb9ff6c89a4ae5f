"""Convergence benchmark on PyTorch (the JAX package's BASELINE.md config
#3): the training step on one card, no filesystem — a synthetic multi-view
scene stands in for a small COLMAP scene.  Ground truth comes from rendering
a hidden target model; the trained model starts from a perturbed copy and
must recover it.  Counterpart of gaussiansplatting_tpu/tools/bench_train.py,
with the same flags plus ``--device``.

  python -m gaussiansplatting_tpu_torch.tools.bench_train [--n 20000]
      [--views 8] [--iters 400] [--width 400 --height 304] [--device cuda]

Prints one JSON line with the PSNR trajectory, steady-state throughput and
the blend kernels' launch counts.  ``--device cuda`` (the default) raises if
CUDA is unavailable; the CPU runs only when asked for with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=20_000)
    p.add_argument("--views", type=int, default=8)
    p.add_argument("--iters", type=int, default=400)
    p.add_argument("--width", type=int, default=400)
    p.add_argument("--height", type=int, default=304)
    p.add_argument("--pair-capacity", type=int, default=1 << 19)
    p.add_argument("--perturb", type=float, default=0.6)
    p.add_argument("--dssim-in-grad", type=int, default=1, choices=(0, 1),
                   help="1 = differentiate D-SSIM (framework default); "
                        "0 = reference-parity L1-only gradient")
    p.add_argument("--overflow-drop", choices=("index", "impact"),
                   default="index")
    p.add_argument("--eval-views", type=int, default=0,
                   help="hold out this many extra views for PSNR eval "
                        "(never trained on)")
    p.add_argument("--eval-pair-capacity", type=int, default=0,
                   help="pair capacity for eval renders (0 = same as "
                        "training; set higher for capacity-constrained "
                        "overflow A/Bs so eval itself never drops pairs)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; no fallback)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from gaussiansplatting_tpu_torch.config import Config, LossConfig, RasterConfig
    from gaussiansplatting_tpu_torch.core import camera as camera_mod
    from gaussiansplatting_tpu_torch.core import gaussians as gaussians_mod
    from gaussiansplatting_tpu_torch.ops import blend as blend_mod
    from gaussiansplatting_tpu_torch.ops.rasterize import render
    from gaussiansplatting_tpu_torch.tools.render import _device
    from gaussiansplatting_tpu_torch.train import state as state_mod
    from gaussiansplatting_tpu_torch.train.trainer import train_step
    from gaussiansplatting_tpu_torch.utils import synthetic

    device = _device(args.device)
    cfg = Config(
        raster=RasterConfig(
            pair_capacity=args.pair_capacity,
            overflow_drop=args.overflow_drop,
        ),
        loss=LossConfig(dssim_in_grad=bool(args.dssim_in_grad)),
    )
    gt_params = synthetic.make_scene(n=args.n, seed=0, device=device)

    # ring of cameras around the synthetic box (center ~ (0, 0, 4));
    # held-out eval cameras sit between the training azimuths
    center = np.array([0.0, 0.0, 4.0], np.float32)
    fy = args.height * 1.1

    def ring_cam(az, elev):
        return camera_mod.orbit_camera(
            center, radius=4.0, azimuth=az, elevation=elev,
            fx=fy, fy=fy, width=args.width, height=args.height,
            up=(0.0, -1.0, 0.0), device=device,
        )

    cams = [
        ring_cam(2 * math.pi * i / args.views - math.pi / 2,
                 0.25 * math.sin(2.0 * i))
        for i in range(args.views)
    ]
    eval_cams = [
        ring_cam(2 * math.pi * (i + 0.5) / args.views - math.pi / 2,
                 0.25 * math.sin(2.0 * i + 1.0))
        for i in range(args.eval_views)
    ]
    eval_raster = (
        cfg.raster.replace(pair_capacity=args.eval_pair_capacity)
        if args.eval_pair_capacity else cfg.raster
    )

    def eval_render(params, cam):
        with torch.no_grad():
            return render(params, cam, eval_raster)[0]

    # ALL ground truths render with the full-capacity eval_raster, so in a
    # capacity-constrained overflow A/B the arms train toward one target
    gts = [eval_render(gt_params, c) for c in cams]
    eval_gts = [eval_render(gt_params, c) for c in eval_cams]

    # perturbed start: same geometry, damaged appearance + jittered positions
    # (the JAX tool's rng calls, in its order)
    rng = np.random.default_rng(7)
    host = {f: getattr(gt_params, f).detach().cpu().numpy()
            for f in gaussians_mod.FIELDS}
    host["sh"] = host["sh"] + rng.normal(0, args.perturb, host["sh"].shape).astype(np.float32)
    host["raw_opacities"] = host["raw_opacities"] + rng.normal(
        0, args.perturb, host["raw_opacities"].shape).astype(np.float32)
    host["means"] = host["means"] + rng.normal(0, 0.005, host["means"].shape).astype(np.float32)
    st = state_mod.create(gaussians_mod.params_from_numpy(host, device))

    def mean_psnr(state, cam_list, gt_list):
        vals = []
        for c, g in zip(cam_list, gt_list):
            mse = torch.mean((eval_render(state.params, c) - g) ** 2)
            vals.append(float(-10.0 * torch.log10(torch.clamp(mse, min=1e-10))))
        return sum(vals) / max(len(vals), 1)

    fwd0 = blend_mod.windowed_blend_fwd.launches
    bwd0 = blend_mod.windowed_blend_bwd.launches
    psnr0 = mean_psnr(st, cams, gts)
    # warmup step
    st, _ = train_step(st, cams[0], gts[0], cfg, args.iters)
    _sync(device)

    t0 = time.perf_counter()
    # overflow flags stay on the device inside the timed loop (a bool() per
    # step would wait for the device every step); summed after the sync
    overflow_flags = []
    for it in range(1, args.iters):
        v = it % args.views
        st, metrics = train_step(st, cams[v], gts[v], cfg, args.iters)
        overflow_flags.append(metrics.overflow)
    _sync(device)
    dt = time.perf_counter() - t0
    overflow_steps = int(torch.stack(overflow_flags).sum()) if overflow_flags else 0
    psnr1 = mean_psnr(st, cams, gts)
    psnr_holdout = mean_psnr(st, eval_cams, eval_gts) if eval_cams else None

    print(
        json.dumps(
            {
                "metric": "train_convergence_synthetic",
                "value": round(psnr1, 2),
                "unit": "dB PSNR",
                "detail": {
                    "psnr_start": round(psnr0, 2),
                    "psnr_end": round(psnr1, 2),
                    "psnr_holdout": (
                        round(psnr_holdout, 2)
                        if psnr_holdout is not None else None
                    ),
                    "iters": args.iters,
                    "views": args.views,
                    "eval_views": args.eval_views,
                    "n_gaussians": args.n,
                    "resolution": [args.width, args.height],
                    "iters_per_sec": round((args.iters - 1) / max(dt, 1e-9), 2),
                    "dssim_in_grad": bool(args.dssim_in_grad),
                    "overflow_drop": args.overflow_drop,
                    "pair_capacity": args.pair_capacity,
                    "overflow_steps": overflow_steps,
                    "device": (torch.cuda.get_device_name(device)
                               if device.type == "cuda" else str(device)),
                    "blend_fwd_launches": blend_mod.windowed_blend_fwd.launches - fwd0,
                    "blend_bwd_launches": blend_mod.windowed_blend_bwd.launches - bwd0,
                },
            }
        ),
        flush=True,
    )
    return 0


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


if __name__ == "__main__":
    raise SystemExit(main())
