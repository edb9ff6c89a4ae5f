"""Training CLI on PyTorch — the reference's main program
(main.mm:193-492): load COLMAP, initialize Gaussians from SfM points, train
with densify / prune /
split / opacity reset on the reference schedule, export a PLY and
per-view renders; with config files, checkpoints and resume, JSONL metrics
and a held-out evaluation.  Counterpart of
gaussiansplatting_tpu/tools/train.py with the same flags, the same JSONL
events and the same checkpoint format, plus ``--device``.

Usage:
  python -m gaussiansplatting_tpu_torch.tools.train \
      --colmap scene/sparse/0 --images scene/images --output out.ply \
      [--epochs 155] [--downscale 4] [--checkpoint-dir ckpt/ --resume] \
      [--config cfg.json] [--metrics metrics.jsonl] [--devices N] \
      [--batch-views K] [--export-renders renders/] [--device cuda]

``--device cuda`` (the default) exits with an error if CUDA is unavailable;
the CPU runs only when asked for with ``--device cpu``.  ``--devices N``
shards tile strips over N ranks (parallel/): under a launcher (the
environment of parallel/launch.py, or ``--coordinator``) every rank runs
this program; without one it starts N local ranks itself
(``launch.spawn``).  Only rank 0 writes metrics, checkpoints, snapshots,
renders and the PLY.  ``--payload-dtype bf16`` (with ``--pack-positions
1``) trains in the bf16 payload mode and ``--overflow-drop impact`` sheds
the least visible Gaussians under overflow, as in the JAX tool.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--colmap", required=True, help="COLMAP sparse dir (cameras/images/points3D.bin)")
    p.add_argument("--images", required=True, help="training images dir")
    p.add_argument("--output", default="output.ply", help="output PLY path")
    p.add_argument("--epochs", type=int, default=None, help="override config epochs")
    p.add_argument("--downscale", type=int, default=1, help="image downscale factor")
    p.add_argument("--config", default=None, help="config JSON (defaults = reference constants)")
    p.add_argument("--capacity", type=int, default=None, help="Gaussian capacity (default: grows to density cap)")
    p.add_argument("--pair-capacity", type=int, default=None,
                   help="padded (tile,depth) pairs per frame (default 1<<21; "
                        "on --resume, None keeps the checkpoint's value)")
    p.add_argument("--payload-dtype", choices=("f32", "bf16"), default=None,
                   help="pair-payload precision (bf16: conic, opacity, colour "
                        "and the cotangents as bf16 pairs, ops/packing.py, with "
                        "the packed blend kernels)")
    p.add_argument("--pack-positions", type=int, choices=(0, 1), default=None,
                   help="with --payload-dtype bf16: pack tile-relative screen "
                        "positions as one bf16 pair")
    p.add_argument("--chunk-slack", type=float, default=None,
                   help="expansion chunk-padding allowance scale (1.0 = "
                        "worst case; the overflow path covers undersizing)")
    p.add_argument("--overflow-drop", choices=("index", "impact"), default=None,
                   help="which Gaussians lose pairs on overflow: 'index' = "
                        "emission-order prefix (reference parity, "
                        "tiled_shaders.metal:779-780), 'impact' = keep the "
                        "highest opacity*tiles set")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-interval", type=int, default=5000, help="iters between checkpoints (0=end only)")
    p.add_argument("--resume", action="store_true", help="resume from latest checkpoint in --checkpoint-dir")
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    p.add_argument("--devices", type=int, default=1,
                   help="shard tile strips across N ranks, one device each")
    p.add_argument("--export-renders", default=None, help="dir for final per-view renders")
    p.add_argument("--knn-mode", choices=("reference", "exact"), default="reference")
    p.add_argument("--coordinator", default=None,
                   help="process-group coordinator host:port (rank 0's); the "
                        "process count and rank come from NUM_PROCESSES and "
                        "PROCESS_ID (or WORLD_SIZE and RANK)")
    p.add_argument("--snapshot-dir", default=None,
                   help="write render+gt PNG snapshots every config snapshot_interval iters")
    p.add_argument("--sh-degree", type=int, default=None, choices=(0, 1),
                   help="override config SH degree (1 = trainable view-dependent color)")
    p.add_argument("--adaptive-pairs", action="store_true",
                   help="auto-bucket pair capacity to the live workload "
                        "(--pair-capacity becomes the upper bound)")
    p.add_argument("--adaptive-capacity", action="store_true",
                   help="start the Gaussian arrays near the SfM point count "
                        "and grow them with densification (--capacity "
                        "becomes the upper bound)")
    p.add_argument("--min-pair-capacity", type=int, default=1 << 16,
                   help="adaptive-pairs lower bound")
    p.add_argument("--batch-views", type=int, default=1, metavar="K",
                   help="one Adam step on the mean gradient of K views "
                        "(larger effective batch; 1 = reference parity)")
    p.add_argument("--shuffle", action="store_true",
                   help="shuffle view order each epoch (official-3DGS style; "
                        "default keeps the reference's fixed order)")
    p.add_argument("--scan-steps", type=int, default=1, metavar="K",
                   help="run K consecutive steps as one chunk when no "
                        "schedule event falls inside")
    p.add_argument("--eval-split", type=int, default=0, metavar="N",
                   help="hold out every Nth view from training and report "
                        "held-out PSNR at the end (0 = off)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; no fallback)")
    return p


def apply_raster_overrides(raster, args, default_pair_capacity=None):
    """CLI flags win over config/checkpoint values; an OMITTED flag keeps
    them (the default must not silently shrink a config's capacity).
    ``default_pair_capacity`` applies only when neither flag nor config
    source provided one (fresh start without --config)."""
    if args.pair_capacity is not None:
        raster = raster.replace(pair_capacity=args.pair_capacity)
    elif default_pair_capacity is not None:
        raster = raster.replace(pair_capacity=default_pair_capacity)
    if args.sh_degree is not None:
        raster = raster.replace(sh_degree=args.sh_degree)
    if args.overflow_drop is not None:
        raster = raster.replace(overflow_drop=args.overflow_drop)
    if args.payload_dtype is not None:
        raster = raster.replace(payload_dtype=args.payload_dtype)
    if args.pack_positions is not None:
        raster = raster.replace(pack_positions=bool(args.pack_positions))
    if args.chunk_slack is not None:
        raster = raster.replace(chunk_slack=args.chunk_slack)
    return raster


def load_scene(args, cfg, device):
    """COLMAP -> (cameras, gt_images, initial params, scene_extent)."""
    from gaussiansplatting_tpu_torch.io.dataset import load_colmap_scene

    try:
        scene = load_colmap_scene(
            args.colmap, args.images, cfg,
            downscale=args.downscale,
            capacity=None if args.adaptive_capacity else args.capacity,
            capacity_factor=1.5 if args.adaptive_capacity else 4.0,
            knn_mode=args.knn_mode,
            device=device,
        )
    except FileNotFoundError as e:
        raise SystemExit(f"error: {e}")
    if len(scene.resolutions) > 1:
        print(
            f"warning: {len(scene.resolutions)} distinct render resolutions "
            f"{scene.resolutions[:4]}"
        )
    return scene.cameras, scene.gt_images, scene.params, scene.extent


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not os.path.isdir(args.colmap):
        raise SystemExit(f"error: COLMAP dir not found: {args.colmap}")
    if not os.path.isdir(args.images):
        raise SystemExit(f"error: images dir not found: {args.images}")
    if args.config and not os.path.exists(args.config):
        raise SystemExit(f"error: config not found: {args.config}")
    if args.batch_views < 1:
        raise SystemExit(f"error: --batch-views {args.batch_views}: train_step_batched "
                         "takes K >= 1 views")
    if args.devices < 1:
        raise SystemExit(f"error: --devices {args.devices}: parallel/ needs N >= 1 ranks")

    import torch

    from gaussiansplatting_tpu_torch.parallel import launch

    if args.devices > 1 and args.coordinator is None and not launch.launched():
        # no launcher: this process starts the ranks, each runs _train
        if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
            raise SystemExit(f"error: --devices {args.devices} starts one rank per card "
                             "(parallel/launch.spawn), but CUDA is not available (pass "
                             "--device cpu for gloo ranks on the CPU)")
        argv = sys.argv[1:] if argv is None else list(argv)
        return launch.spawn(_rank_main, args.devices, (argv,), device=args.device)[0]
    try:
        topo = launch.initialize(coordinator=args.coordinator, device=args.device)
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"error: {e}")
    try:
        return _train(args, topo)
    finally:
        launch.shutdown()


def _rank_main(topo, argv):
    """One rank of ``--devices N`` started by launch.spawn."""
    return _train(build_parser().parse_args(argv), topo)


def _train(args, topo) -> int:
    import torch

    from gaussiansplatting_tpu_torch.config import Config
    from gaussiansplatting_tpu_torch.io import images as images_mod
    from gaussiansplatting_tpu_torch.io import ply as ply_mod
    from gaussiansplatting_tpu_torch.ops.rasterize import render as raster_render
    from gaussiansplatting_tpu_torch.parallel import launch
    from gaussiansplatting_tpu_torch.train import checkpoint as ckpt_mod
    from gaussiansplatting_tpu_torch.train import state as state_mod
    from gaussiansplatting_tpu_torch.train import trainer
    from gaussiansplatting_tpu_torch.utils.metrics import MetricsLogger

    device = torch.device(topo["device"])
    # every rank runs the same steps; only rank 0 touches the filesystem
    primary = launch.is_primary()
    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    else:
        cfg = Config()
    # a config JSON's pair_capacity is authoritative when the flag is
    # omitted; without either, default 1<<21
    cfg = cfg.replace(raster=apply_raster_overrides(
        cfg.raster, args,
        default_pair_capacity=None if args.config else 1 << 21,
    ))

    log = MetricsLogger(path=args.metrics if primary else None, echo=primary)
    log.log("start", colmap=args.colmap, devices=args.devices, **topo)

    if args.metrics:
        # the JSONL stream records every step; the console echo line costs
        # host reads of the step's metrics
        cfg = cfg.replace(train=cfg.train.replace(
            log_interval=max(cfg.train.log_interval, 100)))

    cameras, gts, params, extent = load_scene(args, cfg, device)
    eval_cams, eval_gts = [], []
    if args.eval_split > 1:
        train_cams, train_gts = [], []
        for i, (c, g) in enumerate(zip(cameras, gts)):
            if i % args.eval_split == 0:
                eval_cams.append(c)
                eval_gts.append(g)
            else:
                train_cams.append(c)
                train_gts.append(g)
        cameras, gts = train_cams, train_gts
    log.log(
        "scene",
        views=len(cameras),
        eval_views=len(eval_cams),
        n_init=int(params.alive.sum()),
        capacity=params.capacity,
        extent=round(extent, 4),
        resolution=[cameras[0].width, cameras[0].height],
    )

    latest = (
        os.path.join(args.checkpoint_dir, "latest.npz") if args.checkpoint_dir else None
    )
    if args.resume and latest and os.path.exists(latest):
        state, saved_cfg = ckpt_mod.load(latest, device)
        if saved_cfg is not None:
            # CLI overrides win over the checkpoint's saved config; omitted
            # flags keep the checkpoint's values
            cfg = saved_cfg.replace(raster=apply_raster_overrides(saved_cfg.raster, args))
        log.log("resume", path=latest, iteration=int(state.opt.t))
    else:
        state = state_mod.create(params, seed=cfg.train.seed)
    if topo["process_count"] > 1:
        # checkpoints live on a shared filesystem (rank 0 writes them); ranks
        # that resumed from different points would train different states
        its = torch.tensor([state.opt.t, -state.opt.t], dtype=torch.int64, device=device)
        torch.distributed.all_reduce(its, op=torch.distributed.ReduceOp.MAX)
        if int(its[0]) != -int(its[1]):
            raise SystemExit("error: the resume iteration differs across ranks: checkpoints "
                             "must live on a shared filesystem (only rank 0 writes them)")

    gts = [torch.from_numpy(g).to(device) for g in gts]

    # Per-step metrics stay on the device and flush in batches: one host
    # read per FLUSH steps (stacking is asynchronous), not ten per step.
    buf: list = []
    flush_every = 25

    def flush_metrics():
        if not buf:
            return
        iters = [it for it, _, _ in buf]
        lrs = [lr for _, _, lr in buf]
        vals = torch.stack([v for _, v, _ in buf]).cpu().numpy()
        buf.clear()
        for it, row, lr in zip(iters, vals, lrs):
            if not np.isfinite(row[0]):
                log.log("warning", iter=it,
                        msg="non-finite loss — check LRs / pair capacity")
            log.log(
                "step", iter=it,
                loss=float(row[0]), l1=float(row[1]), dssim=float(row[2]),
                psnr=float(row[3]), n=int(row[4]), pairs=int(row[5]),
                overflow=bool(row[6] > 0), lr_pos=float(np.float32(lr)),
                mean_op=round(float(row[7]), 4),
                mean_scale=round(float(row[8]), 5),
            )

    def metrics_fn(iteration, m):
        if not primary:
            return
        vec = torch.stack([
            m.loss, m.l1, m.dssim, m.psnr,
            m.num_gaussians.to(torch.float32), m.num_pairs.to(torch.float32),
            m.overflow.to(torch.float32), m.mean_opacity, m.mean_world_scale,
        ])
        buf.append((iteration, vec, float(m.position_lr)))
        if len(buf) >= flush_every:
            flush_metrics()

    def checkpoint_fn(iteration, st):
        if latest and primary:
            ckpt_mod.save(latest, st, cfg)
            log.log("checkpoint", iter=iteration, path=latest)

    def render_image(st, cam):
        with torch.no_grad():
            img, _ = raster_render(st.params, cam, cfg.raster)
        return img.cpu().numpy()

    def snapshot_fn(iteration, st, cam, gt):
        if not primary:
            return
        os.makedirs(args.snapshot_dir, exist_ok=True)
        images_mod.save_png(
            os.path.join(args.snapshot_dir, f"render_{iteration:06d}.png"),
            render_image(st, cam),
        )
        images_mod.save_png(
            os.path.join(args.snapshot_dir, f"gt_{iteration:06d}.png"),
            gt.cpu().numpy(),
        )
        log.log("snapshot", iter=iteration, dir=args.snapshot_dir)

    epochs = args.epochs if args.epochs is not None else cfg.train.epochs
    t0 = time.time()
    state = trainer.train_loop(
        state, cameras, gts, cfg, extent,
        num_epochs=epochs,
        log_fn=lambda msg: log.log("info", msg=msg),
        metrics_fn=metrics_fn,
        checkpoint_fn=checkpoint_fn if args.checkpoint_dir else None,
        checkpoint_interval=args.checkpoint_interval,
        mesh_devices=args.devices,
        snapshot_fn=snapshot_fn if args.snapshot_dir else None,
        shuffle_seed=cfg.train.seed if args.shuffle else None,
        batch_views=args.batch_views,
        adaptive_pairs=args.adaptive_pairs,
        min_pair_capacity=args.min_pair_capacity,
        adaptive_capacity=args.adaptive_capacity,
        max_capacity=args.capacity,
        scan_steps=args.scan_steps,
    )
    flush_metrics()
    log.log("trained", seconds=round(time.time() - t0, 1), iteration=int(state.opt.t))

    if args.checkpoint_dir:
        checkpoint_fn(int(state.opt.t), state)

    if not primary:
        log.close()
        return 0
    # held-out evaluation (official-3DGS test split)
    if eval_cams:
        psnrs = []
        for c, g in zip(eval_cams, eval_gts):
            mse = float(np.mean((render_image(state, c) - g) ** 2))
            psnrs.append(-10.0 * np.log10(max(mse, 1e-10)))
        log.log(
            "eval",
            views=len(psnrs),
            psnr=round(sum(psnrs) / len(psnrs), 3),
            psnr_min=round(min(psnrs), 3),
        )

    # export PLY (reference: PLYExporter::exportPLY, main.mm:408-418)
    count = int(state.params.alive.sum())
    n_written = ply_mod.export_gaussian_ply(args.output, ply_mod.cloud_from_params(state.params))
    log.log("export_ply", path=args.output, n=n_written, alive=count)

    if args.export_renders:
        os.makedirs(args.export_renders, exist_ok=True)
        for i, cam in enumerate(cameras):
            images_mod.save_png(
                os.path.join(args.export_renders, f"view_{i:04d}.png"),
                render_image(state, cam),
            )
        log.log("export_renders", dir=args.export_renders, views=len(cameras))
    log.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
