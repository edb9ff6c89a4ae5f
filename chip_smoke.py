#!/usr/bin/env python3
"""On-GPU smoke test of the PyTorch port's render and training paths (one
NVIDIA card).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):
  1. device   require CUDA; print the card's name and power limit; pin fp32
              matmuls (no TF32), as the JAX package pins full precision.
  2. build    compile both windowed-blend CUDA kernels (forward, backward)
              from csrc/ with nvcc, one process each, in parallel.
  3. kernel   each kernel against its plain PyTorch version on the card:
              small edge-case windows (dead, partial, full and unaligned
              blocks, B = 16 and 128) and the full-size windows of the
              100k-Gaussian scene's canonical 800x608 view (the backward with
              the real cotangent of the full-size loss, launched twice for
              bit-identical output); all timed with CUDA events.
  4. render   the render main path: the synthetic scene written to a PLY,
              rendered through tools.render (4 orbit views at 800x608), then
              the canonical view through ops.rasterize.render: no overflow,
              the scene's pair count, finite non-constant images, kernel
              launches counted; a small render on the card against the CPU
              render.
  5. train    the training main path: tools.bench_train at its default size
              (PSNR must rise, no overflow); the full-size step (100k
              Gaussians, 800x608, random ground truth, default Config): warm,
              then timed, finite and without overflow; one step replayed from
              the same state must give the same bits; a 64x48 step on the card
              against the same step on the CPU.  Both kernels' launches
              counted.

Prints one JSON line describing the kernels, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

WIDTH, HEIGHT = 800, 608
N_GAUSSIANS = 100_000
PAIR_CAPACITY = 1 << 21
PAIR_BLOCK = 128
# pairs the 100k-Gaussian scene (seed 0, as generated, before any training
# step) emits in its canonical 800x608 view: the JAX package's count, which
# tests/test_torch_pairs.py pins for both packages on the CPU.  (BENCH_r05's
# 1,697,092 is the count after 9 optimizer steps, bench.py:364-378, a
# different parameter state.)  Tile rects that flip at float boundaries may
# move it by a handful; a larger gap is a fault.
SCENE_NUM_PAIRS = 1_666_075
PAIRS_REL_TOL = 1e-3
# kernel vs plain: the kernel's power masks match the plain version bit for
# bit (same rounded operations), but it sums the log-transmittance prefix
# sequentially where the plain version takes cumsum/sum in another order;
# S_b reaches |S_b| ~ 1e2 where float32 spacing is ~8e-6, hence the
# relative term
KERNEL_ATOL, KERNEL_RTOL = 1e-4, 1e-5
# backward kernel vs plain, per cotangent column, relative to the column's
# largest magnitude: both take every mask from the same rounded power, but
# the kernel sums the suffix sum_{j>i} e_j w_j and the log-transmittance
# sequentially (T recovered back to front), the plain version by cumsums,
# and the pixel sums in another order; dl / (1 - alpha) scales the suffix's
# rounding by up to 100 at the alpha cap, and dalpha = e T - dl / (1 - alpha)
# cancels where the two terms meet.  Measured <= 6.5e-7 of a column's scale
# on an NVIDIA H100 80GB HBM3 at 700 W (edge windows and the full-size loss
# cotangent); the bar leaves a factor of 15 for sums that cancel harder.
BWD_REL = 1e-5
# small render on the card vs on the CPU (plain blend, CPU projection)
RENDER_ATOL = 1e-4
# tools.bench_train at its default size (20k Gaussians, 400x304, 8 views)
BENCH_TRAIN_ITERS = 40
# full-size train step: JAX bench.py's workload, its random ground truth
# (bench.py:316-360) and the default Config (D-SSIM differentiated)
TRAIN_TIMED_STEPS = 10
TRAIN_TOTAL_ITERS = 30_000
# 64x48 train step, card vs CPU.  After one step Adam moves each element by
# about lr * sign(g), so an element whose gradient is rounding noise may move
# the other way on the other device: parameters are held to STEP_ATOL only
# where |m| (= 0.1 |clip(g)|) exceeds NOISE_REL of the field's largest, and
# to two learning rates elsewhere.  m and v hold the gradients themselves.
STEP_LOSS_RTOL = 1e-5
STEP_MOMENT_REL = 1e-3
STEP_ATOL = 1e-5
NOISE_REL = 1e-3
SCRATCH = os.path.join(REPO, "build", "chip_smoke")
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    import torch

    fn()                                   # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this check needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"count {torch.cuda.device_count()}")
    log(smi)
    return name, smi


KERNELS = ("blend_fwd", "blend_bwd")


def phase_build():
    from gaussiansplatting_tpu_torch.kernels import build

    cached = {name: build.library_path(name).exists() for name in KERNELS}
    t0 = time.time()
    paths = build.build_all(KERNELS)
    seconds = time.time() - t0
    for name in KERNELS:
        build.load_library(name)
        log(f"[build] {name}: {'cached' if cached[name] else 'built'} "
            f"{paths[name].name} in {seconds:.2f} s (parallel build)")
        for line in build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build]   {line.strip()}")


def edge_windows(block, seed, row0, nb=24, ts=16, tiles_x=50, tiles_y=38):
    """Random tile-sorted table [16, EP] + windows (src, valid, tile) with
    the blend's edge cases: block 0 dead (valid=0), block 1 full, block 2 at
    an unaligned start, a lane with a degenerate conic, partial blocks.
    Each window's pairs sit around its own tile (tests/test_torch_blend.py
    uses it too)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    e_cap = nb * block
    ep = -(-(e_cap + 2 * block) // 512) * 512
    table = np.zeros((16, ep), np.float32)
    tile = rng.integers(0, tiles_x * tiles_y, nb).astype(np.int32)
    src = rng.integers(0, e_cap - block, nb).astype(np.int32)
    src[2] = 3
    valid = rng.integers(1, block, nb).astype(np.int32)
    valid[0], valid[1] = 0, block
    table[0, :e_cap] = np.arange(e_cap)
    table[3, :e_cap] = rng.uniform(0.02, 0.4, e_cap)
    table[4, :e_cap] = rng.uniform(-0.02, 0.02, e_cap)
    table[5, :e_cap] = rng.uniform(0.02, 0.4, e_cap)
    table[6, :e_cap] = rng.uniform(0.05, 0.95, e_cap)
    table[7:10, :e_cap] = rng.uniform(0, 1, (3, e_cap))
    table[3:6, src[1] + 1] = 0.0
    for b in range(nb):
        cx = (tile[b] % tiles_x) * ts + ts / 2.0
        cy = (tile[b] // tiles_x + row0) * ts + ts / 2.0
        lanes = slice(src[b], src[b] + block)
        table[1, lanes] = cx + rng.uniform(-10, 10, block)
        table[2, lanes] = cy + rng.uniform(-10, 10, block)
    return table, src, valid, tile


def _compare(label, got, want):
    """Kernel (out, gid) vs plain (out, gid); returns max |out| error."""
    import torch

    out_k, gid_k = got
    out_p, gid_p = want
    if not torch.equal(gid_k, gid_p):
        raise AssertionError(f"{label}: gid differs from the plain version")
    if not bool(torch.isfinite(out_k).all()):
        raise AssertionError(f"{label}: kernel output has non-finite values")
    err = (out_k - out_p).abs()
    bad = err > KERNEL_ATOL + KERNEL_RTOL * out_p.abs()
    max_err = float(err.max()) if err.numel() else 0.0
    rows = [float(err[:, r].max()) for r in range(4)] if err.numel() else []
    log(f"[kernel] {label}: max|err| {max_err:.3e} (rows C,C,C,S: "
        f"{', '.join(f'{r:.2e}' for r in rows)}); beyond tolerance: "
        f"{int(bad.sum())} of {err.numel()}")
    if bool(bad.any()):
        raise AssertionError(f"{label}: kernel disagrees with the plain version")
    return max_err


def phase_kernel(params, camera, cfg):
    import torch

    from gaussiansplatting_tpu_torch.ops import blend
    from gaussiansplatting_tpu_torch.ops.rasterize import blend_windows

    for block in (16, 128):
        for row0 in (0, 3):
            table, src, valid, tile = (
                torch.from_numpy(x).to(DEVICE)
                for x in edge_windows(block, seed=block + row0, row0=row0))
            args = (table, src, valid, tile, row0, block,
                    (16, cfg.power_floor, cfg.alpha_cap, cfg.alpha_floor, 50))
            got = blend.windowed_blend_fwd(*args)
            torch.cuda.synchronize()
            _compare(f"edge B={block} row0={row0}", got,
                     blend.windowed_blend_fwd_plain(*args))

    args, _, aux = blend_windows(params, camera, cfg)
    total = int(aux.num_pairs)
    nb = args[1].shape[0]
    live = int((args[2] > 0).sum())
    log(f"[kernel] full size: {nb} blocks ({live} live, {nb - live} dead), "
        f"B={args[5]}, {total} pairs")
    got = blend.windowed_blend_fwd(*args)
    torch.cuda.synchronize()
    max_err = _compare("full size", got, blend.windowed_blend_fwd_plain(*args))
    ms = cuda_time_ms(lambda: blend.windowed_blend_fwd(*args), reps=20)
    plain_ms = cuda_time_ms(lambda: blend.windowed_blend_fwd_plain(*args), reps=3)
    return max_err, ms, plain_ms


def _compare_bwd(label, got, want):
    """Backward kernel vs plain: nine [NB, B] columns; each column's max
    error must be within BWD_REL of its largest plain magnitude.  Returns
    the max abs error over all columns."""
    import torch

    names = ("mx", "my", "a", "b", "c", "op", "r", "g", "b")
    rel, worst = [], 0.0
    for name, k, p in zip(names, got, want):
        if not bool(torch.isfinite(k).all()):
            raise AssertionError(f"{label}: kernel column d{name} has non-finite values")
        err = float((k - p).abs().max()) if k.numel() else 0.0
        scale = float(p.abs().max()) if p.numel() else 0.0
        rel.append(err / scale if scale > 0 else err)
        worst = max(worst, err)
        if err > BWD_REL * scale:
            raise AssertionError(
                f"{label}: d{name} max|err| {err:.3e} beyond {BWD_REL} x {scale:.3e}")
    log(f"[kernel bwd] {label}: max|err| {worst:.3e}; per column err/max "
        f"(mx my a b c op r g b): {', '.join(f'{r:.1e}' for r in rel)}")
    return worst


def _loss_cotangent(out, block_tile, camera, cfg, gt):
    """The real cotangent of the blend's output: autograd of compose and
    the default photometric loss (D-SSIM differentiated) at ``out``."""
    import torch

    from gaussiansplatting_tpu_torch.config import LossConfig
    from gaussiansplatting_tpu_torch.ops.losses import photometric_loss
    from gaussiansplatting_tpu_torch.ops.rasterize import compose

    with torch.enable_grad():
        out = out.detach().requires_grad_(True)
        img = compose(out, block_tile, camera, cfg)
        rep = photometric_loss(img, gt, LossConfig())
        (g,) = torch.autograd.grad(rep.grad_loss, out)
    return g


def phase_kernel_bwd(params, camera, cfg, gt):
    import numpy as np
    import torch

    from gaussiansplatting_tpu_torch.ops import blend
    from gaussiansplatting_tpu_torch.ops.rasterize import blend_windows

    for block in (16, 128):
        for row0 in (0, 3):
            table, src, valid, tile = (
                torch.from_numpy(x).to(DEVICE)
                for x in edge_windows(block, seed=block + row0, row0=row0))
            nb = src.shape[0]
            g = torch.from_numpy(np.random.default_rng(block + row0 + 1).normal(
                size=(nb, 4, 256)).astype(np.float32)).to(DEVICE)
            consts = (16, cfg.power_floor, cfg.alpha_cap, cfg.alpha_floor, 50)
            got = blend.windowed_blend_bwd(table, src, valid, tile, row0, block, g, consts)
            torch.cuda.synchronize()
            _compare_bwd(f"edge B={block} row0={row0}", got,
                         blend.windowed_blend_bwd_plain(table, src, valid, tile,
                                                        row0, block, g, consts))

    args, block_tile, _ = blend_windows(params, camera, cfg)
    out, _ = blend.windowed_blend_fwd(*args)
    g = _loss_cotangent(out, block_tile, camera, cfg, gt)
    bargs = args[:6] + (g, args[6])
    got = blend.windowed_blend_bwd(*bargs)
    again = blend.windowed_blend_bwd(*bargs)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("backward kernel: two launches on the same inputs differ")
    log("[kernel bwd] full size: two launches bit-identical")
    max_err = _compare_bwd("full size (loss cotangent)", got,
                           blend.windowed_blend_bwd_plain(*bargs))
    ms = cuda_time_ms(lambda: blend.windowed_blend_bwd(*bargs), reps=20)
    plain_ms = cuda_time_ms(lambda: blend.windowed_blend_bwd_plain(*bargs), reps=3)
    return max_err, ms, plain_ms


def _check_finite_state(label, state):
    import numpy as np

    from gaussiansplatting_tpu_torch.train.state import state_to_numpy

    for key, arr in state_to_numpy(state).items():
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            raise AssertionError(f"{label}: {key} has non-finite values")


def _compare_small_step(dev_state, dev_m, cpu_state, cpu_m, lrs):
    """The 64x48 step on the card against the CPU step (see STEP_* above)."""
    import numpy as np

    from gaussiansplatting_tpu_torch.train.optimizer import TRAINABLE
    from gaussiansplatting_tpu_torch.train.state import state_to_numpy

    got, ref = state_to_numpy(dev_state), state_to_numpy(cpu_state)
    loss_err = abs(float(dev_m.loss) - float(cpu_m.loss))
    if loss_err > STEP_LOSS_RTOL * abs(float(cpu_m.loss)):
        raise AssertionError(f"64x48 step: loss {float(dev_m.loss)} vs {float(cpu_m.loss)}")
    worst = {}
    lr = dict(zip(TRAINABLE, lrs))
    for f in TRAINABLE:
        for mom in ("m", "v"):
            a, b = got[f"opt/{mom}/{f}"], ref[f"opt/{mom}/{f}"]
            err = float(np.abs(a - b).max())
            if err > STEP_MOMENT_REL * float(np.abs(b).max()):
                raise AssertionError(f"64x48 step: opt/{mom}/{f} max|err| {err:.3e}")
            worst[f"{mom}/{f}"] = err
        m = np.abs(ref[f"opt/m/{f}"])
        signal = m > NOISE_REL * m.max()
        diff = np.abs(got[f"params/{f}"] - ref[f"params/{f}"])
        if diff[signal].max(initial=0.0) > STEP_ATOL or diff.max() > 2 * lr[f] + 1e-6:
            raise AssertionError(f"64x48 step: params/{f} max|err| {diff.max():.3e}")
        worst[f] = float(diff.max())
    if not np.array_equal(got["accum/grad_count"], ref["accum/grad_count"]):
        raise AssertionError("64x48 step: accum/grad_count differs")
    log(f"[train] 64x48 step card vs CPU: loss |err| {loss_err:.2e}; max|err| "
        + ", ".join(f"{k} {v:.1e}" for k, v in worst.items()))


def phase_train(params, camera, gt, smi):
    import contextlib
    import io

    import numpy as np
    import torch

    from gaussiansplatting_tpu_torch.config import Config, RasterConfig
    from gaussiansplatting_tpu_torch.core import gaussians
    from gaussiansplatting_tpu_torch.ops import blend
    from gaussiansplatting_tpu_torch.tools import bench_train
    from gaussiansplatting_tpu_torch.train import schedule
    from gaussiansplatting_tpu_torch.train import state as state_mod
    from gaussiansplatting_tpu_torch.train.trainer import train_step
    from gaussiansplatting_tpu_torch.utils import synthetic

    blend.windowed_blend_fwd.launches = 0
    blend.windowed_blend_bwd.launches = 0

    # (i) the training tool through its entry point
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_train.main(["--iters", str(BENCH_TRAIN_ITERS), "--device", DEVICE])
    line = buf.getvalue().strip().splitlines()[-1]
    log(f"[train] tools.bench_train: {line}")
    detail = json.loads(line)["detail"]
    if rc != 0 or not detail["psnr_end"] > detail["psnr_start"]:
        raise AssertionError("tools.bench_train did not improve PSNR")
    if detail["overflow_steps"] != 0:
        raise AssertionError(f"tools.bench_train: {detail['overflow_steps']} overflow steps")

    # (ii) the full-size step: warm, then timed
    cfg = Config(raster=RasterConfig(pair_capacity=PAIR_CAPACITY, pair_block=PAIR_BLOCK))
    state0 = state_mod.create(params)
    state1, m1 = train_step(state0, camera, gt, cfg, TRAIN_TOTAL_ITERS)
    st, flags, losses = state1, [m1.overflow], [m1.loss]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_TIMED_STEPS):
        st, m = train_step(st, camera, gt, cfg, TRAIN_TOTAL_ITERS)
        flags.append(m.overflow)
        losses.append(m.loss)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / TRAIN_TIMED_STEPS
    launches = (blend.windowed_blend_fwd.launches, blend.windowed_blend_bwd.launches)
    losses = torch.stack(losses).cpu().numpy()
    log(f"[train] full size {N_GAUSSIANS} Gaussians {WIDTH}x{HEIGHT}: "
        f"{step_ms:.3f} ms/step warm (CUDA events, {TRAIN_TIMED_STEPS} steps) "
        f"on {smi}; loss {losses[0]:.5f} -> {losses[-1]:.5f}, num_pairs "
        f"{int(m.num_pairs)}, t {st.opt.t}")
    if not np.isfinite(losses).all():
        raise AssertionError("full-size train step: non-finite loss")
    if bool(torch.stack(flags).any()):
        raise AssertionError("full-size train step overflowed pair_capacity")
    if st.opt.t != TRAIN_TIMED_STEPS + 1:
        raise AssertionError(f"full-size train step: t is {st.opt.t}")
    _check_finite_state("full-size train step", st)
    log(f"[train] main path: {launches[0]} windowed_blend_fwd and {launches[1]} "
        f"windowed_blend_bwd kernel launches")
    if min(launches) <= 0:
        raise AssertionError("the training path did not launch both kernels")

    # (iii) one step replayed from the same state gives the same bits
    replay, _ = train_step(state0, camera, gt, cfg, TRAIN_TOTAL_ITERS)
    a, b = state_mod.state_to_numpy(state1), state_mod.state_to_numpy(replay)
    differ = [k for k in a if not np.array_equal(a[k], b[k])]
    if differ:
        raise AssertionError(f"replayed step differs in {differ}")
    log(f"[train] replayed full-size step: all {len(a)} state arrays bit-identical")

    # (iv) a 64x48 step on the card against the same step on the CPU
    small = synthetic.make_scene(64, seed=5, spread=0.6)
    small_cfg = cfg.replace(raster=cfg.raster.replace(pair_capacity=4096, pair_block=16))
    small_gt = np.random.default_rng(2).uniform(0, 1, (48, 64, 3)).astype(np.float32)
    host = {f: getattr(small, f).detach().numpy() for f in gaussians.FIELDS}
    cpu_state, cpu_m = train_step(
        state_mod.create(small), synthetic.make_canonical_camera(64, 48),
        torch.from_numpy(small_gt), small_cfg, 100)
    dev_state, dev_m = train_step(
        state_mod.create(gaussians.params_from_numpy(host, DEVICE)),
        synthetic.make_canonical_camera(64, 48, device=DEVICE),
        torch.from_numpy(small_gt).to(DEVICE), small_cfg, 100)
    _compare_small_step(dev_state, dev_m, cpu_state, cpu_m,
                        schedule.learning_rates(small_cfg.optim, 0, 100))
    return launches, step_ms


def _read_ppm(path):
    import numpy as np

    with open(path, "rb") as f:
        magic, size, maxval, body = f.read().split(b"\n", 3)   # io.images.save_ppm
    if magic != b"P6" or maxval != b"255":
        raise AssertionError(f"{path}: not a binary PPM")
    w, h = (int(v) for v in size.split())
    return np.frombuffer(body, np.uint8).reshape(h, w, 3).copy()


def _check_image(label, img):
    import torch

    if tuple(img.shape) != (HEIGHT, WIDTH, 3):
        raise AssertionError(f"{label}: shape {tuple(img.shape)}")
    img = torch.as_tensor(img).float()
    if not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{label}: non-finite pixels")
    if float(img.max() - img.min()) <= 0:
        raise AssertionError(f"{label}: constant image")


def phase_render(params, camera, cfg, smi):
    import torch

    from gaussiansplatting_tpu_torch.core import gaussians
    from gaussiansplatting_tpu_torch.io import ply
    from gaussiansplatting_tpu_torch.ops import blend
    from gaussiansplatting_tpu_torch.ops.rasterize import render
    from gaussiansplatting_tpu_torch.tools import render as render_cli
    from gaussiansplatting_tpu_torch.utils import synthetic

    os.makedirs(SCRATCH, exist_ok=True)
    ply_path = os.path.join(SCRATCH, "scene.ply")
    ply.export_gaussian_ply(ply_path, ply.cloud_from_params(params))
    out_dir = os.path.join(SCRATCH, "orbit")

    blend.windowed_blend_fwd.launches = 0
    rc = render_cli.main([
        "--ply", ply_path, "--output", out_dir, "--orbit", "4",
        "--width", str(WIDTH), "--height", str(HEIGHT), "--format", "ppm",
        "--pair-capacity", str(PAIR_CAPACITY), "--device", DEVICE,
    ])
    if rc != 0:
        raise AssertionError(f"tools.render exited {rc}")
    with torch.no_grad():
        img, aux = render(params, camera, cfg)
    torch.cuda.synchronize()
    launches = blend.windowed_blend_fwd.launches
    log(f"[render] main path: 4 orbit views + canonical view, "
        f"{launches} windowed_blend_fwd kernel launches")
    if launches < 5:
        raise AssertionError(f"expected >= 5 kernel launches, got {launches}")

    for i in range(4):
        _check_image(f"orbit_{i:03d}", _read_ppm(os.path.join(out_dir, f"orbit_{i:03d}.ppm")))
    _check_image("canonical", img)
    num_pairs, overflow = int(aux.num_pairs), bool(aux.overflow)
    gap = abs(num_pairs - SCENE_NUM_PAIRS)
    log(f"[render] canonical {WIDTH}x{HEIGHT}: num_pairs {num_pairs} "
        f"(recorded {SCENE_NUM_PAIRS}, gap {gap}), overflow {overflow}")
    if overflow:
        raise AssertionError("canonical view overflowed pair_capacity")
    if gap > PAIRS_REL_TOL * SCENE_NUM_PAIRS:
        raise AssertionError(f"num_pairs {num_pairs} is {gap} away from {SCENE_NUM_PAIRS}")

    def frame():
        with torch.no_grad():
            render(params, camera, cfg)

    frame_ms = cuda_time_ms(frame, reps=10)
    log(f"[render] canonical view: {frame_ms:.3f} ms/frame warm (CUDA events, "
        f"10 frames) on {smi}")

    # the whole path on the card against the CPU path (plain blend) at a
    # small size
    small = synthetic.make_scene(64, seed=5, spread=0.6)
    small_cfg = cfg.replace(pair_capacity=4096, pair_block=16)
    with torch.no_grad():
        ref, ref_aux = render(small, synthetic.make_canonical_camera(64, 48), small_cfg)
        dev_params = gaussians.params_from_numpy(
            {f: getattr(small, f).detach().numpy() for f in gaussians.FIELDS}, DEVICE)
        got, got_aux = render(dev_params, synthetic.make_canonical_camera(64, 48, device=DEVICE),
                              small_cfg)
    err = float((got.cpu() - ref).abs().max())
    log(f"[render] 64x48 card vs CPU: max|err| {err:.3e}, num_pairs "
        f"{int(got_aux.num_pairs)} vs {int(ref_aux.num_pairs)}")
    if int(got_aux.num_pairs) != int(ref_aux.num_pairs) or err > RENDER_ATOL:
        raise AssertionError("small render on the card disagrees with the CPU render")
    shutil.rmtree(SCRATCH)
    return launches, frame_ms


def main() -> int:
    name, smi = phase_device()

    import numpy as np
    import torch

    from gaussiansplatting_tpu_torch.config import RasterConfig
    from gaussiansplatting_tpu_torch.utils import synthetic

    phase_build()
    params = synthetic.make_scene(N_GAUSSIANS, seed=0, device=DEVICE)
    camera = synthetic.make_canonical_camera(WIDTH, HEIGHT, device=DEVICE)
    cfg = RasterConfig(pair_capacity=PAIR_CAPACITY, pair_block=PAIR_BLOCK)
    gt = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (HEIGHT, WIDTH, 3)).astype(np.float32)).to(DEVICE)   # bench.py:358-360
    with torch.no_grad():
        max_err, ms, plain_ms = phase_kernel(params, camera, cfg)
    log(f"[kernel] full size: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms "
        f"(CUDA events) on {smi}")
    with torch.no_grad():
        bwd_err, bwd_ms, bwd_plain_ms = phase_kernel_bwd(params, camera, cfg, gt)
    log(f"[kernel bwd] full size: kernel {bwd_ms:.4f} ms, plain {bwd_plain_ms:.3f} ms "
        f"(CUDA events) on {smi}")
    render_launches, frame_ms = phase_render(params, camera, cfg, smi)
    (train_fwd, train_bwd), step_ms = phase_train(params, camera, gt, smi)

    log(json.dumps({"kernels": [{
        "name": "windowed_blend_fwd",
        "route": "cuda",
        "source": "gaussiansplatting_tpu_torch/csrc/blend_fwd.cu",
        "replaces": "gaussiansplatting_tpu/ops/pallas_blend.py:601",
        "launches": render_launches + train_fwd,
        "launches_by_path": {"render": render_launches, "train": train_fwd},
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }, {
        "name": "windowed_blend_bwd",
        "route": "cuda",
        "source": "gaussiansplatting_tpu_torch/csrc/blend_bwd.cu",
        "replaces": "gaussiansplatting_tpu/ops/pallas_blend.py:671",
        "launches": train_bwd,
        "launches_by_path": {"train": train_bwd},
        "max_abs_err": bwd_err,
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
    }], "render_ms_per_frame": frame_ms, "train_step_ms": step_ms}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
