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
  6. tfloor   the exact T-floor path (RasterConfig.t_floor_exact=True): both
              T-floor kernels against their plain versions under the flip
              rule (FLIP_* below) on edge windows and at full size with the
              real logti and the real loss cotangent of each pass (the
              backward launched twice, bit-identical; the first pass's
              backward too); the float64-cumsum logti against compose's
              float32 one; the full-size T-floor frame (0 < max|img_tf - img|
              <= 1.5e-4) and train step (timed, replayed bit for bit); a
              64x48 T-floor step on a dense scene on the card against the
              CPU.  All four kernel entries must launch on this path.
  7. trainloop the COLMAP trainer (tools.train) end to end: the 100k scene
              written as a COLMAP scene with the port's writers (its points
              with their SH DC colours, 8 orbit views at 800x608, ground
              truth rendered on the card as PPM); 36 iterations through the
              CLI (6 views, 2 held out, 6 epochs) with the default Config
              but for a shortened density schedule (TRAINLOOP_* below):
              every step finite and without overflow, densify at 16, 24, 32
              and the opacity reset at 24 with `alive` a prefix after each,
              PSNR rising between events (by view), both kernels launched
              once per step, the eval line, a PLY of the final alive
              count; a CLI resume from 36 to 42; a bit-exact resume across
              a density event at full capacity (524,288 slots) and a
              replayed densify_step; the density event on the card against
              the CPU (integers exact); the step's time at two pair
              capacities and its device-time breakdown (torch.profiler) at
              iterations 0 and 36; the density event, opacity reset,
              checkpoint and CLI iteration times.

Prints one JSON line describing the kernels, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import importlib.util
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
# T-floor kernels vs plain: the kernel sums the in-block log T lane by lane,
# the plain version by cumsum, so where a pixel's exclusive log T + logti
# lands within rounding of log(1e-4) the two may stop it at different lanes
# (a flip: S_b moves by up to 4.6, colour by up to ~1e-4).  An entry beyond
# the bar is excused only where the plain version's termination margin at
# that (block, pixel) is below FLIP_MARGIN (in the backward, the whole block
# of such a pixel); the excused (block, pixel) entries may be at most
# FLIP_MAX_SHARE of all.
FLIP_MARGIN = 1e-4
FLIP_MAX_SHARE = 1e-4
# the tail the floor skips sums to at most T_stop <= 1e-4 per channel, plus
# float32 noise
TFLOOR_IMG_MAX = 1.5e-4
TFLOOR_TIMED_STEPS = 5
# seed of the dense 64x48 T-floor scene (dense_scene): its termination
# margins on the CPU are far from any flip
DENSE_SEED = 3
# a view-space gradient norm below this fraction of the largest is float
# noise: a Gaussian behind every pixel's floor gets exactly zero gradient in
# exact arithmetic, and a residue of the global-cumsum cancellation in
# compose's backward on one device (tests/test_torch_tfloor.py)
VS_NOISE_REL = 1e-7
# phase 7: the COLMAP trainer on the 100k scene's points.  The default
# Config with one cut, the density schedule shortened so that densify fires
# at 16, 24, 32 and the opacity reset at 24 within 36 iterations (6
# training views, 2 held out, 6 epochs); every threshold keeps its value
TRAINLOOP_VIEWS = 8
TRAINLOOP_EPOCHS = 6
TRAINLOOP_DENSIFY_FROM = 8
TRAINLOOP_DENSIFY_EVERY = 8
TRAINLOOP_RESET_EVERY = 24
TRAINLOOP_DENSIFY_AT = [16, 24, 32]
TRAINLOOP_RESET_AT = [24]
TRAINLOOP_CKPT_EVERY = 16
# the smallest power of two above the run's peak (3,439,743 pairs after the
# densify at 32 on the H100); the step's compose and sorts scale with it
TRAINLOOP_PAIR_CAPACITY = 1 << 22
# the step's device-time breakdown (_step_breakdown): steps profiled, kernels
# printed
STEP_PROFILE_STEPS = 3
STEP_PROFILE_TOP = 12
# density on the card vs the CPU (density_case): floats are moved, or
# computed by the same few rounded operations on both devices
DENSITY_ATOL = 1e-6
DENSITY_SEED = 7
DENSITY_EXTENT = 4.0
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
    pil = importlib.util.find_spec("PIL") is not None
    log(f"[device] PIL {'installed' if pil else 'not installed'}")
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


def edge_logti(nb, seed, p2=256):
    """logti [nb, p2] for edge windows: pixels that arrive at or below the
    floor (logti <= log(1e-4)), that terminate inside the block, and a
    quarter (logti = 0) that a block's S seldom drives below the floor."""
    import math

    import numpy as np

    rng = np.random.default_rng(seed)
    logti = (math.log(1e-4) + rng.uniform(-1.0, 4.0, (nb, p2))).astype(np.float32)
    logti[:, : p2 // 4] = 0.0
    return logti


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


def _compare_small_step(dev_state, dev_m, cpu_state, cpu_m, lrs, label="64x48 step",
                        vs_noise_rel=None, noise_lrs=2):
    """The 64x48 step on the card against the CPU step (see STEP_* above).
    With ``vs_noise_rel``, grad_count may differ only for Gaussians whose
    view-space gradient (grad_accum, one step from zero) is below that
    fraction of the largest on both devices (see VS_NOISE_REL).  Elements
    below the gradient noise may differ by ``noise_lrs`` learning rates."""
    import numpy as np

    from gaussiansplatting_tpu_torch.train.optimizer import TRAINABLE
    from gaussiansplatting_tpu_torch.train.state import state_to_numpy

    got, ref = state_to_numpy(dev_state), state_to_numpy(cpu_state)
    if vs_noise_rel is not None:
        differ = got["accum/grad_count"] != ref["accum/grad_count"]
        for acc in (got["accum/grad_accum"], ref["accum/grad_accum"]):
            if (acc[differ] > vs_noise_rel * acc.max()).any():
                raise AssertionError(f"{label}: grad_count differs beyond noise")
        log(f"[tfloor] {label}: {int(differ.sum())} grad_count entries differ, "
            f"all at noise-level view-space gradients")
        got["accum/grad_count"] = ref["accum/grad_count"]
    loss_err = abs(float(dev_m.loss) - float(cpu_m.loss))
    if loss_err > STEP_LOSS_RTOL * abs(float(cpu_m.loss)):
        raise AssertionError(f"{label}: loss {float(dev_m.loss)} vs {float(cpu_m.loss)}")
    worst = {}
    lr = dict(zip(TRAINABLE, lrs))
    for f in TRAINABLE:
        for mom in ("m", "v"):
            a, b = got[f"opt/{mom}/{f}"], ref[f"opt/{mom}/{f}"]
            err = float(np.abs(a - b).max())
            if err > STEP_MOMENT_REL * float(np.abs(b).max()):
                raise AssertionError(f"{label}: opt/{mom}/{f} max|err| {err:.3e}")
            worst[f"{mom}/{f}"] = err
        m = np.abs(ref[f"opt/m/{f}"])
        signal = m > NOISE_REL * m.max()
        diff = np.abs(got[f"params/{f}"] - ref[f"params/{f}"])
        if diff[signal].max(initial=0.0) > STEP_ATOL or diff.max() > noise_lrs * lr[f] + 1e-6:
            raise AssertionError(f"{label}: params/{f} max|err| {diff.max():.3e}")
        worst[f] = float(diff.max())
    if not np.array_equal(got["accum/grad_count"], ref["accum/grad_count"]):
        raise AssertionError(f"{label}: accum/grad_count differs")
    log(f"[train] {label} card vs CPU: loss |err| {loss_err:.2e}; max|err| "
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


def _compare_tf(label, got, want, margin):
    """T-floor forward kernel vs plain under the flip rule (FLIP_* above).
    Returns (max |err| outside the excused entries, excused count)."""
    import torch

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: kernel output has non-finite values")
    err = (got - want).abs()                                        # [NB, 4, P2]
    bad = (err > KERNEL_ATOL + KERNEL_RTOL * want.abs()).any(1)     # [NB, P2]
    near = margin < FLIP_MARGIN
    if bool((bad & ~near).any()):
        raise AssertionError(f"{label}: T-floor kernel disagrees with the plain "
                             f"version away from any termination boundary")
    excused = bad & near
    n_excused = int(excused.sum())
    worst = float(err.masked_fill(excused[:, None, :], 0.0).max()) if err.numel() else 0.0
    log(f"[tfloor] {label}: max|err| {worst:.3e} outside flips; excused flips "
        f"{n_excused} of {bad.numel()} (block, pixel) entries; margin < "
        f"{FLIP_MARGIN}: {int(near.sum())}")
    if n_excused > FLIP_MAX_SHARE * bad.numel():
        raise AssertionError(f"{label}: {n_excused} termination flips")
    return worst, n_excused


def _compare_tf_bwd(label, got, want, margin):
    """T-floor backward kernel vs plain, per column within BWD_REL of the
    column's largest plain magnitude; a block beyond that is excused only
    if one of its pixels has a margin below FLIP_MARGIN, and the excused
    blocks' near-boundary (block, pixel) entries count against
    FLIP_MAX_SHARE.  Returns (max |err| outside excused blocks, count)."""
    import torch

    near = margin < FLIP_MARGIN                                     # [NB, P2]
    near_block = near.any(1)
    bad_block = torch.zeros_like(near_block)
    errs = []
    for k, p in zip(got, want):
        if not bool(torch.isfinite(k).all()):
            raise AssertionError(f"{label}: kernel column has non-finite values")
        err = (k - p).abs()
        scale = float(p.abs().max()) if p.numel() else 0.0
        bad_block |= (err > BWD_REL * scale).any(1)
        errs.append(err)
    if bool((bad_block & ~near_block).any()):
        raise AssertionError(f"{label}: T-floor backward kernel disagrees with the "
                             f"plain version away from any termination boundary")
    n_excused = int(near[bad_block].sum())
    keep = ~bad_block
    worst = max(float(e[keep].max()) if bool(keep.any()) else 0.0 for e in errs)
    rel = [float(e[keep].max()) / max(float(p.abs().max()), 1e-30)
           if bool(keep.any()) else 0.0 for e, p in zip(errs, want)]
    log(f"[tfloor bwd] {label}: max|err| {worst:.3e} outside excused blocks "
        f"(per column err/max: {', '.join(f'{r:.1e}' for r in rel)}); excused "
        f"blocks {int(bad_block.sum())} holding {n_excused} near-boundary "
        f"(block, pixel) entries of {near.numel()}")
    if n_excused > FLIP_MAX_SHARE * near.numel():
        raise AssertionError(f"{label}: {n_excused} termination flips")
    return worst, n_excused


def _blend_wrappers():
    """The four kernel entries' wrappers, each with its launch count."""
    from gaussiansplatting_tpu_torch.ops import blend

    return (blend.windowed_blend_fwd, blend.windowed_blend_fwd_tf,
            blend.windowed_blend_bwd, blend.windowed_blend_bwd_tf)


def _tf_launches():
    return {f.__name__: f.launches for f in _blend_wrappers()}


def _reset_launches():
    for f in _blend_wrappers():
        f.launches = 0


def dense_scene(seed, device=None):
    """A dense near-opaque scene where transmittance crosses the floor
    (tests/test_render_forward.py:93-96: spread 0.15, raw opacity + 4)."""
    from gaussiansplatting_tpu_torch.core import gaussians
    from gaussiansplatting_tpu_torch.utils import synthetic

    p = synthetic.make_scene(256, seed=seed, spread=0.15, log_scale_range=(-3.2, -1.8))
    host = {f: getattr(p, f).detach().cpu().numpy() for f in gaussians.FIELDS}
    host["raw_opacities"] = host["raw_opacities"] + 4.0
    return gaussians.params_from_numpy(host, device)


def _tf_pass_cotangents(args, out, block_tile, camera, cfg_tf, gt, log_thr):
    """The full-size logti and the real loss cotangent of each pass: compose
    at the first pass's ``out`` with the T-floor kernel as its second pass,
    then autograd of the default photometric loss.  Returns (logti, out_tf,
    g_first, g_tf)."""
    import torch

    from gaussiansplatting_tpu_torch.config import LossConfig
    from gaussiansplatting_tpu_torch.ops import blend
    from gaussiansplatting_tpu_torch.ops.losses import photometric_loss
    from gaussiansplatting_tpu_torch.ops.rasterize import compose

    held = {}

    def blend_tfloor(logti):
        held["logti"] = logti
        held["out_tf"] = blend.windowed_blend_fwd_tf(*args, logti, log_thr).requires_grad_(True)
        return held["out_tf"][:, :3, :], held["out_tf"][:, 3, :]

    with torch.enable_grad():
        out1 = out.detach().requires_grad_(True)
        img = compose(out1, block_tile, camera, cfg_tf, blend_tfloor)
        rep = photometric_loss(img, gt, LossConfig())
        g1, g2 = torch.autograd.grad(rep.grad_loss, [out1, held["out_tf"]])
    if float(g1[:, :3].abs().max()) != 0.0:
        raise AssertionError("first-pass cotangent has nonzero colour rows")
    return held["logti"], held["out_tf"].detach(), g1, g2


def phase_tfloor(params, camera, cfg, gt, smi):
    import math

    import numpy as np
    import torch

    from gaussiansplatting_tpu_torch.config import Config
    from gaussiansplatting_tpu_torch.core import gaussians
    from gaussiansplatting_tpu_torch.ops import blend
    from gaussiansplatting_tpu_torch.ops.projection import num_tiles
    from gaussiansplatting_tpu_torch.ops.rasterize import (
        blend_windows, compose, incoming_log_t, render)
    from gaussiansplatting_tpu_torch.train import schedule
    from gaussiansplatting_tpu_torch.train import state as state_mod
    from gaussiansplatting_tpu_torch.train.trainer import train_step
    from gaussiansplatting_tpu_torch.utils import synthetic

    cfg_tf = cfg.replace(t_floor_exact=True)
    log_thr = math.log(cfg_tf.transmittance_floor)
    res = {}

    # (i) kernels #5 and #6 against their plain versions on edge windows
    for block in (16, 128):
        for row0 in (0, 3):
            table, src, valid, tile = (
                torch.from_numpy(x).to(DEVICE)
                for x in edge_windows(block, seed=block + row0, row0=row0))
            nb = src.shape[0]
            logti = torch.from_numpy(edge_logti(nb, block + row0 + 2)).to(DEVICE)
            g = torch.from_numpy(np.random.default_rng(block + row0 + 1).normal(
                size=(nb, 4, 256)).astype(np.float32)).to(DEVICE)
            args = (table, src, valid, tile, row0, block,
                    (16, cfg.power_floor, cfg.alpha_cap, cfg.alpha_floor, 50))
            with torch.no_grad():
                got = blend.windowed_blend_fwd_tf(*args, logti, log_thr)
                want, margin = blend.windowed_blend_fwd_tf_plain(
                    *args, logti, log_thr, return_margin=True)
            torch.cuda.synchronize()
            _compare_tf(f"edge B={block} row0={row0}", got, want, margin)
            bargs = args[:6] + (g, args[6], logti, log_thr)
            got = blend.windowed_blend_bwd_tf(*bargs)
            torch.cuda.synchronize()
            _compare_tf_bwd(f"edge B={block} row0={row0}", got,
                            blend.windowed_blend_bwd_tf_plain(*bargs), margin)

    # (ii) at full size: the real logti and the real cotangent of each pass
    args, block_tile, _ = blend_windows(params, camera, cfg_tf)
    with torch.no_grad():
        out, _ = blend.windowed_blend_fwd(*args)
    logti, out_tf, g1, g2 = _tf_pass_cotangents(args, out, block_tile, camera,
                                                cfg_tf, gt, log_thr)
    with torch.no_grad():
        want, margin = blend.windowed_blend_fwd_tf_plain(*args, logti, log_thr,
                                                         return_margin=True)
        res["fwd_err"], res["fwd_excused"] = _compare_tf("full size", out_tf, want, margin)
        res["fwd_ms"] = cuda_time_ms(lambda: blend.windowed_blend_fwd_tf(*args, logti, log_thr),
                                     reps=20)
        res["fwd_plain_ms"] = cuda_time_ms(
            lambda: blend.windowed_blend_fwd_tf_plain(*args, logti, log_thr), reps=3)
        bargs = args[:6] + (g2, args[6], logti, log_thr)
        got = blend.windowed_blend_bwd_tf(*bargs)
        again = blend.windowed_blend_bwd_tf(*bargs)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("T-floor backward kernel: two launches differ")
        log("[tfloor bwd] full size: two launches bit-identical")
        res["bwd_err"], res["bwd_excused"] = _compare_tf_bwd(
            "full size (loss cotangent)", got, blend.windowed_blend_bwd_tf_plain(*bargs),
            margin)
        res["bwd_ms"] = cuda_time_ms(lambda: blend.windowed_blend_bwd_tf(*bargs), reps=20)
        res["bwd_plain_ms"] = cuda_time_ms(
            lambda: blend.windowed_blend_bwd_tf_plain(*bargs), reps=3)
        # kernel #4: the first pass's backward, on its own cotangent (S_b only)
        b1 = args[:6] + (g1, args[6])
        _compare_bwd("first pass (as _bwd_kernel)", blend.windowed_blend_bwd(*b1),
                     blend.windowed_blend_bwd_plain(*b1))
    log(f"[tfloor] full size: fwd_tf kernel {res['fwd_ms']:.4f} ms, plain "
        f"{res['fwd_plain_ms']:.3f} ms; bwd_tf kernel {res['bwd_ms']:.4f} ms, plain "
        f"{res['bwd_plain_ms']:.3f} ms (CUDA events) on {smi}")

    # (iii) the precision of logti: compose's float32 global cumsum against
    # the same cumsum in float64 (a measurement; compose keeps JAX's form)
    with torch.no_grad():
        ts = cfg.tile_size
        nt = num_tiles(camera.width, ts) * num_tiles(camera.height, ts)
        logti64 = incoming_log_t(out[:, 3].double(), block_tile, nt).float()
        out64 = blend.windowed_blend_fwd_tf(*args, logti64, log_thr)
        moved = out64[:, 3] != out_tf[:, 3]                         # [NB, P2]
        p = torch.arange(ts * ts, device=out.device)
        pix = (block_tile.long()[:, None] * (ts * ts) + p)[moved]
        img32 = compose(out, block_tile, camera, cfg_tf, lambda _: (out_tf[:, :3], out_tf[:, 3]))
        img64 = compose(out, block_tile, camera, cfg_tf, lambda _: (out64[:, :3], out64[:, 3]))
        live = out[:, 3] < 0
        d_logti = float((logti - logti64).abs()[live].max())
    res["logti_pixels"] = int(torch.unique(pix).numel())
    res["logti_img_err"] = float((img32 - img64).abs().max())
    log(f"[tfloor] logti float32 vs float64 cumsum: max|d logti| {d_logti:.3e}; "
        f"{int(moved.sum())} (block, pixel) entries in {res['logti_pixels']} image "
        f"pixels terminate at another lane; max image difference "
        f"{res['logti_img_err']:.3e}")

    # (iv) the T-floor render main path at full size
    with torch.no_grad():
        img, _ = render(params, camera, cfg)
    _reset_launches()
    with torch.no_grad():
        img_tf, aux = render(params, camera, cfg_tf)
    torch.cuda.synchronize()
    render_launches = _tf_launches()
    _check_image("T-floor canonical", img_tf)
    diff = float((img_tf - img).abs().max())
    num_pairs = int(aux.num_pairs)
    log(f"[tfloor] render main path: launches {render_launches}; num_pairs "
        f"{num_pairs}, overflow {bool(aux.overflow)}; max|img_tf - img| {diff:.3e}")
    if bool(aux.overflow) or abs(num_pairs - SCENE_NUM_PAIRS) > PAIRS_REL_TOL * SCENE_NUM_PAIRS:
        raise AssertionError(f"T-floor render: num_pairs {num_pairs}")
    if not 0.0 < diff <= TFLOOR_IMG_MAX:
        raise AssertionError(f"T-floor render: max|img_tf - img| {diff:.3e} not in "
                             f"(0, {TFLOOR_IMG_MAX}]")
    if min(render_launches["windowed_blend_fwd"], render_launches["windowed_blend_fwd_tf"]) < 1:
        raise AssertionError("the T-floor render did not launch both forward kernels")

    def frame():
        with torch.no_grad():
            render(params, camera, cfg_tf)

    res["frame_ms"] = cuda_time_ms(frame, reps=10)
    log(f"[tfloor] canonical view: {res['frame_ms']:.3f} ms/frame warm (CUDA events, "
        f"10 frames) on {smi}")

    # (v) the T-floor train step main path at full size: warm, timed, replayed
    tcfg = Config(raster=cfg_tf)
    state0 = state_mod.create(params)
    _reset_launches()
    state1, m1 = train_step(state0, camera, gt, tcfg, TRAIN_TOTAL_ITERS)
    st, flags, losses = state1, [m1.overflow], [m1.loss]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TFLOOR_TIMED_STEPS):
        st, m = train_step(st, camera, gt, tcfg, TRAIN_TOTAL_ITERS)
        flags.append(m.overflow)
        losses.append(m.loss)
    end.record()
    torch.cuda.synchronize()
    train_launches = _tf_launches()
    res["step_ms"] = start.elapsed_time(end) / TFLOOR_TIMED_STEPS
    losses = torch.stack(losses).cpu().numpy()
    log(f"[tfloor] full-size T-floor step: {res['step_ms']:.3f} ms/step warm (CUDA "
        f"events, {TFLOOR_TIMED_STEPS} steps) on {smi}; loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}; launches {train_launches}")
    if not np.isfinite(losses).all() or bool(torch.stack(flags).any()):
        raise AssertionError("T-floor train step: non-finite loss or overflow")
    _check_finite_state("T-floor train step", st)
    if min(train_launches.values()) < 1:
        raise AssertionError(f"the T-floor step did not launch every kernel: {train_launches}")
    replay, _ = train_step(state0, camera, gt, tcfg, TRAIN_TOTAL_ITERS)
    a, b = state_mod.state_to_numpy(state1), state_mod.state_to_numpy(replay)
    differ = [k for k in a if not np.array_equal(a[k], b[k])]
    if differ:
        raise AssertionError(f"replayed T-floor step differs in {differ}")
    log(f"[tfloor] replayed full-size T-floor step: all {len(a)} state arrays bit-identical")

    # (vi) a 64x48 T-floor step on the dense scene, card against CPU
    small = dense_scene(DENSE_SEED)
    small_cfg = tcfg.replace(raster=cfg_tf.replace(pair_capacity=8192, pair_block=16))
    small_gt = np.random.default_rng(3).uniform(0, 1, (48, 64, 3)).astype(np.float32)
    host = {f: getattr(small, f).detach().numpy() for f in gaussians.FIELDS}
    cpu_state, cpu_m = train_step(
        state_mod.create(small), synthetic.make_canonical_camera(64, 48),
        torch.from_numpy(small_gt), small_cfg, 100)
    dev_state, dev_m = train_step(
        state_mod.create(gaussians.params_from_numpy(host, DEVICE)),
        synthetic.make_canonical_camera(64, 48, device=DEVICE),
        torch.from_numpy(small_gt).to(DEVICE), small_cfg, 100)
    # a Gaussian behind every pixel's floor has an exactly zero gradient on
    # one device and noise on the other (VS_NOISE_REL), so Adam moves it by
    # lr * sign(noise) on one side only; quaternions renormalize after the
    # move, which scales a component's move by up to 1 + |q . sign| <= 3
    # (the bar tests/test_torch_train.py holds)
    _compare_small_step(dev_state, dev_m, cpu_state, cpu_m,
                        schedule.learning_rates(small_cfg.optim, 0, 100),
                        label="64x48 T-floor step", vs_noise_rel=VS_NOISE_REL,
                        noise_lrs=3)
    launches = {k: render_launches[k] + train_launches[k] for k in render_launches}
    return launches, res


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


def orbit_poses(means, n_views, width, height):
    """COLMAP poses (quat_wxyz, t, name) and the shared focal of
    ``n_views`` orbit views that frame the point cloud, as tools.render's
    orbit frames a PLY (radius 2.5x the 90th-percentile spread, 60-degree
    vertical FoV, 15 degrees elevation)."""
    import math

    import numpy as np

    from gaussiansplatting_tpu_torch.core import camera as camera_mod

    center = means.mean(axis=0)
    spread = float(np.percentile(np.linalg.norm(means - center, axis=1), 90))
    radius = max(spread * 2.5, 1e-3)
    focal = height / (2.0 * math.tan(math.radians(60.0) / 2.0))
    poses = []
    for i in range(n_views):
        cam = camera_mod.orbit_camera(center, radius, azimuth=2.0 * math.pi * i / n_views,
                                      elevation=math.radians(15.0), fx=focal, fy=focal,
                                      width=width, height=height)
        view = cam.view.numpy()
        poses.append((camera_mod.rotmat_to_quat_wxyz(view[:3, :3]),
                      view[:3, 3].astype(np.float32), f"view_{i:03d}.ppm"))
    return poses, focal


def write_colmap_scene(root, params, n_views, width, height, raster):
    """A COLMAP scene of ``params`` under ``root``: points3D.bin holds every
    Gaussian's centre with its SH DC colour, images.bin ``n_views`` orbit
    poses, cameras.bin their shared pinhole camera, images/ the port's
    render of ``params`` from each pose as PPM.  Returns the peak pair count
    of those renders."""
    import numpy as np
    import torch

    from gaussiansplatting_tpu_torch.core import camera as camera_mod
    from gaussiansplatting_tpu_torch.core.transforms import SH_C0
    from gaussiansplatting_tpu_torch.io import images
    from gaussiansplatting_tpu_torch.ops.rasterize import render
    from gaussiansplatting_tpu_torch.utils import scenegen

    sparse, image_dir = os.path.join(root, "sparse"), os.path.join(root, "images")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(image_dir, exist_ok=True)
    alive = params.alive.cpu().numpy()
    means = params.means.detach().cpu().numpy()[alive]
    colors = np.clip(SH_C0 * params.sh.detach().cpu().numpy()[alive, 0] + 0.5, 0.0, 1.0)
    poses, focal = orbit_poses(means, n_views, width, height)
    scenegen.write_points_bin(os.path.join(sparse, "points3D.bin"), means, colors)
    scenegen.write_images_bin(os.path.join(sparse, "images.bin"), poses)
    scenegen.write_cameras_bin(os.path.join(sparse, "cameras.bin"), focal, focal,
                               width / 2.0, height / 2.0, width, height)
    peak = 0
    for q, t, name in poses:
        cam = camera_mod.make_camera(q, t, focal, focal, width / 2.0, height / 2.0,
                                     width, height, device=params.means.device)
        with torch.no_grad():
            img, aux = render(params, cam, raster)
        if bool(aux.overflow):
            raise AssertionError(f"ground truth {name} overflowed pair_capacity")
        peak = max(peak, int(aux.num_pairs))
        images.save_ppm(os.path.join(image_dir, name), img.cpu().numpy())
    return sparse, image_dir, peak


def _check_prefix(label, params):
    alive = params.alive
    n = int(alive.sum())
    if not bool(alive[:n].all()) or bool(alive[n:].any()):
        raise AssertionError(f"{label}: alive is not a prefix")
    return n


def density_case(device, seed=DENSITY_SEED):
    """The 64-Gaussian scene of phases 5 and 6 (seed 5, spread 0.6) in 80
    slots with accumulators set so that one event prunes (three opacities at
    -6), clones, splits (DENSITY_EXTENT puts the split threshold inside the
    scale range) and hits the capacity clamp (more requests than the 16
    free slots).  Returns a TrainState whose generator is seeded ``seed``."""
    import numpy as np

    from gaussiansplatting_tpu_torch.train import state as state_mod
    from gaussiansplatting_tpu_torch.utils import synthetic

    small = synthetic.make_scene(64, seed=5, spread=0.6, capacity=80)
    host = state_mod.state_to_numpy(state_mod.create(small))
    host["params/raw_opacities"][[3, 17, 40]] = -6.0
    rng = np.random.default_rng(seed)
    host["accum/grad_accum"][:64] = rng.uniform(0.0, 8e-4, 64).astype(np.float32)
    host["accum/grad_count"][:64] = rng.integers(1, 4, 64).astype(np.int32)
    host["opt/m/means"] = rng.normal(0, 1e-3, host["opt/m/means"].shape).astype(np.float32)
    host["opt/t"] = np.asarray(1000, np.int32)
    return state_mod.state_from_numpy(host, device, seed=seed)


def _compare_density(dev_state, dev_stats, cpu_state, cpu_stats, dev_plan, cpu_plan):
    """Density event on the card vs on the CPU: every integer output exact
    (stats, the decisions, every row's destinations, alive), floats within
    DENSITY_ATOL.  Returns the max float error."""
    import numpy as np

    from gaussiansplatting_tpu_torch.train.state import state_to_numpy

    for f in ("pruned", "cloned", "split", "count"):
        if int(getattr(dev_stats, f)) != int(getattr(cpu_stats, f)):
            raise AssertionError(f"density on the card: {f} differs from the CPU")
    for f in ("prune", "clone", "split", "primary_dst", "secondary_dst"):
        if not np.array_equal(getattr(dev_plan, f).cpu().numpy(), getattr(cpu_plan, f).numpy()):
            raise AssertionError(f"density on the card: {f} differs from the CPU")
    got, ref = state_to_numpy(dev_state), state_to_numpy(cpu_state)
    worst = 0.0
    for k in ref:
        if ref[k].dtype.kind == "f":
            err = float(np.abs(got[k] - ref[k]).max())
            worst = max(worst, err)
            if err > DENSITY_ATOL:
                raise AssertionError(f"density on the card: {k} max|err| {err:.3e}")
        elif not np.array_equal(got[k], ref[k]):
            raise AssertionError(f"density on the card: {k} differs from the CPU")
    if not np.array_equal(dev_state.generator.get_state().numpy(),
                          cpu_state.generator.get_state().numpy()):
        raise AssertionError("density on the card: generator state differs from the CPU")
    return worst


def _cli(argv, out_path):
    """tools.train.main(argv) with its console lines sent to ``out_path``."""
    import contextlib

    from gaussiansplatting_tpu_torch.tools import train as train_cli

    with open(out_path, "a") as out, contextlib.redirect_stdout(out):
        rc = train_cli.main(argv)
    if rc != 0:
        raise AssertionError(f"tools.train exited {rc}")


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _ply_vertex_count(path):
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"element vertex"):
                return int(line.split()[2])
            if line.strip() == b"end_header":
                break
    raise AssertionError(f"{path}: no vertex count")


def _psnr_rises(psnr, n_views, events):
    """Per stretch of iterations between density events (``events``: the
    iterations after which one ran), the views visited at least twice in it
    (iteration it visits view (it - 1) % n_views): [(first iteration, last
    iteration, mean PSNR at their first visits, at their last visits)].
    ``psnr[it - 1]`` is iteration it's."""
    cuts = [0] + sorted(set(events)) + [len(psnr)]
    out = []
    for lo, hi in zip(cuts, cuts[1:]):               # iterations lo + 1 .. hi
        pairs = [(it, it + n_views * ((hi - it) // n_views))
                 for it in range(lo + 1, min(lo + n_views, hi) + 1)]
        pairs = [(a, b) for a, b in pairs if b > a]
        if pairs:
            out.append((lo + 1, hi, float(sum(psnr[a - 1] for a, _ in pairs) / len(pairs)),
                        float(sum(psnr[b - 1] for _, b in pairs) / len(pairs))))
    return out


def _step_breakdown(st0, st36, cam, gt, cfg, smi):
    """Where the COLMAP trainer's step goes on the card: one train step from
    the state at iteration 0 (the SfM start) and at 36 (after the last
    densify), timed with CUDA events at pair capacities PAIR_CAPACITY (2^21)
    and TRAINLOOP_PAIR_CAPACITY, and a kernels-only torch.profiler breakdown of
    STEP_PROFILE_STEPS steps at TRAINLOOP_PAIR_CAPACITY (device ms per step,
    the STEP_PROFILE_TOP largest kernels).  Returns {label: device ms per
    step} from the profile."""
    import torch

    from gaussiansplatting_tpu_torch.train import trainer

    device_ms = {}
    for label, st in (("iteration 0", st0), ("iteration 36", st36)):
        alive = int(st.params.alive.sum())
        for pc in sorted({PAIR_CAPACITY, TRAINLOOP_PAIR_CAPACITY}):
            c = cfg.replace(raster=cfg.raster.replace(pair_capacity=pc))
            _, m = trainer.train_step(st, cam, gt, c, 36)
            ms = cuda_time_ms(lambda: trainer.train_step(st, cam, gt, c, 36), reps=3)
            log(f"[trainloop step] {label}: {alive} alive of {st.params.capacity} slots, "
                f"pair_capacity {pc}: {ms:.3f} ms/step (CUDA events, 3 steps), pairs "
                f"{int(m.num_pairs)}, overflow {bool(m.overflow)} on {smi}")
        c = cfg.replace(raster=cfg.raster.replace(pair_capacity=TRAINLOOP_PAIR_CAPACITY))
        trainer.train_step(st, cam, gt, c, 36)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(STEP_PROFILE_STEPS):
                trainer.train_step(st, cam, gt, c, 36)
            torch.cuda.synchronize()
        ka = prof.key_averages()
        per_step = 1e3 * STEP_PROFILE_STEPS             # profiler us -> ms per step
        device_ms[label] = sum(e.self_device_time_total for e in ka) / per_step
        log(f"[trainloop step] {label} profile at pair_capacity {TRAINLOOP_PAIR_CAPACITY}: "
            f"device time {device_ms[label]:.3f} ms/step (torch.profiler, "
            f"{STEP_PROFILE_STEPS} steps) on {smi}")
        for e in sorted(ka, key=lambda e: -e.self_device_time_total)[:STEP_PROFILE_TOP]:
            log(f"[trainloop step]   {e.self_device_time_total / per_step:8.3f} ms "
                f"x{e.count // STEP_PROFILE_STEPS:4d}  {e.key[:90]}")
    return device_ms


def phase_trainloop(params, smi):
    """The COLMAP trainer (tools.train) end to end: write the scene, train
    through the CLI, resume through the CLI, a bit-exact resume across a
    density event at full capacity, density on the card against the CPU,
    and the times of the density event, the opacity reset, checkpoints and
    the CLI's iterations."""
    import numpy as np
    import torch

    from gaussiansplatting_tpu_torch.config import Config
    from gaussiansplatting_tpu_torch.density import control
    from gaussiansplatting_tpu_torch.io.dataset import load_colmap_scene
    from gaussiansplatting_tpu_torch.ops import blend
    from gaussiansplatting_tpu_torch.train import checkpoint, trainer
    from gaussiansplatting_tpu_torch.train import state as state_mod

    root = os.path.join(SCRATCH, "trainloop")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    res = {}

    # (i) the scene: SfM points, orbit poses, ground truth rendered on the card
    cfg = Config(density=Config().density.replace(
        densify_from_iter=TRAINLOOP_DENSIFY_FROM, densify_interval=TRAINLOOP_DENSIFY_EVERY,
        opacity_reset_interval=TRAINLOOP_RESET_EVERY))
    t0 = time.time()
    sparse, image_dir, gt_peak = write_colmap_scene(
        root, params, TRAINLOOP_VIEWS, WIDTH, HEIGHT,
        cfg.raster.replace(pair_capacity=TRAINLOOP_PAIR_CAPACITY))
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    log(f"[trainloop] COLMAP scene: {int(params.alive.sum())} points, {TRAINLOOP_VIEWS} "
        f"orbit views {WIDTH}x{HEIGHT}, ground truth peak {gt_peak} pairs "
        f"({time.time() - t0:.2f} s)")

    # (ii) train through the CLI, with the density events and the step
    # timeline observed from outside
    ck = os.path.join(root, "ck")
    metrics_path = os.path.join(root, "metrics.jsonl")
    argv = ["--colmap", sparse, "--images", image_dir, "--config", cfg_path,
            "--output", os.path.join(root, "out.ply"), "--device", DEVICE,
            "--pair-capacity", str(TRAINLOOP_PAIR_CAPACITY), "--eval-split", "4",
            "--checkpoint-dir", ck, "--checkpoint-interval", str(TRAINLOOP_CKPT_EVERY),
            "--metrics", metrics_path]
    n_train = TRAINLOOP_VIEWS - len(range(0, TRAINLOOP_VIEWS, 4))
    iters = TRAINLOOP_EPOCHS * n_train
    events, stamps, spans = [], [], []        # spans: (start, seconds, what)
    originals = (trainer.train_step, trainer.densify_step, trainer.opacity_reset_step,
                 checkpoint.save)

    def train_step(*a, **k):
        out = originals[0](*a, **k)
        if len(stamps) in (0, iters - 1):          # after the first and the last step
            torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return out

    def timed(what, fn, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        spans.append((t, time.perf_counter() - t, what))
        return out

    def densify_step(*a, **k):
        st, stats = timed("density", originals[1], *a, **k)
        n = _check_prefix("densify", st.params)
        if n != int(stats.count):
            raise AssertionError(f"densify: {n} alive, stats say {int(stats.count)}")
        events.append(("densify", st.opt.t, tuple(int(x) for x in stats)))
        return st, stats

    def opacity_reset_step(*a, **k):
        st = timed("density", originals[2], *a, **k)
        _check_prefix("opacity reset", st.params)
        events.append(("reset", st.opt.t, None))
        return st

    _reset_launches()
    trainer.train_step, trainer.densify_step, trainer.opacity_reset_step = (
        train_step, densify_step, opacity_reset_step)
    checkpoint.save = lambda *a, **k: timed("checkpoint", originals[3], *a, **k)
    try:
        _cli(argv + ["--epochs", str(TRAINLOOP_EPOCHS)], os.path.join(root, "console.txt"))
    finally:
        (trainer.train_step, trainer.densify_step, trainer.opacity_reset_step,
         checkpoint.save) = originals
    torch.cuda.synchronize()
    launches = _tf_launches()
    lines = _read_jsonl(metrics_path)
    steps = [x for x in lines if x["event"] == "step"]
    psnr = np.array([x["psnr"] for x in steps])
    res["peak_pairs"] = max(x["pairs"] for x in steps)
    wall = stamps[-1] - stamps[0]
    res["iters_per_s"] = (iters - 1) / wall
    # the same window split on the host clock: density events and
    # checkpoints (each synchronized), the steps with their metric reads
    inside = {w: sum(s for t, s, x in spans if x == w and stamps[0] < t < stamps[-1])
              for w in ("density", "checkpoint")}
    res["loop_step_ms"] = 1e3 * (wall - sum(inside.values())) / (iters - 1)
    res["loop_density_s"], res["loop_checkpoint_s"] = inside["density"], inside["checkpoint"]
    epoch_psnr = psnr.reshape(TRAINLOOP_EPOCHS, n_train).mean(axis=1)      # logged only
    dens = [e for e in events if e[0] == "densify"]
    log(f"[trainloop] tools.train: {len(steps)} steps, density events {events}; mean PSNR "
        f"per epoch {np.round(epoch_psnr, 3).tolist()}; peak pairs {res['peak_pairs']} of "
        f"{TRAINLOOP_PAIR_CAPACITY}; launches {launches}")
    log(f"[trainloop] tools.train: {res['iters_per_s']:.3f} iterations/s over iterations "
        f"2-{iters} ({wall:.3f} s, host clock, synchronized): steps {res['loop_step_ms']:.2f} "
        f"ms each, density events {inside['density']:.3f} s, checkpoints "
        f"{inside['checkpoint']:.3f} s, on {smi}")
    if [x["iter"] for x in steps] != list(range(1, iters + 1)):
        raise AssertionError(f"expected step lines 1..{iters}")
    for x in steps:
        if not all(np.isfinite(x[f]) for f in ("loss", "l1", "dssim", "psnr", "mean_scale")):
            raise AssertionError(f"step {x['iter']}: non-finite metrics")
    if any(x["overflow"] for x in steps):
        raise AssertionError("a training step overflowed pair_capacity")
    if [e[1] for e in dens] != TRAINLOOP_DENSIFY_AT or \
            [e[1] for e in events if e[0] == "reset"] != TRAINLOOP_RESET_AT:
        raise AssertionError(f"density events {events}")
    if not any(s[1] + s[2] > 0 for _, _, s in dens):
        raise AssertionError("no density event cloned or split")
    logged = [x["msg"] for x in lines if x["event"] == "info" and "densify" in x["msg"]]
    if logged != [f"iter {it}: densify pruned={s[0]} cloned={s[1]} split={s[2]} total={s[3]}"
                  for _, it, s in dens]:
        raise AssertionError(f"densify log lines {logged}")
    # PSNR rises wherever no density event intervenes: within each stretch
    # of iterations between events, each view's PSNR at its last visit
    # against its first, averaged over the views seen twice in it (without
    # --shuffle iteration it trains view (it - 1) % n_train).  Across an
    # event it need not: the reset at 24 caps every opacity at 0.01, which
    # the 12 iterations after it cannot undo (the reference resets at 3,000
    # of 30,000 iterations)
    rises = _psnr_rises(psnr, n_train, TRAINLOOP_DENSIFY_AT + TRAINLOOP_RESET_AT)
    log(f"[trainloop] mean PSNR of the views seen twice between events, first visit -> "
        f"last: " + "; ".join(f"iterations {a}-{b}: {x:.3f} -> {y:.3f} dB"
                              for a, b, x, y in rises))
    if len(rises) < 2 or not all(y > x for _, _, x, y in rises):
        raise AssertionError(f"PSNR does not rise between events: {rises}")
    n_eval = TRAINLOOP_VIEWS - n_train
    if launches["windowed_blend_fwd"] != iters + n_eval or \
            launches["windowed_blend_bwd"] != iters:
        raise AssertionError(f"expected {iters + n_eval} forward and {iters} backward "
                             f"launches, got {launches}")
    ev = [x for x in lines if x["event"] == "eval"]
    ex = [x for x in lines if x["event"] == "export_ply"]
    state36, saved_cfg = checkpoint.load(os.path.join(ck, "latest.npz"), DEVICE)
    n_final = _check_prefix("final state", state36.params)
    if not ev or not np.isfinite(ev[0]["psnr"]) or not ex or state36.opt.t != iters:
        raise AssertionError("missing eval / export_ply line or final checkpoint")
    if ex[0]["alive"] != n_final or _ply_vertex_count(os.path.join(root, "out.ply")) != n_final:
        raise AssertionError("exported PLY does not hold the final alive count")
    log(f"[trainloop] eval {ev[0]['psnr']} dB on {ev[0]['views']} held-out views; PLY "
        f"{n_final} vertices = alive")
    res["launches"] = launches

    # (iii) resume through the CLI
    before = len(lines)
    _cli(argv + ["--resume", "--epochs", "1"], os.path.join(root, "console.txt"))
    lines = _read_jsonl(metrics_path)[before:]
    resumed = [x for x in lines if x["event"] == "resume"]
    trained = [x for x in lines if x["event"] == "trained"]
    more = [x["iter"] for x in lines if x["event"] == "step"]
    if not resumed or resumed[0]["iteration"] != iters or trained[-1]["iteration"] != iters + n_train \
            or more != list(range(iters + 1, iters + n_train + 1)):
        raise AssertionError(f"CLI resume: {resumed}, {trained}, steps {more}")
    log(f"[trainloop] CLI resume: from iteration {resumed[0]['iteration']} to "
        f"{trained[-1]['iteration']}")

    # (iv) bit-exact resume across a density event at full capacity
    scene = load_colmap_scene(sparse, image_dir, saved_cfg, device=DEVICE)
    views = [(c, torch.from_numpy(g).to(DEVICE)) for i, (c, g)
             in enumerate(zip(scene.cameras, scene.gt_images)) if i % 4]

    def across_event(st):
        for cam, gt in views[:2]:
            st, _ = trainer.train_step(st, cam, gt, saved_cfg, iters)
        st, stats = trainer.densify_step(st, scene.extent, views[1][0].fx, saved_cfg)
        st, _ = trainer.train_step(st, views[2][0], views[2][1], saved_cfg, iters)
        return st, stats

    path = os.path.join(root, "resume.npz")
    t0 = time.perf_counter()
    checkpoint.save(path, state36, saved_cfg)
    res["save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded, _ = checkpoint.load(path, DEVICE)
    torch.cuda.synchronize()
    res["load_s"] = time.perf_counter() - t0
    a, sa = across_event(state36)
    b, sb = across_event(loaded)
    da, db = state_mod.state_to_numpy(a), state_mod.state_to_numpy(b)
    differ = [k for k in da if not np.array_equal(da[k], db[k])]
    if differ or tuple(map(int, sa)) != tuple(map(int, sb)) or \
            not torch.equal(a.generator.get_state(), b.generator.get_state()):
        raise AssertionError(f"resume across a density event differs in {differ}")
    one, s1 = trainer.densify_step(a, scene.extent, views[0][0].fx, saved_cfg)
    two, s2 = trainer.densify_step(a, scene.extent, views[0][0].fx, saved_cfg)
    d1, d2 = state_mod.state_to_numpy(one), state_mod.state_to_numpy(two)
    if any(not np.array_equal(d1[k], d2[k]) for k in d1) or \
            not torch.equal(one.generator.get_state(), two.generator.get_state()):
        raise AssertionError("densify_step replayed from one state differs")
    log(f"[trainloop] resume across a density event at {state36.params.capacity} slots "
        f"(event {tuple(map(int, sa))}): all {len(da)} state arrays and the generator "
        f"bit-identical; densify_step replayed bit-identical")

    # (v) density on the card against the CPU
    cpu_state, dev_state = density_case("cpu"), density_case(DEVICE)
    cam_fx = torch.tensor(64 * 1.2, dtype=torch.float32)
    plans = [control.decide(st.params, st.accum, st.opt.t, DENSITY_EXTENT, fx,
                            2.0 * DENSITY_EXTENT, cfg.density)
             for st, fx in ((dev_state, cam_fx.to(DEVICE)), (cpu_state, cam_fx))]
    dev_out, dev_stats = trainer.densify_step(dev_state, DENSITY_EXTENT, cam_fx.to(DEVICE), cfg)
    cpu_out, cpu_stats = trainer.densify_step(cpu_state, DENSITY_EXTENT, cam_fx, cfg)
    stats = tuple(map(int, cpu_stats))
    grown = state_mod.grow(cpu_state, 160)
    unclamped = control.decide(grown.params, grown.accum, cpu_state.opt.t, DENSITY_EXTENT,
                               cam_fx, 2.0 * DENSITY_EXTENT, cfg.density)
    if min(stats[:3]) <= 0 or stats[3] != 80 or int(unclamped.stats.count) <= 80:
        raise AssertionError(f"density case does not prune, clone, split and clamp: {stats}")
    res["density_err"] = _compare_density(dev_out, dev_stats, cpu_out, cpu_stats, *plans)
    log(f"[trainloop] density 64 Gaussians in 80 slots (pruned, cloned, split, total) "
        f"{stats}, {int(unclamped.stats.count)} before the clamp: card = CPU in every "
        f"integer output, floats max|err| {res['density_err']:.3e}")

    # (vi) times at full capacity: the step's breakdown, the density
    # event, the opacity reset
    st0 = state_mod.create(scene.params, seed=saved_cfg.train.seed)
    res["step_device_ms"] = _step_breakdown(st0, state36, views[0][0], views[0][1],
                                            saved_cfg, smi)
    st = state36
    fx = views[0][0].fx
    res["densify_ms"] = cuda_time_ms(lambda: trainer.densify_step(st, scene.extent, fx, saved_cfg),
                                     reps=5)
    # its two halves: the draw on the CPU generator with the copy to the
    # card, and the event on the card
    res["draw_ms"] = cuda_time_ms(lambda: control.draw_split_offsets(
        state_mod.clone_generator(st.generator), st.params.capacity, DEVICE), reps=5)
    r = control.draw_split_offsets(state_mod.clone_generator(st.generator),
                                   st.params.capacity, DEVICE)
    res["apply_ms"] = cuda_time_ms(lambda: control.apply(
        st.params, st.opt, st.accum, st.opt.t, r, scene.extent, fx, 2.0 * scene.extent,
        saved_cfg.density), reps=5)
    res["reset_ms"] = cuda_time_ms(lambda: trainer.opacity_reset_step(st, saved_cfg), reps=5)
    log(f"[trainloop] at {st.params.capacity} slots: densify_step {res['densify_ms']:.3f} ms "
        f"(draw and copy {res['draw_ms']:.3f} ms, apply {res['apply_ms']:.3f} ms), "
        f"opacity_reset_step {res['reset_ms']:.3f} ms (CUDA events, 5 each); checkpoint "
        f"save {res['save_s']:.3f} s, load {res['load_s']:.3f} s ({os.path.getsize(path)} "
        f"bytes) on {smi}")
    shutil.rmtree(root)
    return res


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
    tf_launches, tf = phase_tfloor(params, camera, cfg, gt, smi)
    tl = phase_trainloop(params, smi)

    src = "gaussiansplatting_tpu_torch/csrc/"
    tpu = "gaussiansplatting_tpu/ops/pallas_blend.py:"
    log(json.dumps({"kernels": [{
        "name": "windowed_blend_fwd",
        "route": "cuda",
        "source": src + "blend_fwd.cu",
        "replaces": f"{tpu}601, {tpu}161",
        "launches": (render_launches + train_fwd + tf_launches["windowed_blend_fwd"]
                     + tl["launches"]["windowed_blend_fwd"]),
        "launches_by_path": {"render": render_launches, "train": train_fwd,
                             "tfloor": tf_launches["windowed_blend_fwd"],
                             "trainloop": tl["launches"]["windowed_blend_fwd"]},
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }, {
        "name": "windowed_blend_bwd",
        "route": "cuda",
        "source": src + "blend_bwd.cu",
        "replaces": f"{tpu}671, {tpu}188",
        "launches": (train_bwd + tf_launches["windowed_blend_bwd"]
                     + tl["launches"]["windowed_blend_bwd"]),
        "launches_by_path": {"train": train_bwd,
                             "tfloor": tf_launches["windowed_blend_bwd"],
                             "trainloop": tl["launches"]["windowed_blend_bwd"]},
        "max_abs_err": bwd_err,
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
    }, {
        "name": "windowed_blend_fwd_tf",
        "route": "cuda",
        "source": src + "blend_fwd.cu",
        "replaces": f"{tpu}249",
        "launches": tf_launches["windowed_blend_fwd_tf"],
        "launches_by_path": {"tfloor": tf_launches["windowed_blend_fwd_tf"]},
        "max_abs_err": tf["fwd_err"],
        "excused_flips": tf["fwd_excused"],
        "ms": tf["fwd_ms"],
        "plain_ms": tf["fwd_plain_ms"],
    }, {
        "name": "windowed_blend_bwd_tf",
        "route": "cuda",
        "source": src + "blend_bwd.cu",
        "replaces": f"{tpu}281",
        "launches": tf_launches["windowed_blend_bwd_tf"],
        "launches_by_path": {"tfloor": tf_launches["windowed_blend_bwd_tf"]},
        "max_abs_err": tf["bwd_err"],
        "excused_flips": tf["bwd_excused"],
        "ms": tf["bwd_ms"],
        "plain_ms": tf["bwd_plain_ms"],
    }], "render_ms_per_frame": frame_ms, "train_step_ms": step_ms,
        "tfloor_render_ms_per_frame": tf["frame_ms"],
        "tfloor_train_step_ms": tf["step_ms"],
        "tfloor_logti_f64_pixels": tf["logti_pixels"],
        "tfloor_logti_f64_max_img_err": tf["logti_img_err"],
        "trainloop_iters_per_s": tl["iters_per_s"],
        "trainloop_step_ms": tl["loop_step_ms"],
        "trainloop_density_s": tl["loop_density_s"],
        "trainloop_checkpoint_s": tl["loop_checkpoint_s"],
        "trainloop_peak_pairs": tl["peak_pairs"],
        "trainloop_step_device_ms": tl["step_device_ms"],
        "densify_step_ms": tl["densify_ms"],
        "densify_draw_ms": tl["draw_ms"],
        "density_apply_ms": tl["apply_ms"],
        "opacity_reset_step_ms": tl["reset_ms"],
        "checkpoint_save_s": tl["save_s"],
        "checkpoint_load_s": tl["load_s"],
        "density_card_vs_cpu_max_abs_err": tl["density_err"]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
