#!/usr/bin/env python3
"""On-GPU smoke test of the PyTorch port's render and training paths (one
NVIDIA card).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):
  1. device   require CUDA; print the card's name and power limit; pin fp32
              matmuls (no TF32), as the JAX package pins full precision.
  2. build    compile both windowed-blend CUDA sources (forward, backward)
              from csrc/ with nvcc, one process each, in parallel; print
              ptxas's registers and spills of every instance.
  3. kernel   the Hopper designs of the forward and backward kernels
              (gs_blend_fwd_win, gs_blend_bwd_win) against their plain
              PyTorch versions on the card: small edge-case windows (dead,
              partial, full and unaligned blocks, B = 16 and 128, row0 0 and
              3) and the full-size windows of the 100k-Gaussian scene's
              canonical 800x608 view (the backward given the forward's S_b
              and the real cotangent of the full-size loss, launched twice
              for bit-identical output; the forward's S_b equal to the
              first design's bit for bit).  The A/B: each Hopper kernel and
              its first design (gs_blend_*_win_v1, one thread per pixel,
              which nothing else calls) timed in turns (first, Hopper,
              Hopper, first) with CUDA events, the plain versions timed;
              the work the inputs need (_blend_work: power tests on the
              (warp, lane) pairs the box cull keeps, kept pairs) and from it
              each kernel's bound; the share of (warp, lane) pairs that
              entered the first design's backward shuffle tree.
  4. render   the render main path: the synthetic scene written to a PLY,
              rendered through tools.render (4 orbit views at 800x608), then
              the canonical view through ops.rasterize.render: no overflow,
              the scene's pair count, finite non-constant images, kernel
              launches counted; the frame timed and its device time
              profiled; a small render on the card against the CPU render.
  5. train    the training main path: tools.bench_train at its default size
              (PSNR must rise, no overflow); the full-size step (100k
              Gaussians, 800x608, random ground truth, default Config): warm,
              then timed and its device time profiled, finite and without
              overflow; one step replayed from the same state must give the
              same bits (its launches are the launches per step); a 64x48
              step on the card against the same step on the CPU.  Both
              kernels' launches counted.  Then the per-Gaussian reduction
              (ops.pairs.reduce_aligned_cotangents) at full size on the real
              loss cotangent against a float64 sum (REDUCE_REL_NORM per
              column), the float32 prefix's error beside it, and the float64
              scan's time at this frame's lanes and at 2^22 pairs'.
  6. tfloor   the exact T-floor path (RasterConfig.t_floor_exact=True): the
              Hopper T-floor kernels (gs_blend_fwd_win_tf, gs_blend_bwd_win_tf)
              against their plain versions under the flip rule (FLIP_* below)
              on edge windows and at full size with the real logti and the
              real loss cotangent of each pass (the backward given the
              forward's masked S_b and stop lanes, launched twice,
              bit-identical; the first pass's backward too, given that
              pass's S_b); the forward's S_b and stop lanes equal to the
              first design's (gs_blend_*_win_tf_v1) bit for bit, and the A/B
              of both designs in turns; the work the inputs need and each
              T-floor kernel's bound; compose's incoming log T
              (ops.rasterize.incoming_log_t) within one float32 ulp of a
              float64 per-tile prefix at full size, no (block, pixel)
              stopping at another lane beyond the flip rule, and its
              forward and backward timed; the full-size T-floor frame
              (0 < max|img_tf - img| <= 1.5e-4) and train step (timed,
              replayed bit for bit); a 64x48 T-floor step on a dense scene
              on the card against the CPU, grad_count exact.  All four
              kernel entries must launch on this path.
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

Every main path (phases 4-7) runs with the launch counts set to 0 before
it and read after it: each kernel of the path must have launched, and the
first design's entries never.

Prints one JSON line describing the kernels (per kernel: launches on the
main paths and per step, max_abs_err against the plain version, ms, ms_v1
(the first design's time in the same turns), plain_ms, bound_ms with
bound_by (the larger of
this run's bytes over the HBM rate and its instructions over the f32
instruction rate), the work behind it (power_tests, kept_pairs,
culled_share), library_ms (null: no single PyTorch call computes the
windowed blend)) and the paths' times, then as its last line
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
# phase 3: launches per CUDA-event time
KERNEL_REPS = 20
# the bound of a kernel (bound_ms): an H100 SXM's HBM rate and its f32
# instruction rate outside the tensor cores (NVIDIA's data sheet, at 700 W:
# its 67 TFLOP/s counts an FMA as two operations, so 33.5e12 instructions
# per second, 128 per SM per clock), and the instructions the blend needs,
# each separately rounded multiply, add, compare or FMA counted once: per
# (pixel, lane) power test 7 multiplies, 1 add, 1 subtraction and the 2
# window compares (11; dx and dy are shared along a column and a row); per
# kept pair in the forward op * exp, the floor compare, the cap,
# w = alpha T, 3 colour FMAs, T *= 1 - alpha and S += log1p (12); in the
# backward op * exp, the floor compare, the cap, 1 - alpha and its
# reciprocal, T, w, e (3), dl, dpow (3), dpow dx and dpow dy, the nine sums
# and the suffix (27).  exp, log1p and the reciprocal count as one each,
# though each takes several, so the bound stays a lower bound
HBM_BYTES_PER_S = 3.35e12
F32_INSTR_PER_S = 67e12 / 2
OPS_PER_TEST = 11
FWD_OPS_PER_KEPT = 12
BWD_OPS_PER_KEPT = 27
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
# per-Gaussian sums (phase 5): the relative norm of each column's error
# against a float64 sum
REDUCE_REL_NORM = 1e-6
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
# the device-time profiles (_device_profile) of the frame, the full-size
# step and the COLMAP trainer's step (_step_breakdown): calls profiled,
# kernels printed
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
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"count {torch.cuda.device_count()}")
    log(smi)
    pil = importlib.util.find_spec("PIL") is not None
    log(f"[device] PIL {'installed' if pil else 'not installed'}; max SM clock "
        f"{clock_mhz:.0f} MHz")
    return name, smi, clock_mhz


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


def _compare(label, got, want, quiet=False):
    """Kernel (out, gid) vs plain (out, gid); returns max |out| error.  With
    ``quiet`` it logs only a failure."""
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
    if not quiet or bool(bad.any()):
        log(f"[kernel] {label}: max|err| {max_err:.3e} (rows C,C,C,S: "
            f"{', '.join(f'{r:.2e}' for r in rows)}); beyond tolerance: "
            f"{int(bad.sum())} of {err.numel()}")
    if bool(bad.any()):
        raise AssertionError(f"{label}: kernel disagrees with the plain version")
    return max_err


def _turns(first, second, reps=KERNEL_REPS):
    """CUDA-event times of two launchers in turns (first, second, second,
    first), so a drift of the card's clock falls on both: returns (mean of
    first's two, mean of second's two, the four times)."""
    t = [cuda_time_ms(f, reps) for f in (first, second, second, first)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def _cull_extent(ca, cb, cc, op, power_floor, alpha_floor):
    """Half-extents (ex, ey) of each lane's padded ellipse box, as
    blend_common.cuh's cull_extent computes them: -inf where no pixel can
    keep the lane, +inf where the conic is too near singular to cull."""
    import torch

    inf = torch.full_like(op, float("inf"))
    thr = torch.fmax(torch.log(alpha_floor / op), torch.full_like(op, power_floor))
    thr = thr - (1e-3 + 1e-4 * thr.abs())
    det = ca * cc - cb * cb
    regular = (ca > 0) & (cc > 0) & (det > 0.1 * ca * cc)
    r = -2.0 * thr
    never = (op == 0) | (thr >= 0)
    ex = torch.where(regular, torch.sqrt(r * cc / det) * 1.001 + 0.01, inf)
    ey = torch.where(regular, torch.sqrt(r * ca / det) * 1.001 + 0.01, inf)
    return torch.where(never, -inf, ex), torch.where(never, -inf, ey)


def _blend_work(args, logti=None, log_thr=0.0, chunk=128):
    """What the blend's inputs need at ts = 16, counted from the plain
    replay on the card (ops.blend._replay) in chunks of blocks, for the
    Hopper designs' layouts (``fwd`` and ``bwd``: column strips of P pixels
    per thread, P from ops.blend.launch_geometry, of the T-floor instances
    with logti; a warp covers 16 x 2P pixels): the lanes each reads (``live_fwd``, ``live_bwd``); the kept
    pairs (with logti, those that survive the T-floor); per layout the
    (warp, lane) pairs on lanes with opacity (``pairs_*``), those whose
    padded box misses the warp's rectangle (``culled_*``), and on the rest
    the power tests the pixels need (``tests_*``).  Without logti a pixel
    tests every live lane.  With logti (the T-floor pass) the forward reads
    the lanes of blocks with a pixel above the floor and a pixel tests the
    lanes up to its first kept lane that fails (all, if none does; none if
    it arrives at or below the floor); the backward reads the lanes before
    the block's largest stop lane and a pixel tests the lanes before its
    own.  The backward's output depends on a pixel's cotangent and S_b
    only where the pixel keeps a lane (with logti: a surviving one, stop >
    0), ``bwd_pixels``; ``bwd_blocks`` counts the blocks whose lanes it
    reads (a live lane; with logti, a stop > 0).  Without logti, also the (warp,
    lane) pairs that enter the first design's backward shuffle tree (a warp
    = 32 consecutive pixels, lanes below block_valid) and the (warp, batch
    of 4 lanes) exchanges of the Hopper backward.  Raises if a kept pair
    lies in a culled (warp, lane) pair."""
    import torch
    import torch.nn.functional as F

    from gaussiansplatting_tpu_torch.ops import blend

    table, src, valid, tile, row0, block, consts = args
    ts, power_floor, _, alpha_floor, tiles_x = consts
    nb, p2 = src.shape[0], int(ts) ** 2
    if p2 != 256:
        raise ValueError(f"_blend_work counts 16 x 16 tiles, got tile_size {ts}")
    layouts = {d: p2 // blend.launch_geometry(ts, block, d == "bwd", tfloor=logti is not None)[0]
               for d in ("fwd", "bwd")}
    w = dict.fromkeys(("live_fwd", "live_bwd", "bwd_blocks", "bwd_pixels", "kept", "tree_v1",
                       "lanes_v1", "exchanges", "batches") + tuple(f"{c}_{d}" for c in ("pairs", "culled", "tests")
                                          for d in layouts), 0)
    w["pixels"] = layouts
    for k0 in range(0, nb, chunk):
        k1 = min(k0 + chunk, nb)
        r = blend._replay(table, src, valid, tile, row0, block, consts, k0, k1)
        kept = r.alpha > 0                                          # [K, P2, B]
        k, b = kept.shape[0], kept.shape[2]
        lane = torch.arange(b, device=kept.device)
        nv = r.live.sum(1)                                          # [K]
        if logti is None:
            surv = kept
            need = {d: nv[:, None].expand(k, p2) for d in layouts}   # [K, P2]
            w["live_fwd"] += int(nv.sum())
            w["live_bwd"] += int(nv.sum())
            w["bwd_blocks"] += int((nv > 0).sum())
            w["bwd_pixels"] += int(kept.any(-1).sum())
        else:
            arrive = torch.cumsum(r.log1m, -1) - r.log1m + logti[k0:k1, :, None]
            surv = kept & (arrive > log_thr)
            fail = torch.where(kept & ~surv, lane, b).amin(-1)       # [K, P2]
            open_px = logti[k0:k1] > log_thr
            stop = torch.where(surv, lane + 1, 0).amax(-1)
            need = {"fwd": torch.where(open_px, torch.minimum(fail + 1, nv[:, None]), 0),
                    "bwd": stop}
            w["live_fwd"] += int((nv * open_px.any(1)).sum())
            w["live_bwd"] += int(stop.amax(1).sum())
            w["bwd_blocks"] += int((stop.amax(1) > 0).sum())
            w["bwd_pixels"] += int((stop > 0).sum())
        w["kept"] += int(surv.sum())
        t = tile[k0:k1]
        mx = r.cols[1] - ((t % tiles_x).float() * 16 + 8)[:, None]    # [K, B]
        my = r.cols[2] - ((t // tiles_x + row0).float() * 16 + 8)[:, None]
        ex, ey = _cull_extent(r.cols[3], r.cols[4], r.cols[5], r.op, power_floor,
                              alpha_floor)
        has_op = (r.op > 0)[:, None, :]                              # [K, 1, B]
        for name, pixels in layouts.items():
            rows = 2 * pixels                  # a warp: 16 columns x rows
            warps = 16 // rows
            cy = (torch.arange(warps, device=kept.device) * rows
                  + (rows - 1) / 2.0 + 0.5 - 8.0)[None, :, None]   # [1, W, 1]
            meets = (((0.0 - mx).abs() <= 7.5 + ex)[:, None, :]
                     & ((cy - my[:, None, :]).abs() <= (rows - 1) / 2.0 + ey[:, None, :]))
            if bool((kept.reshape(k, warps, -1, b).any(2) & ~meets).any()):
                raise AssertionError(f"_blend_work ({name}): a kept pair lies outside "
                                     f"its lane's padded box")
            tested = has_op & meets                                 # [K, W, B]
            w[f"pairs_{name}"] += int(has_op.sum()) * warps
            w[f"culled_{name}"] += int((has_op & ~meets).sum())
            testers = (lane < need[name][:, :, None]).reshape(k, warps, -1, b).sum(2)
            w[f"tests_{name}"] += int((tested * testers).sum())
        if logti is None:
            w["tree_v1"] += int(kept.reshape(k, 8, 32, b).any(2).sum())
            w["lanes_v1"] += 8 * int(nv.sum())
            warps = p2 // (32 * layouts["bwd"])
            parts = F.pad(kept.reshape(k, warps, -1, b).any(2), (0, -b % 4))
            w["exchanges"] += int(parts.reshape(k, warps, -1, 4).any(3).sum())
            w["batches"] += warps * int(((nv + 3) // 4).sum())
    return w


def _bound(nbytes, ops):
    """(bound ms, what sets it): the larger of the bytes over the H100's HBM
    rate and the instructions over its f32 instruction rate (NVIDIA's data
    sheet)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_INSTR_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _work_bound(w, layout, nbytes, ops_per_kept):
    """A kernel's bound from _blend_work's counts for its layout: the
    kernels-line fields (bound_ms, bound_by, power_tests, kept_pairs,
    culled_share) and a log line of the work."""
    tests, kept = w[f"tests_{layout}"], w["kept"]
    ops = OPS_PER_TEST * tests + ops_per_kept * kept
    bound_ms, bound_by = _bound(nbytes, ops)
    res = {"bound_ms": bound_ms, "bound_by": bound_by, "power_tests": tests,
           "kept_pairs": kept, "culled_share": w[f"culled_{layout}"] / w[f"pairs_{layout}"]}
    line = (f"{w[f'live_{layout}']} lanes read; the box cull skips {w[f'culled_{layout}']} of "
            f"{w[f'pairs_{layout}']} (warp, lane) pairs ({res['culled_share']:.4f}); "
            f"{tests} power tests, {kept} kept pairs ({kept / max(tests, 1):.4f} of the "
            f"tests); {nbytes} bytes, {ops} instructions: bound {bound_ms:.4f} ms "
            f"({bound_by})")
    return res, line


def _edge_args(block, row0, cfg):
    import torch

    table, src, valid, tile = (torch.from_numpy(x).to(DEVICE)
                               for x in edge_windows(block, seed=block + row0, row0=row0))
    return (table, src, valid, tile, row0, block,
            (16, cfg.power_floor, cfg.alpha_cap, cfg.alpha_floor, 50))


def phase_kernel(params, camera, cfg, smi):
    """The forward: the Hopper design against the plain version on edge
    windows and at full size, its S_b against the first design's, the A/B
    against the first design in turns, and the work its inputs need.
    Returns the kernels-line numbers."""
    import torch

    from gaussiansplatting_tpu_torch.ops import blend
    from gaussiansplatting_tpu_torch.ops.rasterize import blend_windows

    for block in (16, 128):
        for row0 in (0, 3):
            args = _edge_args(block, row0, cfg)
            want = blend.windowed_blend_fwd_plain(*args)
            _compare(f"edge B={block} row0={row0}", blend.windowed_blend_fwd(*args), want)

    args, block_tile, aux = blend_windows(params, camera, cfg)
    nb = args[1].shape[0]
    live = int((args[2] > 0).sum())
    log(f"[kernel] full size: {nb} blocks ({live} live, {nb - live} dead), "
        f"B={args[5]}, {int(aux.num_pairs)} pairs")
    want = blend.windowed_blend_fwd_plain(*args)
    got = blend.windowed_blend_fwd(*args)
    res = {"max_abs_err": _compare("full size", got, want)}
    # both designs sum the same rounded log1pf terms in lane order, so S_b
    # agrees bit for bit, which a culled kept pair would break
    first = blend.windowed_blend_fwd_v1(*args)
    _compare("full size, first design", first, want)
    if not torch.equal(got[0][:, 3], first[0][:, 3]):
        raise AssertionError("S_b of the Hopper forward differs from the first design's")
    log("[kernel] full size: S_b of the Hopper design = the first design's, bit for bit")
    res["ms_v1"], res["ms"], turns = _turns(lambda: blend.windowed_blend_fwd_v1(*args),
                                            lambda: blend.windowed_blend_fwd(*args))
    log(f"[kernel] A/B in turns (first, Hopper, Hopper, first): "
        f"{', '.join(f'{t:.4f}' for t in turns)} ms (CUDA events, {KERNEL_REPS} launches "
        f"each) on {smi}")
    res["plain_ms"] = cuda_time_ms(lambda: blend.windowed_blend_fwd_plain(*args), reps=3)
    w = _blend_work(args)
    p2, block = 256, args[5]
    bound, line = _work_bound(w, "fwd", 40 * w["live_fwd"] + 12 * nb + 4 * nb * (4 * p2 + block),
                              FWD_OPS_PER_KEPT)
    res.update(bound)
    log(f"[kernel] forward work ({w['pixels']['fwd']} pixels per thread): {line}")
    return res, args, block_tile, w


def _compare_bwd(label, got, want, quiet=False):
    """Backward kernel vs plain: nine [NB, B] columns; each column's max
    error must be within BWD_REL of its largest plain magnitude.  Returns
    the max abs error over all columns; with ``quiet`` it logs only a
    failure."""
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
    if not quiet:
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


def phase_kernel_bwd(args, block_tile, camera, cfg, gt, w, smi, clock_mhz):
    """The backward: the Hopper design, given the forward's S_b, against the
    plain version on edge windows and at full size with the real loss
    cotangent, launched twice for the same bits; the A/B against the first
    design in turns; the share of (warp, lane) pairs that entered the first
    design's shuffle tree.  Returns the kernels-line numbers."""
    import numpy as np
    import torch

    from gaussiansplatting_tpu_torch.ops import blend

    for block in (16, 128):
        for row0 in (0, 3):
            e = _edge_args(block, row0, cfg)
            g = torch.from_numpy(np.random.default_rng(block + row0 + 1).normal(
                size=(e[1].shape[0], 4, 256)).astype(np.float32)).to(DEVICE)
            s_b = blend.windowed_blend_fwd(*e)[0][:, 3].contiguous()
            bargs = e[:6] + (g, s_b, e[6])
            want = blend.windowed_blend_bwd_plain(*bargs)
            _compare_bwd(f"edge B={block} row0={row0}", blend.windowed_blend_bwd(*bargs), want)
            _compare_bwd(f"edge B={block} row0={row0}, first design",
                         blend.windowed_blend_bwd_v1(*e[:6], g, e[6]), want, quiet=True)

    out, _ = blend.windowed_blend_fwd(*args)
    g = _loss_cotangent(out, block_tile, camera, cfg, gt)
    s_b = out[:, 3].contiguous()
    bargs = args[:6] + (g, s_b, args[6])
    got = blend.windowed_blend_bwd(*bargs)
    again = blend.windowed_blend_bwd(*bargs)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("backward kernel: two launches on the same inputs differ")
    log("[kernel bwd] full size: two launches bit-identical")
    want = blend.windowed_blend_bwd_plain(*bargs)
    res = {"max_abs_err": _compare_bwd("full size (loss cotangent)", got, want)}
    v1_args = args[:6] + (g, args[6])
    _compare_bwd("full size, first design", blend.windowed_blend_bwd_v1(*v1_args), want)
    res["ms_v1"], res["ms"], turns = _turns(lambda: blend.windowed_blend_bwd_v1(*v1_args),
                                            lambda: blend.windowed_blend_bwd(*bargs))
    log(f"[kernel bwd] A/B in turns (first, Hopper, Hopper, first): "
        f"{', '.join(f'{t:.4f}' for t in turns)} ms (CUDA events, {KERNEL_REPS} launches "
        f"each) on {smi}")
    res["plain_ms"] = cuda_time_ms(lambda: blend.windowed_blend_bwd_plain(*bargs), reps=3)
    nb, p2, block = args[1].shape[0], 256, args[5]
    # bytes: 40 per lane read, block_valid, block_src and tile of the blocks
    # with a live lane, g and s_b of the pixels that keep a lane, nine
    # columns out
    bound, line = _work_bound(w, "bwd", 40 * w["live_bwd"] + 4 * nb + 8 * w["bwd_blocks"]
                              + 20 * w["bwd_pixels"] + 36 * nb * block, BWD_OPS_PER_KEPT)
    res.update(bound)
    log(f"[kernel bwd] backward work ({w['pixels']['bwd']} pixels per thread): {line}")
    # the first design's shuffle tree: 45 shuffles per (warp, lane) that a
    # pixel of the warp kept, at one warp shuffle per clock per SM
    tree_ms = 45 * w["tree_v1"] / (132 * clock_mhz * 1e3)
    exch_ms = 54 * w["exchanges"] / (132 * clock_mhz * 1e3)
    log(f"[kernel bwd] first design: {w['tree_v1']} of {w['lanes_v1']} (warp, lane) pairs "
        f"({w['tree_v1'] / w['lanes_v1']:.4f}) enter the shuffle tree: "
        f"{45 * w['tree_v1']} warp shuffles, {tree_ms:.3f} ms at 132 SMs x {clock_mhz} MHz; "
        f"Hopper design ({w['pixels']['bwd']} pixels per thread): "
        f"{w['exchanges']} of {w['batches']} (warp, "
        f"batch of 4 lanes) exchanges ({w['exchanges'] / w['batches']:.4f}), "
        f"{54 * w['exchanges']} warp shuffles, {exch_ms:.3f} ms")
    res["tree_share_v1"] = w["tree_v1"] / w["lanes_v1"]
    return res


def _check_finite_state(label, state):
    import numpy as np

    from gaussiansplatting_tpu_torch.train.state import state_to_numpy

    for key, arr in state_to_numpy(state).items():
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            raise AssertionError(f"{label}: {key} has non-finite values")


def _compare_small_step(dev_state, dev_m, cpu_state, cpu_m, lrs, label="64x48 step",
                        noise_lrs=2):
    """The 64x48 step on the card against the CPU step (see STEP_* above);
    grad_count exactly.  Elements below the gradient noise may differ by
    ``noise_lrs`` learning rates."""
    import numpy as np

    from gaussiansplatting_tpu_torch.train.optimizer import TRAINABLE
    from gaussiansplatting_tpu_torch.train.state import state_to_numpy

    got, ref = state_to_numpy(dev_state), state_to_numpy(cpu_state)
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

    _reset_launches()

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
    _check_no_v1("the training path", _tf_launches())
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
    step_device_ms, _ = _device_profile(
        "[train] full-size step", lambda: train_step(st, camera, gt, cfg, TRAIN_TOTAL_ITERS),
        STEP_PROFILE_STEPS, smi)
    log(f"[train] main path: {launches[0]} windowed_blend_fwd and {launches[1]} "
        f"windowed_blend_bwd kernel launches")
    if min(launches) <= 0:
        raise AssertionError("the training path did not launch both kernels")

    # (iii) one step replayed from the same state gives the same bits; its
    # launches are the kernels' launches per step
    _reset_launches()
    replay, _ = train_step(state0, camera, gt, cfg, TRAIN_TOTAL_ITERS)
    torch.cuda.synchronize()
    per_step = _tf_launches()
    _check_no_v1("the training step", per_step)
    a, b = state_mod.state_to_numpy(state1), state_mod.state_to_numpy(replay)
    differ = [k for k in a if not np.array_equal(a[k], b[k])]
    if differ:
        raise AssertionError(f"replayed step differs in {differ}")
    log(f"[train] replayed full-size step: all {len(a)} state arrays bit-identical; "
        f"launches {per_step}")

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

    # (v) the per-Gaussian reduction at full size against float64
    red = _check_reduction(params, camera, cfg.raster, gt, smi)
    return launches, step_ms, step_device_ms, per_step, red


def _check_reduction(params, camera, raster, gt, smi):
    """ops.pairs.reduce_aligned_cotangents at full size on the real loss
    cotangent (the blend backward's nine columns of the canonical view's
    windows) against a float64 per-Gaussian sum on the CPU: each column's
    error within REDUCE_REL_NORM of its norm.  Beside it the same
    difference of a float32 prefix (the JAX package's form), and the times
    of the reduction, of that float32 form and of the float64 prefix sum
    alone, at this frame's lanes and at the lanes of 2^22 pairs.  Returns
    those numbers."""
    import torch
    import torch.nn.functional as F

    from gaussiansplatting_tpu_torch.ops import blend, pairs
    from gaussiansplatting_tpu_torch.ops.rasterize import _plan, _windows

    with torch.no_grad():
        plan = _plan(params, camera, raster)
        win = _windows(plan.data, plan.ints, plan.pcfg)
        args = (win.table, win.block_src, win.block_valid, win.tile, 0, raster.pair_block,
                plan.bconsts)
        out, gid = blend.windowed_blend_fwd(*args)
    g = _loss_cotangent(out, win.block_tile, camera, raster, gt)
    with torch.no_grad():
        dcols = blend.windowed_blend_bwd(*args[:6], g, out[:, 3].contiguous(), args[6])
        d_rows = torch.stack([c.reshape(-1) for c in dcols])            # [9, a_cap]
        gid = gid.reshape(-1).to(torch.int32)
        counts, n = plan.ints[0], plan.pcfg[0]
        got = pairs.reduce_aligned_cotangents(d_rows, gid, counts, n)
        live = gid >= 0
        ref = torch.zeros((n, 9), dtype=torch.float64).index_add_(
            0, gid[live].long().cpu(), d_rows[:, live].T.double().cpu())
        _, perm = torch.sort(torch.where(live, gid, n), stable=True)
        ends = torch.cumsum(counts, 0)

        def f32_form():
            csum = F.pad(pairs._prefix_sum(d_rows[:, perm]), (1, 0))
            return (csum[:, ends] - csum[:, ends - counts]).T

        def rel_norm(x):
            return float(((x.cpu().double() - ref).norm(dim=0) / ref.norm(dim=0)).max())

        res = {"rel_norm": rel_norm(got), "rel_norm_f32": rel_norm(f32_form())}
        res["ms"] = cuda_time_ms(lambda: pairs.reduce_aligned_cotangents(d_rows, gid, counts, n),
                                 reps=10)
        res["ms_f32"] = cuda_time_ms(f32_form, reps=10)
        x64 = d_rows[:, perm].double()
        res["prefix64_ms"] = cuda_time_ms(lambda: pairs._prefix_sum(x64), reps=10)
        lanes = pairs.aligned_capacity(1 << 22, plan.pcfg[2] * plan.pcfg[3], raster.pair_block)
        x64 = torch.rand((9, lanes), dtype=torch.float64, device=DEVICE,
                         generator=torch.Generator(DEVICE).manual_seed(0))
        res["prefix64_ms_2e22"] = cuda_time_ms(lambda: pairs._prefix_sum(x64), reps=10)
        # zero runs planted at every offset the sort gives: a tenth of the
        # Gaussians get all-zero cotangents, and must sum to exactly 0
        quiet = torch.rand(n, device=DEVICE,
                           generator=torch.Generator(DEVICE).manual_seed(1)) < 0.1
        dq = torch.where(live & quiet[gid.clamp(min=0).long()], 0.0, d_rows)
        got_q = pairs.reduce_aligned_cotangents(dq, gid, counts, n)
        csum = F.pad(pairs._prefix_sum(dq[:, perm].double()), (1, 0))
        raw = (csum[:, ends] - csum[:, ends - counts]).T.float()     # without the count mask
        res["zero_runs"] = int((quiet & (counts > 0)).sum())
        res["zero_runs_nonzero"] = int((got_q[quiet] != 0).any(1).sum())
        res["zero_runs_nonzero_unmasked"] = int((raw[quiet] != 0).any(1).sum())
    log(f"[train] per-Gaussian reduction, {res['zero_runs']} Gaussians with all-zero "
        f"cotangents planted: {res['zero_runs_nonzero']} sum to nonzero "
        f"({res['zero_runs_nonzero_unmasked']} do in the float64 prefix difference "
        f"alone, without the count of nonzeros)")
    if res["zero_runs_nonzero"]:
        raise AssertionError("reduce_aligned_cotangents: a run of zero cotangents sums to "
                             "nonzero")
    log(f"[train] per-Gaussian reduction at full size ({d_rows.shape[1]} lanes, {n} "
        f"Gaussians, loss cotangent): each column within {res['rel_norm']:.3e} of a float64 "
        f"sum in relative norm (the float32 prefix: {res['rel_norm_f32']:.3e}); "
        f"{res['ms']:.4f} ms (float32 prefix {res['ms_f32']:.4f} ms), its float64 prefix sum "
        f"{res['prefix64_ms']:.4f} ms, at {lanes} lanes (2^22 pairs) "
        f"{res['prefix64_ms_2e22']:.4f} ms (CUDA events, 10 calls) on {smi}")
    if not res["rel_norm"] <= REDUCE_REL_NORM:
        raise AssertionError(f"reduce_aligned_cotangents: {res['rel_norm']:.3e} off float64")
    return res


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


def _same_as_first_design(label, got, first):
    """The Hopper T-floor forward's (out, stop) against the first design's:
    S_b and the stop lanes bit for bit (both sum the same rounded log1pf
    terms in lane order and stop on the same test)."""
    import torch

    if not (torch.equal(got[0][:, 3], first[0][:, 3]) and torch.equal(got[1], first[1])):
        raise AssertionError(f"{label}: the Hopper T-floor forward's S_b or stop lanes "
                             f"differ from the first design's")
    log(f"[tfloor] {label}: S_b and stop lanes of the Hopper design = the first "
        f"design's, bit for bit")


def per_tile_log_t64(s_b, seg):
    """Each block's exclusive prefix of S_b [NB, P2] over its own tile's run
    of blocks (``seg`` [NB], sorted tile ids), tile by tile in float64
    (NumPy): the reference of ops.rasterize.incoming_log_t."""
    import numpy as np

    x = s_b.astype(np.float64)
    out = np.zeros_like(x)
    starts = np.flatnonzero(np.r_[True, seg[1:] != seg[:-1]])
    for a, b in zip(starts, np.r_[starts[1:], seg.size]):
        out[a + 1:b] = np.cumsum(x[a:b - 1], axis=0)
    return out


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
    """The kernel entries' wrappers, each with its launch count: the four
    of the main paths and the first design's four, which only the A/Bs of
    phases 3 and 6 call."""
    from gaussiansplatting_tpu_torch.ops import blend

    return (blend.windowed_blend_fwd, blend.windowed_blend_fwd_tf,
            blend.windowed_blend_bwd, blend.windowed_blend_bwd_tf,
            blend.windowed_blend_fwd_v1, blend.windowed_blend_bwd_v1,
            blend.windowed_blend_fwd_tf_v1, blend.windowed_blend_bwd_tf_v1)


MAIN_ENTRIES = ("windowed_blend_fwd", "windowed_blend_fwd_tf", "windowed_blend_bwd",
                "windowed_blend_bwd_tf")


def _check_no_v1(label, launches):
    """A main path must never launch the first design's entries."""
    v1 = {k: v for k, v in launches.items() if k.endswith("_v1") and v}
    if v1:
        raise AssertionError(f"{label} launched the first design: {v1}")


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
    stop, g_first, g_tf)."""
    import torch

    from gaussiansplatting_tpu_torch.config import LossConfig
    from gaussiansplatting_tpu_torch.ops import blend
    from gaussiansplatting_tpu_torch.ops.losses import photometric_loss
    from gaussiansplatting_tpu_torch.ops.rasterize import compose

    held = {}

    def blend_tfloor(logti):
        held["logti"] = logti
        out_tf, held["stop"] = blend.windowed_blend_fwd_tf(*args, logti, log_thr)
        held["out_tf"] = out_tf.requires_grad_(True)
        return held["out_tf"][:, :3, :], held["out_tf"][:, 3, :]

    with torch.enable_grad():
        out1 = out.detach().requires_grad_(True)
        img = compose(out1, block_tile, camera, cfg_tf, blend_tfloor)
        rep = photometric_loss(img, gt, LossConfig())
        g1, g2 = torch.autograd.grad(rep.grad_loss, [out1, held["out_tf"]])
    if float(g1[:, :3].abs().max()) != 0.0:
        raise AssertionError("first-pass cotangent has nonzero colour rows")
    return held["logti"], held["out_tf"].detach(), held["stop"], g1, g2


def phase_tfloor(params, camera, cfg, gt, smi):
    import math

    import numpy as np
    import torch

    from gaussiansplatting_tpu_torch.config import Config
    from gaussiansplatting_tpu_torch.core import gaussians
    from gaussiansplatting_tpu_torch.ops import blend, pairs
    from gaussiansplatting_tpu_torch.ops.projection import num_tiles
    from gaussiansplatting_tpu_torch.ops.rasterize import (
        blend_windows, incoming_log_t, render)
    from gaussiansplatting_tpu_torch.train import schedule
    from gaussiansplatting_tpu_torch.train import state as state_mod
    from gaussiansplatting_tpu_torch.train.trainer import train_step
    from gaussiansplatting_tpu_torch.utils import synthetic

    cfg_tf = cfg.replace(t_floor_exact=True)
    log_thr = math.log(cfg_tf.transmittance_floor)
    res = {}

    # (i) kernels #5 and #6 against their plain versions on edge windows,
    # the Hopper forward's S_b and stop lanes against the first design's
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
            label = f"edge B={block} row0={row0}"
            with torch.no_grad():
                got, stop = blend.windowed_blend_fwd_tf(*args, logti, log_thr)
                want, _, margin = blend.windowed_blend_fwd_tf_plain(
                    *args, logti, log_thr, return_margin=True)
                _same_as_first_design(label, (got, stop),
                                      blend.windowed_blend_fwd_tf_v1(*args, logti, log_thr))
            torch.cuda.synchronize()
            _compare_tf(label, got, want, margin)
            bargs = args[:6] + (g, got[:, 3].contiguous(), stop, args[6], logti, log_thr)
            d_want = blend.windowed_blend_bwd_tf_plain(*bargs)
            _compare_tf_bwd(label, blend.windowed_blend_bwd_tf(*bargs), d_want, margin)
            _compare_tf_bwd(f"{label}, first design", blend.windowed_blend_bwd_tf_v1(
                *args[:6], g, args[6], logti, log_thr), d_want, margin)

    # (ii) at full size: the real logti and the real cotangent of each pass
    args, block_tile, _ = blend_windows(params, camera, cfg_tf)
    with torch.no_grad():
        out, _ = blend.windowed_blend_fwd(*args)
    logti, out_tf, stop, g1, g2 = _tf_pass_cotangents(args, out, block_tile, camera,
                                                      cfg_tf, gt, log_thr)
    fargs = args + (logti, log_thr)
    with torch.no_grad():
        want, _, margin = blend.windowed_blend_fwd_tf_plain(*fargs, return_margin=True)
        res["fwd_err"], res["fwd_excused"] = _compare_tf("full size", out_tf, want, margin)
        first = blend.windowed_blend_fwd_tf_v1(*fargs)
        _compare_tf("full size, first design", first[0], want, margin)
        _same_as_first_design("full size", (out_tf, stop), first)
        res["fwd_ms_v1"], res["fwd_ms"], turns = _turns(
            lambda: blend.windowed_blend_fwd_tf_v1(*fargs),
            lambda: blend.windowed_blend_fwd_tf(*fargs))
        log(f"[tfloor] forward A/B in turns (first, Hopper, Hopper, first): "
            f"{', '.join(f'{t:.4f}' for t in turns)} ms (CUDA events, {KERNEL_REPS} "
            f"launches each) on {smi}")
        res["fwd_plain_ms"] = cuda_time_ms(
            lambda: blend.windowed_blend_fwd_tf_plain(*fargs), reps=3)
        bargs = args[:6] + (g2, out_tf[:, 3].contiguous(), stop, args[6], logti, log_thr)
        got = blend.windowed_blend_bwd_tf(*bargs)
        again = blend.windowed_blend_bwd_tf(*bargs)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError("T-floor backward kernel: two launches differ")
        log("[tfloor bwd] full size: two launches bit-identical")
        d_want = blend.windowed_blend_bwd_tf_plain(*bargs)
        res["bwd_err"], res["bwd_excused"] = _compare_tf_bwd(
            "full size (loss cotangent)", got, d_want, margin)
        v1_args = args[:6] + (g2, args[6], logti, log_thr)
        _compare_tf_bwd("full size, first design", blend.windowed_blend_bwd_tf_v1(*v1_args),
                        d_want, margin)
        res["bwd_ms_v1"], res["bwd_ms"], turns = _turns(
            lambda: blend.windowed_blend_bwd_tf_v1(*v1_args),
            lambda: blend.windowed_blend_bwd_tf(*bargs))
        log(f"[tfloor bwd] A/B in turns (first, Hopper, Hopper, first): "
            f"{', '.join(f'{t:.4f}' for t in turns)} ms (CUDA events, {KERNEL_REPS} "
            f"launches each) on {smi}")
        res["bwd_plain_ms"] = cuda_time_ms(
            lambda: blend.windowed_blend_bwd_tf_plain(*bargs), reps=3)
        # kernel #4: the first pass's backward, on its own cotangent (S_b only)
        b1 = args[:6] + (g1, out[:, 3].contiguous(), args[6])
        _compare_bwd("first pass (as _bwd_kernel)", blend.windowed_blend_bwd(*b1),
                     blend.windowed_blend_bwd_plain(*b1))
    w = _blend_work(args, logti, log_thr)
    nb, p2, block = args[1].shape[0], 256, args[5]
    # bytes: 36 per lane read (no gid), the block's three ints; forward logti
    # in, out and stop out; backward stop in, the three ints of the blocks
    # with a stop > 0, g and s_b of the pixels with a stop > 0 (a block
    # whose stops are all 0 writes zeros from stop alone), nine columns out
    res["fwd_bound"], line = _work_bound(
        w, "fwd", 36 * w["live_fwd"] + 12 * nb + 4 * nb * 6 * p2, FWD_OPS_PER_KEPT)
    log(f"[tfloor] forward work ({w['pixels']['fwd']} pixels per thread; power tests up "
        f"to each pixel's first failing kept lane, surviving kept pairs): {line}")
    res["bwd_bound"], line = _work_bound(
        w, "bwd", 36 * w["live_bwd"] + 12 * w["bwd_blocks"] + 4 * nb * p2
        + 20 * w["bwd_pixels"] + 36 * nb * block, BWD_OPS_PER_KEPT)
    log(f"[tfloor bwd] {w['bwd_blocks']} of {nb} blocks and {w['bwd_pixels']} of "
        f"{nb * p2} (block, pixel) entries have a stop lane > 0")
    log(f"[tfloor bwd] backward work ({w['pixels']['bwd']} pixels per thread; power "
        f"tests before each pixel's stop lane): {line}")
    log(f"[tfloor] full size: fwd_tf Hopper {res['fwd_ms']:.4f} ms, first design "
        f"{res['fwd_ms_v1']:.4f} ms, plain {res['fwd_plain_ms']:.3f} ms, bound "
        f"{res['fwd_bound']['bound_ms']:.4f} ms; bwd_tf Hopper {res['bwd_ms']:.4f} ms, "
        f"first design {res['bwd_ms_v1']:.4f} ms, plain {res['bwd_plain_ms']:.3f} ms, "
        f"bound {res['bwd_bound']['bound_ms']:.4f} ms (CUDA events) on {smi}")

    # (iii) compose's incoming log T against a float64 per-tile prefix: within
    # one float32 ulp of max(|ref|, 1), and no pixel stopping at another lane
    # beyond the flip rule; its forward and backward timed
    with torch.no_grad():
        ts = cfg.tile_size
        nt = num_tiles(camera.width, ts) * num_tiles(camera.height, ts)
        ref = per_tile_log_t64(out[:, 3].cpu().numpy(), block_tile.cpu().numpy())
        unit = np.spacing(np.maximum(np.abs(ref), 1.0).astype(np.float32)).astype(np.float64)
        ulps = float((np.abs(logti.cpu().numpy().astype(np.float64) - ref) / unit).max())
        ref32 = torch.from_numpy(ref.astype(np.float32)).to(DEVICE)
        moved = blend.windowed_blend_fwd_tf(*args, ref32, log_thr)[1] != stop
        res["logti_ulps"], res["logti_moved"] = ulps, int(moved.sum())
        flips = int((moved & (margin < FLIP_MARGIN)).sum())
    log(f"[tfloor] logti vs a float64 per-tile prefix: max {ulps:.3f} float32 ulps of "
        f"max(|ref|, 1); {res['logti_moved']} (block, pixel) entries stop at another lane "
        f"with the float64 prefix rounded once, {flips} of them at a margin < {FLIP_MARGIN}")
    if ulps > 1.0:
        raise AssertionError(f"incoming_log_t is {ulps} ulps off float64")
    if res["logti_moved"] != flips or flips > FLIP_MAX_SHARE * moved.numel():
        raise AssertionError("logti's rounding moves a pixel's stop beyond the flip rule")
    s_b = out[:, 3].contiguous().requires_grad_(True)
    g_lt = g2[:, 3].contiguous()                # any [NB, P2] cotangent times it
    res["logti_ms"] = cuda_time_ms(lambda: incoming_log_t(s_b.detach(), block_tile, nt), reps=20)
    res["logti_fwd_bwd_ms"] = cuda_time_ms(lambda: torch.autograd.grad(
        incoming_log_t(s_b, block_tile, nt), s_b, g_lt), reps=20)
    log(f"[tfloor] incoming_log_t at {tuple(s_b.shape)}: forward {res['logti_ms']:.4f} ms, "
        f"forward + backward {res['logti_fwd_bwd_ms']:.4f} ms (CUDA events, 20 calls) on {smi}")
    # its backward behind zero tails planted at every offset: each (tile,
    # pixel) gets zero cotangent from a random block of the tile on, and
    # every block before only zeros in its tile must get exactly 0
    gen = torch.Generator(DEVICE).manual_seed(2)
    seg = block_tile.long().clamp(max=nt)
    bounds = torch.searchsorted(seg, torch.arange(nt + 2, device=DEVICE))
    first, size = bounds[seg], bounds[seg + 1] - bounds[seg]                 # [NB]
    u = torch.rand((nt + 1, g_lt.shape[1]), device=DEVICE, generator=gen)[seg]  # [NB, P2]
    cut = first[:, None] + (u * (size[:, None] + 1)).long()      # in [first, last + 1]
    idx = torch.arange(seg.numel(), device=DEVICE)[:, None]
    g_zero = torch.where(idx >= cut, 0.0, torch.randn(g_lt.shape, device=DEVICE, generator=gen))
    behind = idx >= cut - 1
    d_zero = torch.autograd.grad(incoming_log_t(s_b, block_tile, nt), s_b, g_zero)[0]
    with torch.no_grad():
        incl = pairs._prefix_sum(g_zero.t().double().contiguous())
        last = (bounds[seg + 1] - 1)
        raw = (incl[:, last] - incl).t().float()                # without the count mask
    res["logti_zero_tails"] = int(behind.sum())
    res["logti_zero_tails_nonzero"] = int((d_zero[behind] != 0).sum())
    unmasked = int((raw[behind] != 0).sum())
    log(f"[tfloor] incoming_log_t backward, {res['logti_zero_tails']} (block, pixel) entries "
        f"behind planted zero tails: {res['logti_zero_tails_nonzero']} nonzero ({unmasked} "
        f"in the float64 prefix difference alone, without the count of nonzeros)")
    if res["logti_zero_tails_nonzero"]:
        raise AssertionError("incoming_log_t: nonzero gradient behind a zero cotangent tail")

    # (iv) the T-floor render main path at full size
    with torch.no_grad():
        img, _ = render(params, camera, cfg)
    _reset_launches()
    with torch.no_grad():
        img_tf, aux = render(params, camera, cfg_tf)
    torch.cuda.synchronize()
    render_launches = _tf_launches()
    _check_no_v1("the T-floor render", render_launches)
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
    _check_no_v1("the T-floor step", train_launches)
    res["step_ms"] = start.elapsed_time(end) / TFLOOR_TIMED_STEPS
    losses = torch.stack(losses).cpu().numpy()
    log(f"[tfloor] full-size T-floor step: {res['step_ms']:.3f} ms/step warm (CUDA "
        f"events, {TFLOOR_TIMED_STEPS} steps) on {smi}; loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}; launches {train_launches}")
    if not np.isfinite(losses).all() or bool(torch.stack(flags).any()):
        raise AssertionError("T-floor train step: non-finite loss or overflow")
    _check_finite_state("T-floor train step", st)
    if min(train_launches[k] for k in MAIN_ENTRIES) < 1:
        raise AssertionError(f"the T-floor step did not launch every kernel: {train_launches}")
    res["step_device_ms"], _ = _device_profile(
        "[tfloor] full-size T-floor step",
        lambda: train_step(st, camera, gt, tcfg, TRAIN_TOTAL_ITERS), STEP_PROFILE_STEPS, smi)
    log(f"[tfloor] full-size T-floor step: the card idles "
        f"{1 - res['step_device_ms'] / res['step_ms']:.3f} of the step (1 - device time / "
        f"host clock {res['step_ms']:.3f} ms)")
    _reset_launches()
    replay, _ = train_step(state0, camera, gt, tcfg, TRAIN_TOTAL_ITERS)
    torch.cuda.synchronize()
    res["per_step"] = _tf_launches()
    a, b = state_mod.state_to_numpy(state1), state_mod.state_to_numpy(replay)
    differ = [k for k in a if not np.array_equal(a[k], b[k])]
    if differ:
        raise AssertionError(f"replayed T-floor step differs in {differ}")
    log(f"[tfloor] replayed full-size T-floor step: all {len(a)} state arrays "
        f"bit-identical; launches {res['per_step']}")

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
    # a Gaussian behind every pixel's floor gets exactly zero gradient on
    # both devices (compose sums each tile's blocks on their own), so
    # grad_count must match exactly; Adam moves an element whose gradient
    # is rounding noise by lr * sign(noise), and quaternions renormalize
    # after the move, which scales a component's move by up to
    # 1 + |q . sign| <= 3 (the bar tests/test_torch_train.py holds)
    _compare_small_step(dev_state, dev_m, cpu_state, cpu_m,
                        schedule.learning_rates(small_cfg.optim, 0, 100),
                        label="64x48 T-floor step", noise_lrs=3)
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

    _reset_launches()
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
    _check_no_v1("the render path", _tf_launches())
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
    frame_device_ms, _ = _device_profile("[render] canonical view", frame,
                                         STEP_PROFILE_STEPS, smi)

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
    return launches, frame_ms, frame_device_ms


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


def _device_profile(label, fn, reps, smi):
    """Kernels-only torch.profiler of ``reps`` calls of ``fn`` (warmed once):
    logs the device ms per call and the STEP_PROFILE_TOP largest kernels;
    returns (device ms per call, {kernel name: ms per call})."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    per = 1e3 * reps                                # profiler us -> ms per call
    kernels = {e.key: e.self_device_time_total / per for e in ka}
    total = sum(kernels.values())
    log(f"{label}: device time {total:.3f} ms per call (torch.profiler, {reps} calls) on {smi}")
    for e in sorted(ka, key=lambda e: -e.self_device_time_total)[:STEP_PROFILE_TOP]:
        log(f"{label}   {e.self_device_time_total / per:8.3f} ms x{e.count // reps:4d}  "
            f"{e.key[:90]}")
    # what compose's global float32 prefix used to cost: torch's outer-dim
    # cumsum and the gather's index-put backward
    outer, put = (sum(v for k, v in kernels.items() if s in k)
                  for s in ("scan_outer_dim", "indexing_backward"))
    log(f"{label}   outer-dim scans {outer:.3f} ms, index-put backward {put:.3f} ms per call")
    return total, kernels


def _step_breakdown(st0, st36, cam, gt, cfg, smi):
    """Where the COLMAP trainer's step goes on the card: one train step from
    the state at iteration 0 (the SfM start) and at 36 (after the last
    densify), timed with CUDA events at pair capacities PAIR_CAPACITY (2^21)
    and TRAINLOOP_PAIR_CAPACITY, and a kernels-only torch.profiler breakdown of
    STEP_PROFILE_STEPS steps at TRAINLOOP_PAIR_CAPACITY (device ms per step,
    the STEP_PROFILE_TOP largest kernels).  Returns {label: device ms per
    step} from the profile."""
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
        device_ms[label], _ = _device_profile(
            f"[trainloop step] {label} profile at pair_capacity {TRAINLOOP_PAIR_CAPACITY}",
            lambda: trainer.train_step(st, cam, gt, c, 36), STEP_PROFILE_STEPS, smi)
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
    _check_no_v1("the COLMAP trainer", launches)
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
    name, smi, clock_mhz = phase_device()

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
        fwd, args, block_tile, work = phase_kernel(params, camera, cfg, smi)
        log(f"[kernel] full size: Hopper kernel {fwd['ms']:.4f} ms, first design "
            f"{fwd['ms_v1']:.4f} ms, plain {fwd['plain_ms']:.3f} ms, bound "
            f"{fwd['bound_ms']:.4f} ms (CUDA events) on {smi}")
        bwd = phase_kernel_bwd(args, block_tile, camera, cfg, gt, work, smi, clock_mhz)
        log(f"[kernel bwd] full size: Hopper kernel {bwd['ms']:.4f} ms, first design "
            f"{bwd['ms_v1']:.4f} ms, plain {bwd['plain_ms']:.3f} ms, bound "
            f"{bwd['bound_ms']:.4f} ms (CUDA events) on {smi}")
    del args, block_tile
    render_launches, frame_ms, frame_device_ms = phase_render(params, camera, cfg, smi)
    (train_fwd, train_bwd), step_ms, step_device_ms, per_step, red = phase_train(
        params, camera, gt, smi)
    tf_launches, tf = phase_tfloor(params, camera, cfg, gt, smi)
    tl = phase_trainloop(params, smi)

    src = "gaussiansplatting_tpu_torch/csrc/"
    tpu = "gaussiansplatting_tpu/ops/pallas_blend.py:"

    def entry(name, source, replaces, design, by_path, per, res):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "design": design,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "launches_per_step": per, **res, "library_ms": None}

    log(json.dumps({"kernels": [
        entry("windowed_blend_fwd", "blend_fwd.cu", f"{tpu}601, {tpu}161", "hopper",
              {"render": render_launches, "train": train_fwd,
               "tfloor": tf_launches["windowed_blend_fwd"],
               "trainloop": tl["launches"]["windowed_blend_fwd"]},
              per_step["windowed_blend_fwd"],
              {k: fwd[k] for k in ("max_abs_err", "ms", "ms_v1", "plain_ms", "bound_ms",
                                   "bound_by", "power_tests", "kept_pairs",
                                   "culled_share")}),
        entry("windowed_blend_bwd", "blend_bwd.cu", f"{tpu}671, {tpu}188", "hopper",
              {"train": train_bwd, "tfloor": tf_launches["windowed_blend_bwd"],
               "trainloop": tl["launches"]["windowed_blend_bwd"]},
              per_step["windowed_blend_bwd"],
              {k: bwd[k] for k in ("max_abs_err", "ms", "ms_v1", "plain_ms", "bound_ms",
                                   "bound_by", "power_tests", "kept_pairs", "culled_share",
                                   "tree_share_v1")}),
        entry("windowed_blend_fwd_tf", "blend_fwd.cu", f"{tpu}249", "hopper",
              {"tfloor": tf_launches["windowed_blend_fwd_tf"]},
              tf["per_step"]["windowed_blend_fwd_tf"],
              {"max_abs_err": tf["fwd_err"], "excused_flips": tf["fwd_excused"],
               "ms": tf["fwd_ms"], "ms_v1": tf["fwd_ms_v1"], "plain_ms": tf["fwd_plain_ms"],
               **tf["fwd_bound"]}),
        entry("windowed_blend_bwd_tf", "blend_bwd.cu", f"{tpu}281", "hopper",
              {"tfloor": tf_launches["windowed_blend_bwd_tf"]},
              tf["per_step"]["windowed_blend_bwd_tf"],
              {"max_abs_err": tf["bwd_err"], "excused_flips": tf["bwd_excused"],
               "ms": tf["bwd_ms"], "ms_v1": tf["bwd_ms_v1"], "plain_ms": tf["bwd_plain_ms"],
               **tf["bwd_bound"]}),
    ], "render_ms_per_frame": frame_ms, "render_device_ms_per_frame": frame_device_ms,
        "train_step_ms": step_ms, "train_step_device_ms": step_device_ms,
        "tfloor_render_ms_per_frame": tf["frame_ms"],
        "tfloor_train_step_ms": tf["step_ms"],
        "tfloor_train_step_device_ms": tf["step_device_ms"],
        "tfloor_launches_per_step": tf["per_step"],
        "logti_max_ulps_vs_f64": tf["logti_ulps"],
        "logti_moved_stops_vs_f64": tf["logti_moved"],
        "logti_zero_tail_entries": tf["logti_zero_tails"],
        "incoming_log_t_ms": tf["logti_ms"],
        "incoming_log_t_fwd_bwd_ms": tf["logti_fwd_bwd_ms"],
        "reduce_max_col_rel_norm_vs_f64": red["rel_norm"],
        "reduce_f32_max_col_rel_norm_vs_f64": red["rel_norm_f32"],
        "reduce_zero_runs": red["zero_runs"],
        "reduce_zero_runs_nonzero_unmasked": red["zero_runs_nonzero_unmasked"],
        "reduce_ms": red["ms"], "reduce_f32_ms": red["ms_f32"],
        "reduce_prefix64_ms": red["prefix64_ms"],
        "reduce_prefix64_ms_2e22": red["prefix64_ms_2e22"],
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
