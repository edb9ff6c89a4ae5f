#!/usr/bin/env python3
"""On-GPU smoke test of the PyTorch port's render and training paths, its
user tools and its measuring tools (one NVIDIA card).

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
              partial, full and unaligned blocks, B = 16, 64 and 128, row0 0 and
              3) and the full-size windows of the 100k-Gaussian scene's
              canonical 800x608 view (the backward given the forward's S_b
              and the real cotangent of the full-size loss, launched twice
              for bit-identical output; the forward's S_b equal to the
              first design's bit for bit).  The A/B: each Hopper kernel and
              its first design (gs_blend_*_win_v1, one thread per pixel,
              which nothing else calls) timed in turns (first, Hopper,
              Hopper, first) with CUDA events, the plain versions timed;
              the work the inputs need (utils.sol.blend_work: power tests on the
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
  8. garden    the garden main path at full width: utils/scenegen's procedural
              scene through tools.make_dataset at its defaults (200 views,
              800x608, 150,000 SfM points, seed 0; the ray tracer's ms per
              view, the PNG writing and the total time); render_view and the
              SfM colours on the card against the CPU (64x48, tests/
              test_torch_scenegen.py's bars); the config-4 flags the port has
              through tools.train (GARDEN_* below; one cut, 4 epochs: 760
              iterations, densify at 600 and 700): every step finite, `alive`
              a prefix after each event, both kernels once per step, the
              rate, events, rebuckets, peak pairs, overflow steps, train
              PSNR, the held-out eval and the PLY, the final state's step at
              the adaptive pair capacity and at the pinned 2^24 (its
              device-time profile); the facade (models.
              GaussianModel) on its checkpoint and PLY and from_colmap_scene
              with 16 iterations of train; the HTTP viewer (tools.view) on
              its PLY (20 frames along an orbit: JPEGs that decode, no
              overflow, p50 / p90 ms request to response) and on its
              checkpoint (/train?n=10 advances the iteration and changes the
              next frame); the graft entry (graft_entry.entry, #1 at B = 64)
              against the plain blend.
  9. tools     the measuring tools at the full-size scene: tools.profile's
              stage times, tools.trace's 5-step capture (top groups, device
              ms per step, the card's idle share), utils.sol.step_model's
              floor, which must lie below the measured device time.  The
              kernels' bounds (phases 3 and 6) come from utils.sol too.
 10. parallel  tile strips, multi-view batched steps and tile-strip
              sharding at full size (phase_parallel): the canonical view in
              2 and 4 strips (render(tile_rows)) against the full render,
              default and T-floor, with their gradients, the strips' pair
              counts summing to the frame's, each kernel entry on the last
              strip (row0 > 0) against its plain version (main path
              `strips`); train_step_batched K = 1 bit for bit as train_step,
              K = 2 of one view, K = 1, 2, 4 timed, a 64x48 batched step on
              the card against the CPU (`batched`); the sharded render,
              step and batched step on 2 ranks sharing the card (gloo) and 1
              rank (nccl), started by parallel.launch.spawn, against the
              single-card ones, the ranks' states bit-identical, chunked
              all-reduces bit for bit, the sharded step timed and profiled
              (`sharded`); tools.train --batch-views 2 and --devices 2 on
              phase 7's scene; tools.bench_scaling and
              graft_entry.dryrun_multichip(2).
 11. modes     the bf16 payload mode (payload_dtype="bf16", with and without
              pack_positions), the impact drop and the scatter reduction at
              full size (phase_modes): the packed kernels
              (gs_blend_{fwd,bwd}_win_packed) against their plain versions
              on edge windows and the canonical view's packed windows with
              the real loss cotangent (the backward twice, bit-identical),
              timed in turns against the float32 Hopper kernels, their work
              and bounds; the bf16 render (`modes_render`) and train step
              (`modes_train`, timed, replayed bit for bit, its device time
              profiled) against the float32 ones at JAX's bars, only the
              packed kernels launching; a 64x48 bf16 + pack_pos step card
              against CPU;
              the impact capacity plan card against CPU, integer-exact; the
              scatter reduction twice bit for bit and against float64, a
              scatter step replayed; tools.train --payload-dtype bf16
              --pack-positions 1 (`modes_cli`).

Every main path (phases 4-11) runs with the launch counts set to 0 before
it and read after it: each kernel of the path must have launched, and the
first design's entries never.

Prints one JSON line describing the kernels (per kernel: launches on the
main paths and per step, max_abs_err against the plain version, ms, ms_v1
(the first design's time in the same turns; for the packed entries ms_f32,
the float32 Hopper kernel's, and their pack_pos instances' times and
bounds), plain_ms, bound_ms with
bound_by (the larger of
this run's bytes over the HBM rate and its instructions over the f32
instruction rate), the work behind it (power_tests, kept_pairs,
culled_share), library_ms (null: no single PyTorch call computes the
windowed blend)) and the paths' times and counts, then as its last line
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
# phase 3: launches per CUDA-event time; the edge windows' pair_block
# values (64: the graft entry's, graft_entry.entry)
KERNEL_REPS = 20
EDGE_BLOCKS = (16, 64, 128)
# the bound of a kernel (bound_ms): utils.sol (the H100's rates, the
# instructions per power test and per kept pair)
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
# the device-time profiles (tools.trace.device_profile) of the frame, the full-size
# step and the COLMAP trainer's step (tools.trace.step_breakdown): calls profiled,
# kernels printed
STEP_PROFILE_STEPS = 3
STEP_PROFILE_TOP = 12
# density on the card vs the CPU (density_case): floats are moved, or
# computed by the same few rounded operations on both devices
DENSITY_ATOL = 1e-6
DENSITY_SEED = 7
DENSITY_EXTENT = 4.0
# phase 8: the garden, utils/scenegen's procedural scene at the size of
# BASELINE.md config #4 (tools.make_dataset's defaults), trained with the
# flags of scripts/run_config4.sh:11-27 that the port has (f32: no
# --payload-dtype bf16, no --scan-steps 10), one cut: GARDEN_EPOCHS of the
# schedule's 150 (760 of 28,500 iterations; the default density schedule
# densifies at 600 and 700, its first opacity reset at 3,000 lies beyond)
GARDEN_VIEWS = 200
GARDEN_WIDTH, GARDEN_HEIGHT = 800, 608
GARDEN_POINTS = 150_000
GARDEN_EPOCHS = 4
GARDEN_EVAL_SPLIT = 20
GARDEN_CKPT_EVERY = 250
GARDEN_DENSIFY_AT = [600, 700]
# the renderer on the card vs the CPU (tests/test_torch_scenegen.py's bars):
# render_view at 64x48 of two ring poses and 2000 SfM colours, each channel
# within SCENE_COLOR_ATOL; beyond it only where a camera hit, palette,
# shadow or texture hash (a wrap) differs, at most SCENE_MAX_EXCUSED of the
# pixels.  The card's sinf wraps a hash more often than torch's CPU sin does
# against JAX's, most on the ground, whose lattice coordinates are largest
# (12 of 2000 SfM colours excused, 6 and 9 of 3072 pixels, on an NVIDIA H100
# 80GB HBM3 at 700 W): the points' share is capped at SCENE_MAX_EXCUSED_POINTS
GARDEN_SMALL = (64, 48)
GARDEN_SAMPLES = 2000
SCENE_COLOR_ATOL = 3e-3
SCENE_MAX_EXCUSED = 5e-3
SCENE_MAX_EXCUSED_POINTS = 2e-2
# the facade: from_colmap_scene then train on this many views; a PLY round
# trip renders within FACADE_PLY_ATOL (tests/test_model.py:40)
FACADE_ITERS = 16
FACADE_PLY_ATOL = 1e-3
# the viewer: its default size, frames along an orbit, /train steps
VIEWER_SIZE = (800, 600)
VIEWER_FRAMES = 20
VIEWER_TRAIN = 10
# phase 9: tools.trace's steps
TRACE_STEPS = 5
# phase 10: tile strips of the canonical view (2 of 19 tile rows; 4 of 10,
# the last with 2 rows of padding) against the full render within
# STRIP_IMG_MAX (tests/test_sharding.py:55's bar; a strip's tiles get the
# same blocks as in the full frame, so 0 is expected); train_step_batched at
# K views of the 100k scene, canonical cameras at these fov scales (each
# frames fewer pairs than the canonical 1.2); the sharded steps at the JAX
# package's bars (tests/test_sharding.py:87-103) but for noise-level
# gradients (_sharded_bars); tools.train's epochs on phase 7's scene
PARALLEL_STRIPS = (2, 4)
STRIP_IMG_MAX = 1e-5
BATCH_VIEWS = (1, 2, 4)
BATCH_FOVS = (1.2, 1.15, 1.1, 1.05)
PARALLEL_TIMED_STEPS = 5
SHARDED_TIMED_STEPS = 5
SHARDED_LOSS_RTOL, SHARDED_PARAM_ATOL, SHARDED_ACCUM_ATOL = 1e-5, 2e-5, 1e-4
PARALLEL_CLI_EPOCHS = 1
# phase 11: the bf16 payload mode (payload_dtype="bf16", pack_positions),
# the impact drop and the scatter reduction.  Packed backward vs plain, per
# unpacked cotangent: within one bf16 ulp of the value (2^-7 relative: the
# final round to nearest even takes a last-bit difference either way) plus
# PACKED_BWD_REL of the column's largest (the suffix's bf16-rounded terms
# may round either way too).  bf16 vs f32 at JAX's own bars
# (tests/test_packing.py:97-202): image max and mean, gradients relative to
# the field's largest.  The scatter reduction against a float64 sum,
# PACKED_REDUCE_REL_NORM per column; tools.train's epochs in the bf16 mode;
# the impact drop's capacity (a third of the frame's pairs)
PACKED_BWD_REL = 1e-4
MODE_IMG_MAX, MODE_IMG_MEAN, MODE_GRAD_REL = 0.06, 5e-3, 5e-2
SCATTER_REL_NORM = 1e-5
MODES_TIMED_STEPS = 5
MODES_CLI_EPOCHS = 1
SCRATCH = os.path.join(REPO, "build", "chip_smoke")
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int) -> float:
    """ms per call of ``fn`` on DEVICE (tools.profile.time_ms: CUDA events
    around ``reps`` calls after a warm one)."""
    from gaussiansplatting_tpu_torch.tools.profile import time_ms

    return time_ms(fn, reps, DEVICE)


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


def packed_edge_windows(block, seed, row0, pack_pos, **kw):
    """edge_windows' windows over the bf16 payload mode's 8-row table
    (ops/pairs.py): gid, sx, sy, then bf16 pairs (a, b), (c, op), (r, g),
    (b, 0); with ``pack_pos`` gid, then tile-relative (mx, my) drawn in
    [-10, 10] as one pair, then the same four pairs.  Returns (table,
    src, valid, tile)."""
    import numpy as np
    import torch

    from gaussiansplatting_tpu_torch.ops import packing

    table, src, valid, tile = edge_windows(block, seed, row0, **kw)
    t = torch.from_numpy(table)
    data = packing.pack_cols(list(t[3:10]))
    if pack_pos:
        rel = np.random.default_rng(seed + 7).uniform(-10, 10, (2, t.shape[1]))
        rel = torch.from_numpy(rel.astype(np.float32))
        rows = [t[0], packing.pack2(rel[0], rel[1])] + data
    else:
        rows = [t[0], t[1], t[2]] + data
    packed = torch.zeros((8, t.shape[1]), dtype=torch.float32)
    packed[:len(rows)] = torch.stack(rows)
    return packed.numpy(), src, valid, tile


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
    from gaussiansplatting_tpu_torch.utils import sol

    for block in EDGE_BLOCKS:
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
    w = sol.blend_work(args)
    p2, block = 256, args[5]
    bound, line = sol.work_bound(w, "fwd", 40 * w["live_fwd"] + 12 * nb + 4 * nb * (4 * p2 + block),
                                 sol.FWD_OPS_PER_KEPT)
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


def _loss_cotangent(out, block_tile, camera, cfg, gt, tile_rows=None):
    """The real cotangent of the blend's output: autograd of compose and
    the default photometric loss (D-SSIM differentiated) at ``out``; of a
    strip (``tile_rows``) against ``gt``, its rows of the ground truth."""
    import torch

    from gaussiansplatting_tpu_torch.config import LossConfig
    from gaussiansplatting_tpu_torch.ops.losses import photometric_loss
    from gaussiansplatting_tpu_torch.ops.rasterize import compose

    with torch.enable_grad():
        out = out.detach().requires_grad_(True)
        img = compose(out, block_tile, camera, cfg, tile_rows=tile_rows)[:gt.shape[0]]
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
    from gaussiansplatting_tpu_torch.utils import sol

    for block in EDGE_BLOCKS:
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
    bound, line = sol.work_bound(w, "bwd", 40 * w["live_bwd"] + 4 * nb + 8 * w["bwd_blocks"]
                                 + 20 * w["bwd_pixels"] + 36 * nb * block, sol.BWD_OPS_PER_KEPT)
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
    from gaussiansplatting_tpu_torch.tools import bench_train, trace
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
    step_device_ms, _ = trace.device_profile(
        "[train] full-size step", lambda: train_step(st, camera, gt, cfg, TRAIN_TOTAL_ITERS),
        STEP_PROFILE_STEPS, smi, DEVICE, log, STEP_PROFILE_TOP)
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
    """The kernel entries' wrappers, each with its launch count: the six
    of the main paths (four float32, two packed) and the first design's
    four, which only the A/Bs of phases 3 and 6 call."""
    from gaussiansplatting_tpu_torch.ops import blend

    return (blend.windowed_blend_fwd, blend.windowed_blend_fwd_tf,
            blend.windowed_blend_bwd, blend.windowed_blend_bwd_tf,
            blend.windowed_blend_fwd_packed, blend.windowed_blend_bwd_packed,
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


def _tf_pass_cotangents(args, out, block_tile, camera, cfg_tf, gt, log_thr, tile_rows=None):
    """The full-size logti and the real loss cotangent of each pass: compose
    at the first pass's ``out`` with the T-floor kernel as its second pass,
    then autograd of the default photometric loss (of a strip, ``tile_rows``,
    against ``gt``, its rows of the ground truth).  Returns (logti, out_tf,
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
        img = compose(out1, block_tile, camera, cfg_tf, blend_tfloor, tile_rows)[:gt.shape[0]]
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
    from gaussiansplatting_tpu_torch.tools import trace
    from gaussiansplatting_tpu_torch.train import schedule
    from gaussiansplatting_tpu_torch.train import state as state_mod
    from gaussiansplatting_tpu_torch.train.trainer import train_step
    from gaussiansplatting_tpu_torch.utils import sol, synthetic

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
    w = sol.blend_work(args, logti, log_thr)
    nb, p2, block = args[1].shape[0], 256, args[5]
    # bytes: 36 per lane read (no gid), the block's three ints; forward logti
    # in, out and stop out; backward stop in, the three ints of the blocks
    # with a stop > 0, g and s_b of the pixels with a stop > 0 (a block
    # whose stops are all 0 writes zeros from stop alone), nine columns out
    res["fwd_bound"], line = sol.work_bound(
        w, "fwd", 36 * w["live_fwd"] + 12 * nb + 4 * nb * 6 * p2, sol.FWD_OPS_PER_KEPT)
    log(f"[tfloor] forward work ({w['pixels']['fwd']} pixels per thread; power tests up "
        f"to each pixel's first failing kept lane, surviving kept pairs): {line}")
    res["bwd_bound"], line = sol.work_bound(
        w, "bwd", 36 * w["live_bwd"] + 12 * w["bwd_blocks"] + 4 * nb * p2
        + 20 * w["bwd_pixels"] + 36 * nb * block, sol.BWD_OPS_PER_KEPT)
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
    res["step_device_ms"], _ = trace.device_profile(
        "[tfloor] full-size T-floor step",
        lambda: train_step(st, camera, gt, tcfg, TRAIN_TOTAL_ITERS), STEP_PROFILE_STEPS, smi,
        DEVICE, log, STEP_PROFILE_TOP)
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


def _check_image(label, img, width=None, height=None):
    """A finite, non-constant [height, width, 3] image (default: the
    full-size frame)."""
    import torch

    if tuple(img.shape) != (height or HEIGHT, width or WIDTH, 3):
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
    from gaussiansplatting_tpu_torch.tools import trace
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
    frame_device_ms, _ = trace.device_profile("[render] canonical view", frame,
                                              STEP_PROFILE_STEPS, smi, DEVICE, log,
                                              STEP_PROFILE_TOP)

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
    from gaussiansplatting_tpu_torch.tools import trace
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
    # where the step goes: timed at 2^21 and TRAINLOOP_PAIR_CAPACITY, and
    # profiled at the latter, at iterations 0 (the SfM start) and 36
    res["step_device_ms"] = trace.step_breakdown(
        {"iteration 0": st0, "iteration 36": state36}, views[0][0], views[0][1], saved_cfg,
        [PAIR_CAPACITY, TRAINLOOP_PAIR_CAPACITY], TRAINLOOP_PAIR_CAPACITY, 36, smi, DEVICE,
        log, "[trainloop step]", STEP_PROFILE_STEPS, STEP_PROFILE_TOP)
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


def _shading_differs(points, normals, pal):
    """[N] True where the card's shading of CPU surface points rests on
    another decision than the CPU's (scenegen.shading_flags: the shadow
    ray's hit, or a texture hash that wraps, off by > 0.5)."""
    from gaussiansplatting_tpu_torch.utils import scenegen

    sh_c, hash_c = scenegen.shading_flags(points, normals, pal)
    sh_d, hash_d = scenegen.shading_flags(points.to(DEVICE), normals.to(DEVICE), pal.to(DEVICE))
    return (sh_c != sh_d.cpu()) | ((hash_c - hash_d.cpu()).abs() > 0.5).any(-1)


def _scene_card_vs_cpu(smi):
    """The garden renderer on the card against the CPU at the bars of
    tests/test_torch_scenegen.py: render_view at 64x48 of the first two ring
    poses and sample_surface_points(2000) (positions exact).  Every channel
    within SCENE_COLOR_ATOL; a pixel or point beyond it is excused only
    where its camera hit, palette, shadow or a texture hash (a wrap)
    differs, and the excused ones may be at most SCENE_MAX_EXCUSED of the
    pixels, SCENE_MAX_EXCUSED_POINTS of the points.
    Returns the max error outside them."""
    import numpy as np
    import torch

    from gaussiansplatting_tpu_torch.core.camera import quat_to_rotmat_np
    from gaussiansplatting_tpu_torch.utils import scenegen

    def judge(label, err, flagged, max_share):
        beyond = err > SCENE_COLOR_ATOL
        excused = beyond & flagged
        worst = float(err[~excused].max())
        log(f"[garden] {label}, card vs CPU: max|err| {worst:.2e} outside {int(excused.sum())} "
            f"excused of {err.numel()} ({int(flagged.sum())} flagged)")
        if bool((beyond & ~flagged).any()) or excused.float().mean() > max_share:
            raise AssertionError(f"{label} on the card disagrees with the CPU")
        return worst

    w, h = GARDEN_SMALL
    fx = 0.5 * w / np.tan(0.5 * np.deg2rad(60.0))
    sph, box, _, _ = scenegen._scene_arrays("cpu")
    worst = 0.0
    for i, (q, t, _) in enumerate(scenegen.camera_ring_poses(GARDEN_VIEWS, seed=0)[:2]):
        view = (quat_to_rotmat_np(q), t, fx, fx, w / 2, h / 2, w, h)
        ref = torch.from_numpy(scenegen.render_view(*view, device="cpu"))
        got = torch.from_numpy(scenegen.render_view(*view, device=DEVICE))
        o, d = scenegen.camera_rays(*view, device="cpu")
        tc, hc, nc, pc = scenegen._intersect(sph, box, o, d)
        _, hd, _, pd = scenegen._intersect(sph.to(DEVICE), box.to(DEVICE), o.to(DEVICE),
                                           d.to(DEVICE))
        p = o + tc[..., None] * d
        flagged = (hc != hd.cpu()) | (pc != pd.cpu()) | (hc & _shading_differs(p, nc, pc))
        worst = max(worst, judge(f"render_view {w}x{h}, ring pose {i}",
                                 (got - ref).abs().amax(-1), flagged, SCENE_MAX_EXCUSED))
    pc_, cc = scenegen.sample_surface_points(GARDEN_SAMPLES, seed=1, device="cpu")
    pd_, cd = scenegen.sample_surface_points(GARDEN_SAMPLES, seed=1, device=DEVICE)
    if not np.array_equal(pd_, pc_):
        raise AssertionError("sample_surface_points: positions differ between card and CPU")
    pts, nrm, pal = (torch.from_numpy(x) for x in
                     scenegen.surface_samples(GARDEN_SAMPLES, np.random.default_rng(1)))
    return max(worst, judge(f"sample_surface_points({GARDEN_SAMPLES}) colours",
                            torch.from_numpy(np.abs(cd - cc).max(1)),
                            _shading_differs(pts, nrm, pal), SCENE_MAX_EXCUSED_POINTS))


def _garden_camera(sparse, images_dir, index):
    """The ``index``-th COLMAP view of the garden on the card, with its
    ground truth as a host array."""
    from gaussiansplatting_tpu_torch.core import camera as camera_mod
    from gaussiansplatting_tpu_torch.io import colmap, images

    data = colmap.load_colmap(sparse)
    im = data.images[index]
    c = data.cameras[im.camera_id]
    cam = camera_mod.make_camera(im.quat_wxyz, im.translation, c.fx, c.fy, c.cx, c.cy,
                                 c.width, c.height, device=DEVICE)
    return cam, images.load_image(images.find_image(images_dir, im.name))


def _psnr(img, gt):
    import numpy as np

    return float(-10.0 * np.log10(max(float(np.mean((img - gt) ** 2)), 1e-10)))


def _http_get(url, timeout=300):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def phase_garden(smi):
    """The garden main path: the dataset through tools.make_dataset, the
    renderer on the card against the CPU, the config-4 schedule through
    tools.train (one cut: GARDEN_EPOCHS), the facade on its outputs, the
    viewer on its PLY and checkpoint, and the graft entry."""
    import argparse
    import contextlib
    import io
    import threading
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch
    from PIL import Image

    from gaussiansplatting_tpu_torch import graft_entry
    from gaussiansplatting_tpu_torch.config import RasterConfig
    from gaussiansplatting_tpu_torch.io import colmap
    from gaussiansplatting_tpu_torch.models import GaussianModel
    from gaussiansplatting_tpu_torch.ops import blend, rasterize
    from gaussiansplatting_tpu_torch.tools import make_dataset, trace, view
    from gaussiansplatting_tpu_torch.train import checkpoint, trainer

    root = os.path.join(SCRATCH, "garden")
    shutil.rmtree(root, ignore_errors=True)
    sparse, image_dir = os.path.join(root, "sparse", "0"), os.path.join(root, "images")
    res = {"launches": {}}

    # (i) the dataset through its CLI, at its defaults
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = make_dataset.main(["--out", root, "--device", DEVICE])
    ds = json.loads(buf.getvalue().strip().splitlines()[-1])
    n_images = len(os.listdir(image_dir))
    n_points = len(colmap.load_colmap(sparse).points)
    log(f"[garden] tools.make_dataset: {n_images} views {ds['width']}x{ds['height']}, "
        f"{n_points} SfM points; the ray tracer {ds['render_ms_per_view']:.3f} ms per view "
        f"(CUDA events), PNG writing {ds['png_s']:.3f} s (summed over the writer threads), "
        f"views traced and written {ds['views_s']:.3f} s, point cloud {ds['points_s']:.3f} s, "
        f"total {ds['total_s']:.3f} s (host clock) on {smi}")
    if rc != 0 or (n_images, ds["width"], ds["height"], n_points) != (
            GARDEN_VIEWS, GARDEN_WIDTH, GARDEN_HEIGHT, GARDEN_POINTS):
        raise AssertionError("tools.make_dataset did not write the garden at its defaults")
    res["dataset"] = ds
    res["scene_err"] = _scene_card_vs_cpu(smi)

    # (ii) the config-4 schedule through tools.train, observed from outside
    min_cap = 1 << 21
    ck_dir = os.path.join(root, "ck")
    ck = os.path.join(ck_dir, "latest.npz")
    metrics_path, out_ply = os.path.join(root, "metrics.jsonl"), os.path.join(root, "out.ply")
    argv = ["--colmap", sparse, "--images", image_dir, "--output", out_ply,
            "--epochs", str(GARDEN_EPOCHS), "--eval-split", str(GARDEN_EVAL_SPLIT),
            "--adaptive-capacity", "--pair-capacity", str(1 << 24), "--adaptive-pairs",
            "--min-pair-capacity", str(min_cap), "--chunk-slack", "0.5",
            "--checkpoint-dir", ck_dir, "--checkpoint-interval", str(GARDEN_CKPT_EVERY),
            "--metrics", metrics_path, "--device", DEVICE]
    n_eval = len(range(0, GARDEN_VIEWS, GARDEN_EVAL_SPLIT))
    iters = GARDEN_EPOCHS * (GARDEN_VIEWS - n_eval)
    events, stamps = [], []
    originals = (trainer.train_step, trainer.densify_step, trainer.opacity_reset_step)

    def train_step(*a, **k):
        out = originals[0](*a, **k)
        if len(stamps) in (0, iters - 1):          # after the first and the last step
            torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return out

    def densify_step(*a, **k):
        st, stats = originals[1](*a, **k)
        n = _check_prefix("garden densify", st.params)
        if n != int(stats.count):
            raise AssertionError(f"densify: {n} alive, stats say {int(stats.count)}")
        events.append(("densify", st.opt.t, tuple(int(x) for x in stats), st.params.capacity))
        return st, stats

    def opacity_reset_step(*a, **k):
        st = originals[2](*a, **k)
        _check_prefix("garden opacity reset", st.params)
        events.append(("reset", st.opt.t, None, st.params.capacity))
        return st

    _reset_launches()
    trainer.train_step, trainer.densify_step, trainer.opacity_reset_step = (
        train_step, densify_step, opacity_reset_step)
    try:
        _cli(argv, os.path.join(root, "console.txt"))
    finally:
        trainer.train_step, trainer.densify_step, trainer.opacity_reset_step = originals
    torch.cuda.synchronize()
    launches = _tf_launches()
    _check_no_v1("the garden trainer", launches)
    lines = _read_jsonl(metrics_path)
    steps = [x for x in lines if x["event"] == "step"]
    info = [x["msg"] for x in lines if x["event"] == "info"]
    if [x["iter"] for x in steps] != list(range(1, iters + 1)):
        raise AssertionError(f"garden: expected step lines 1..{iters}")
    for x in steps:
        if not all(np.isfinite(x[f]) for f in ("loss", "l1", "dssim", "psnr", "mean_scale")):
            raise AssertionError(f"garden step {x['iter']}: non-finite metrics")
    if [e[1] for e in events if e[0] == "densify"] != GARDEN_DENSIFY_AT or \
            any(e[0] == "reset" for e in events):
        raise AssertionError(f"garden density events {events}")
    if launches["windowed_blend_fwd"] != iters + n_eval or \
            launches["windowed_blend_bwd"] != iters:
        raise AssertionError(f"garden: expected {iters + n_eval} forward and {iters} backward "
                             f"launches, got {launches}")
    res["launches"]["garden"] = launches
    wall = stamps[-1] - stamps[0]
    res["iters_per_s"] = (iters - 1) / wall
    res["peak_pairs"] = max(x["pairs"] for x in steps)
    res["overflow_steps"] = sum(bool(x["overflow"]) for x in steps)
    rebuckets = [m for m in info if "pair capacity" in m]
    grows = [m for m in info if ": capacity " in m]
    res["rebuckets"] = len(rebuckets)
    last_cap = int(rebuckets[-1].split("-> ")[1].split()[0]) if rebuckets else min_cap
    psnr = np.array([x["psnr"] for x in steps])
    cuts = [0] + GARDEN_DENSIFY_AT + [iters]
    stretch = [(a + 1, b, float(psnr[a:b].mean())) for a, b in zip(cuts, cuts[1:])]
    n_train = GARDEN_VIEWS - n_eval
    epoch_psnr = psnr.reshape(GARDEN_EPOCHS, n_train).mean(1)
    log(f"[garden] tools.train (config-4 flags, {GARDEN_EPOCHS} epochs of {n_train} views, "
        f"{n_eval} held out): {res['iters_per_s']:.3f} iterations/s over iterations 2-{iters} "
        f"({wall:.3f} s, host clock, synchronized) on {smi}")
    log(f"[garden] scene: {steps[0]['n']} alive at iteration 1; density events (iteration, "
        f"(pruned, cloned, split, alive), capacity): "
        + "; ".join(f"{e[1]} {e[2]} {e[3]}" for e in events) + f"; {'; '.join(grows) or 'no grow'}")
    log(f"[garden] pair capacity: {len(rebuckets)} rebuckets ({'; '.join(rebuckets)}), last "
        f"{last_cap}; peak pairs {res['peak_pairs']}; {res['overflow_steps']} overflow steps")
    log(f"[garden] train PSNR: per epoch {np.round(epoch_psnr, 3).tolist()} dB; between "
        f"events " + "; ".join(f"iterations {a}-{b}: {m:.3f} dB" for a, b, m in stretch))
    ev = [x for x in lines if x["event"] == "eval"]
    ex = [x for x in lines if x["event"] == "export_ply"]
    final, saved_cfg = checkpoint.load(ck, DEVICE)
    res["final_alive"] = _check_prefix("garden final state", final.params)
    if not ev or not np.isfinite(ev[0]["psnr"]) or not ex or final.opt.t != iters:
        raise AssertionError("garden: missing eval / export_ply line or final checkpoint")
    res["heldout_psnr"] = ev[0]["psnr"]
    ply_n = _ply_vertex_count(out_ply)
    log(f"[garden] held-out eval: {ev[0]} ; PLY {ply_n} vertices, final alive "
        f"{res['final_alive']} of {final.params.capacity} slots")
    if ex[0]["alive"] != res["final_alive"] or ply_n != res["final_alive"]:
        raise AssertionError("garden: the PLY does not hold the final alive count")
    # --adaptive-pairs against the pinned capacity: the final state's step at
    # the capacity the rebuckets reached and at the flag's 2^24, which the
    # run holds without --adaptive-pairs
    cam1, gt1 = _garden_camera(sparse, image_dir, 1)
    res["step_device_ms"] = trace.step_breakdown(
        {f"iteration {iters}": final}, cam1, torch.from_numpy(gt1).to(DEVICE), saved_cfg,
        [last_cap, 1 << 24], last_cap, iters, smi, DEVICE, log, "[garden step]",
        STEP_PROFILE_STEPS, STEP_PROFILE_TOP)[f"iteration {iters}"]

    # (iii) the facade on the trainer's outputs
    cam0, gt0 = _garden_camera(sparse, image_dir, 0)        # held out (index % 20 == 0)
    _reset_launches()
    model = GaussianModel.from_checkpoint(ck, device=DEVICE)
    img = model.render(cam0)
    res["facade_psnr"] = _psnr(img, gt0)
    ply2 = os.path.join(root, "facade.ply")
    model.save_ply(ply2)
    again = GaussianModel.from_ply(ply2, model.config, device=DEVICE).render(cam0)
    ply_err = float(np.abs(again - img).max())
    model, cams, gts = GaussianModel.from_colmap_scene(sparse, image_dir, device=DEVICE)
    n0 = model.num_gaussians
    model.train(cams[1:1 + FACADE_ITERS], gts[1:1 + FACADE_ITERS], epochs=1)
    torch.cuda.synchronize()
    launches = _tf_launches()
    _check_no_v1("the facade", launches)
    res["launches"]["facade"] = launches
    log(f"[garden] GaussianModel.from_checkpoint: held-out view 0 at {res['facade_psnr']:.3f} "
        f"dB; save_ply / from_ply max|diff| {ply_err:.2e}; from_colmap_scene {n0} alive of "
        f"{model.params.capacity}, train {FACADE_ITERS} iterations -> t {model.state.opt.t}; "
        f"launches {launches}")
    if ply_err > FACADE_PLY_ATOL or n0 != GARDEN_POINTS or model.state.opt.t != FACADE_ITERS:
        raise AssertionError("the facade path failed its checks")
    if launches["windowed_blend_fwd"] != 2 + FACADE_ITERS or \
            launches["windowed_blend_bwd"] != FACADE_ITERS:
        raise AssertionError(f"facade launches {launches}")
    del model, cams, gts
    torch.cuda.empty_cache()

    # (iv) the viewer: frames of the trained PLY, then /train from the
    # trainer's checkpoint
    vw, vh = VIEWER_SIZE
    state = view.build_state(out_ply, vw, vh, 60.0, 0, last_cap, device=DEVICE)
    overflow = []
    inner = rasterize.render

    def render(*a, **k):
        img, aux = inner(*a, **k)
        overflow.append(aux.overflow)
        return img, aux

    srv = ThreadingHTTPServer(("127.0.0.1", 0), view.make_handler(state))
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    serving = threading.Thread(target=srv.serve_forever, daemon=True)
    serving.start()
    frame_ms = []
    rasterize.render = render
    try:
        page = _http_get(base + "/")
        st = json.loads(_http_get(base + "/state"))
        _reset_launches()
        for i in range(VIEWER_FRAMES):
            q = (f"/frame?az={st['az'] + 2 * np.pi * i / VIEWER_FRAMES:.4f}&el={st['el']:.4f}"
                 f"&r={st['r']:.4f}&cx={st['cx']:.4f}&cy={st['cy']:.4f}&cz={st['cz']:.4f}")
            t0 = time.perf_counter()
            jpg = _http_get(base + q)
            frame_ms.append(1e3 * (time.perf_counter() - t0))
            arr = np.asarray(Image.open(io.BytesIO(jpg)))
            if arr.shape != (vh, vw, 3) or arr.min() == arr.max():
                raise AssertionError(f"viewer frame {i}: shape {arr.shape} or constant")
        torch.cuda.synchronize()
        launches = _tf_launches()
    finally:
        rasterize.render = inner
        srv.shutdown()
        srv.server_close()
        serving.join(timeout=60)
    _check_no_v1("the viewer's frames", launches)
    res["frame_ms_p50"], res["frame_ms_p90"] = (float(np.percentile(frame_ms, p))
                                                for p in (50, 90))
    n_over = int(torch.stack(overflow).sum())
    log(f"[garden] tools.view {vw}x{vh}, pair capacity {last_cap}: page {len(page)} bytes, "
        f"state {st}; {VIEWER_FRAMES} frames along an orbit: p50 {res['frame_ms_p50']:.3f} ms, "
        f"p90 {res['frame_ms_p90']:.3f} ms per frame (host clock, request to response), "
        f"{n_over} overflowed; launches {launches} on {smi}")
    if b"viewer" not in page or n_over or launches["windowed_blend_fwd"] != VIEWER_FRAMES \
            or launches["windowed_blend_bwd"] != 0:
        raise AssertionError("the viewer's frames failed their checks")
    viewer_launches = dict(launches)

    args = argparse.Namespace(colmap=sparse, images=image_dir, checkpoint=ck, downscale=1,
                              iters=iters, width=vw, height=vh, fov=60.0, sh_degree=0,
                              pair_capacity=last_cap, device=DEVICE)
    tstate = view.build_training_state(args)
    t_ck = tstate.iteration
    srv = ThreadingHTTPServer(("127.0.0.1", 0), view.make_handler(tstate))
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    serving = threading.Thread(target=srv.serve_forever, daemon=True)
    serving.start()
    try:
        q = "/frame?az=0.3&el=0.3"
        before = _http_get(base + q)
        _reset_launches()
        t0 = time.perf_counter()
        trained = json.loads(_http_get(base + f"/train?n={VIEWER_TRAIN}"))
        train_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = _tf_launches()
        after = _http_get(base + q)
    finally:
        srv.shutdown()
        srv.server_close()
        serving.join(timeout=60)
    _check_no_v1("the viewer's /train", launches)
    log(f"[garden] tools.view with the dataset and checkpoint (iteration {t_ck}): "
        f"/train?n={VIEWER_TRAIN} -> {trained} in {train_s:.3f} s (host clock); launches "
        f"{launches}; the frame at the same pose {'changed' if after != before else 'SAME'}")
    if trained["iteration"] != t_ck + VIEWER_TRAIN or not np.isfinite(trained["loss"]) or \
            after == before or launches["windowed_blend_fwd"] != VIEWER_TRAIN or \
            launches["windowed_blend_bwd"] != VIEWER_TRAIN:
        raise AssertionError("the viewer's /train failed its checks")
    res["launches"]["viewer"] = {k: viewer_launches[k] + launches[k] for k in launches}
    del state, tstate
    torch.cuda.empty_cache()

    # (v) the graft entry: one forward on the card, #1 at B = 64
    forward, (params, camera) = graft_entry.entry(DEVICE)
    _reset_launches()
    with torch.no_grad():
        img = forward(params, camera)
    torch.cuda.synchronize()
    res["launches"]["entry"] = _tf_launches()
    _check_no_v1("the graft entry", res["launches"]["entry"])
    if res["launches"]["entry"]["windowed_blend_fwd"] != 1:
        raise AssertionError(f"entry launches {res['launches']['entry']}")
    cfg64 = RasterConfig(pair_capacity=1 << 15, pair_block=64)
    with torch.no_grad():
        args, _, aux = rasterize.blend_windows(params, camera, cfg64)
        res["entry_err"] = _compare("graft entry B=64", blend.windowed_blend_fwd(*args),
                                    blend.windowed_blend_fwd_plain(*args))
        blend.windowed_blend_fwd, kernel = blend.windowed_blend_fwd_plain, blend.windowed_blend_fwd
        try:
            plain = forward(params, camera)
        finally:
            blend.windowed_blend_fwd = kernel
    _check_image("graft entry", img, 256, 256)
    img_err = float((img - plain).abs().max())
    log(f"[garden] graft_entry.entry(): 256x256, {int(aux.num_pairs)} pairs, overflow "
        f"{bool(aux.overflow)}; image vs the plain blend's max|err| {img_err:.3e}")
    if bool(((img - plain).abs() > KERNEL_ATOL + KERNEL_RTOL * plain.abs()).any()):
        raise AssertionError("graft entry: the image disagrees with the plain blend's")
    shutil.rmtree(root)
    return res


def phase_tools(work, smi):
    """The measuring tools at full size: tools.profile's stage times,
    tools.trace's capture of 5 steps (top groups, device ms per step, the
    card's idle share) and utils.sol's floor, which must lie below the
    measured step's device time."""
    from gaussiansplatting_tpu_torch.tools import profile, trace
    from gaussiansplatting_tpu_torch.utils import sol

    res = {}
    _reset_launches()
    res["stages_ms"] = profile.stage_times(
        N_GAUSSIANS, WIDTH, HEIGHT, PAIR_CAPACITY, PAIR_BLOCK, names=profile.STAGES, device=DEVICE,
        emit=lambda s, ms: log(f"[tools] tools.profile {s}: {ms:.3f} ms (CUDA events) on {smi}"))
    out = os.path.join(SCRATCH, "trace")
    res["host_ms"] = trace.capture(TRACE_STEPS, N_GAUSSIANS, WIDTH, HEIGHT, PAIR_CAPACITY, out,
                                   DEVICE)
    rows = trace.aggregate(out, TRACE_STEPS, top=STEP_PROFILE_TOP)
    launches = _tf_launches()
    _check_no_v1("the measuring tools", launches)
    for name, ms in rows:
        log(f"[tools] tools.trace {ms:9.3f} ms/step  {name[:90]}")
    res["device_ms"] = rows[-1][1]
    res["idle"] = 1 - res["device_ms"] / res["host_ms"]
    log(f"[tools] tools.trace ({TRACE_STEPS} steps): device {res['device_ms']:.3f} ms per step, "
        f"host clock {res['host_ms']:.3f} ms per step: the card idles {res['idle']:.3f} of it; "
        f"launches {launches} on {smi}")
    model = sol.step_model(N_GAUSSIANS, PAIR_CAPACITY, HEIGHT, WIDTH, block=PAIR_BLOCK, work=work)
    res["floor_ms"], res["sol"] = model["floor_ms"], model
    log(f"[tools] utils.sol.step_model: {model['bytes_total']:.4e} bytes ({model['t_bytes_ms']:.4f}"
        f" ms), {model['instructions']:.4e} f32 instructions ({model['t_flops_ms']:.4f} ms): "
        f"floor {model['floor_ms']:.4f} ms against the measured {res['device_ms']:.3f} ms of "
        f"device time ({model['floor_ms'] / res['device_ms']:.4f}); by stage "
        + ", ".join(f"{k} {v / 1e6:.1f} MB" for k, v in model["bytes_by_stage"].items()))
    if not 0 < model["floor_ms"] < res["device_ms"]:
        raise AssertionError("utils.sol's floor is not below the measured step")
    if min(launches["windowed_blend_fwd"], launches["windowed_blend_bwd"]) < 1:
        raise AssertionError(f"the measuring tools launched no kernel: {launches}")
    res["launches"] = launches
    shutil.rmtree(out)
    return res


def _digest(state):
    """sha256 of every state array, for comparing ranks' states."""
    import hashlib

    from gaussiansplatting_tpu_torch.train.state import state_to_numpy

    h = hashlib.sha256()
    for k, v in sorted(state_to_numpy(state).items()):
        h.update(k.encode())
        h.update(v.tobytes())
    return h.hexdigest()


def _sharded_bars(label, st, m, ref, ref_m, lrs):
    """A sharded step against the single-card step: the loss within
    SHARDED_LOSS_RTOL, grad_accum within SHARDED_ACCUM_ATOL, pairs exact;
    parameters within SHARDED_PARAM_ATOL where the gradient is signal
    (|m| above NOISE_REL of the field's largest) and within 3 learning rates
    elsewhere: a first Adam step moves every element by about lr * sign(g),
    and a strip's partial sum rounds once more, which may flip the sign of a
    gradient that cancels to rounding noise (tests/test_sharding.py:377-391).
    Returns the errors: per field (signal max, max, entries beyond
    SHARDED_PARAM_ATOL)."""
    import numpy as np

    from gaussiansplatting_tpu_torch.train.optimizer import TRAINABLE
    from gaussiansplatting_tpu_torch.train.state import state_to_numpy

    got, want = state_to_numpy(st), state_to_numpy(ref)
    err = {"loss": abs(float(m.loss) - float(ref_m.loss)) / abs(float(ref_m.loss)),
           "accum": float(np.abs(got["accum/grad_accum"] - want["accum/grad_accum"]).max()),
           "pairs": (int(m.num_pairs), int(ref_m.num_pairs)),
           "bits": all(np.array_equal(got[k], want[k]) for k in got)}
    bad = (err["loss"] > SHARDED_LOSS_RTOL or err["accum"] > SHARDED_ACCUM_ATOL
           or err["pairs"][0] != err["pairs"][1] or bool(m.overflow))
    for f, lr in zip(TRAINABLE, lrs):
        mm = np.abs(want[f"opt/m/{f}"])
        signal = mm > NOISE_REL * mm.max()
        d = np.abs(got[f"params/{f}"] - want[f"params/{f}"])
        err[f] = (float(d[signal].max(initial=0.0)), float(d.max()),
                  int((d > SHARDED_PARAM_ATOL).sum()))
        bad |= err[f][0] > SHARDED_PARAM_ATOL or err[f][1] > 3 * lr + 1e-6
    if bad:
        raise AssertionError(f"{label} against the single-card step: {err}")
    return err


def _sharded_rank(topo, size):
    """One rank of phase 10 (iii), started by parallel.launch.spawn: the
    single-card references first, then the sharded render, step (plain and
    chunked) and batched step (K = 2) with their launches, the sharded step
    timed and profiled (the collectives' share).  ``size``: the scene's
    n, width, height, pair_capacity and pair_block, and the timed steps."""
    import numpy as np
    import torch

    from gaussiansplatting_tpu_torch.config import Config, RasterConfig
    from gaussiansplatting_tpu_torch.ops.rasterize import render
    from gaussiansplatting_tpu_torch.parallel import mesh as mesh_mod
    from gaussiansplatting_tpu_torch.parallel import sharded
    from gaussiansplatting_tpu_torch.tools.trace import device_profile
    from gaussiansplatting_tpu_torch.train import schedule
    from gaussiansplatting_tpu_torch.train import state as state_mod
    from gaussiansplatting_tpu_torch.train.trainer import train_step, train_step_batched
    from gaussiansplatting_tpu_torch.utils import synthetic

    dev = torch.device(topo["device"])
    w, h, reps = size["width"], size["height"], size["reps"]
    params = synthetic.make_scene(size["n"], seed=0, device=dev)
    cams = [synthetic.make_canonical_camera(w, h, fov_scale=f, device=dev)
            for f in BATCH_FOVS[:2]]
    gts = [torch.from_numpy(np.random.default_rng(1 + v).uniform(
        0, 1, (h, w, 3)).astype(np.float32)).to(dev) for v in range(2)]
    cfg = Config(raster=RasterConfig(pair_capacity=size["pair_capacity"],
                                     pair_block=size["pair_block"]))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    lrs = schedule.learning_rates(cfg.optim, 0, TRAIN_TOTAL_ITERS)
    mesh = mesh_mod.make_mesh()
    with torch.no_grad():
        img_ref, aux_ref = render(params, cams[0], cfg.raster)
    ref, ref_m = train_step(state_mod.create(params), cams[0], gts[0], cfg, TRAIN_TOTAL_ITERS)
    bref, bref_m = train_step_batched(state_mod.create(params), cams, gts, cfg,
                                      TRAIN_TOTAL_ITERS)
    sync()

    _reset_launches()
    out = sharded.make_sharded_render(mesh, cfg)(params, cams[0])
    step = sharded.make_sharded_train_step(mesh, cfg, TRAIN_TOTAL_ITERS)
    st, m = step(state_mod.create(params), cams[0], gts[0])
    stc, _ = sharded.make_sharded_train_step(mesh, cfg, TRAIN_TOTAL_ITERS, grad_psum_chunks=4)(
        state_mod.create(params), cams[0], gts[0])
    sb, mb = sharded.make_sharded_train_step_batched(mesh, cfg, TRAIN_TOTAL_ITERS, 2)(
        state_mod.create(params), cams, gts)
    sync()
    res = {"topo": topo, "launches": _tf_launches(),
           "render_err": float((out.image - img_ref).abs().max()),
           "render_pairs": (int(out.num_pairs), int(aux_ref.num_pairs)),
           "step": _sharded_bars("sharded step", st, m, ref, ref_m, lrs),
           "batched": _sharded_bars("sharded batched step", sb, mb, bref, bref_m, lrs),
           "chunked_bits": _digest(stc) == _digest(st),
           "digests": [_digest(st), _digest(sb)], "loss": float(m.loss)}
    if res["render_pairs"][0] != res["render_pairs"][1] or res["render_err"] > RENDER_ATOL:
        raise AssertionError(f"sharded render against the single-card render: {res}")
    if not res["chunked_bits"]:
        raise AssertionError("chunked gradient all-reduce differs from the unchunked one")

    def one():
        nonlocal st
        st, _ = step(st, cams[0], gts[0])

    def timed():
        for _ in range(reps):
            one()
        sync()

    timed()
    t0 = time.perf_counter()
    timed()
    res["ms"] = (time.perf_counter() - t0) * 1e3 / reps
    # host time inside the collectives' spans (sharded.COLLECTIVE_SPANS):
    # gloo returns once the sum is back on the card, nccl once its kernel
    # is queued (its device time is in the kernels below)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        timed()
        host = (time.perf_counter() - t0) * 1e3 / reps
    coll = {e.key: e.cpu_time_total / 1e3 / reps for e in prof.key_averages()
            if e.key in sharded.COLLECTIVE_SPANS}
    quiet = topo["process_index"] != 0
    device_ms, kernels = device_profile(
        f"[parallel] sharded step, {size['ranks']} rank(s)", one, reps, size["smi"],
        device=str(dev), log=(lambda *_: None) if quiet else log, top=8)
    comm = {k: v for k, v in kernels.items() if "nccl" in k.lower() or k.startswith("Memcpy")}
    res.update(profile_host_ms=host, collectives_ms=coll,
               collectives_share=sum(coll.values()) / host, device_ms=device_ms,
               device_comm_ms=sum(comm.values()), device_comm_kernels=comm)
    return res


def phase_parallel(params, camera, cfg, gt, smi):
    """Tile strips, multi-view batched steps and tile-strip sharding at full
    size: (i) strips of the canonical view against the full render, default
    and T-floor, with their gradients (the main path `strips`), pair counts
    summing to the full frame's, the four kernel entries against their plain
    versions on strips at row0 > 0; (ii) train_step_batched against
    train_step (K = 1 bit for bit; K = 2 of one view: parameters bit for
    bit), K = 1, 2, 4 timed (`batched`), a 64x48 batched step card against
    CPU; (iii) the sharded render, step and batched step on 2 ranks sharing
    the card (gloo) and on 1 rank (nccl) against the single-card ones, the
    ranks' states bit-identical, chunked against unchunked all-reduces bit
    for bit, the sharded step timed and profiled (`sharded`); (iv)
    tools.train --batch-views 2 and --devices 2 on phase 7's scene; (v)
    tools.bench_scaling and graft_entry.dryrun_multichip(2)."""
    import math

    import numpy as np
    import torch

    from gaussiansplatting_tpu_torch import graft_entry
    from gaussiansplatting_tpu_torch.config import Config
    from gaussiansplatting_tpu_torch.core import gaussians
    from gaussiansplatting_tpu_torch.ops import blend
    from gaussiansplatting_tpu_torch.ops.losses import photometric_loss
    from gaussiansplatting_tpu_torch.ops.rasterize import blend_windows, render
    from gaussiansplatting_tpu_torch.parallel import launch
    from gaussiansplatting_tpu_torch.parallel.sharded import strip_rows
    from gaussiansplatting_tpu_torch.tools import bench_scaling
    from gaussiansplatting_tpu_torch.train import schedule
    from gaussiansplatting_tpu_torch.train import state as state_mod
    from gaussiansplatting_tpu_torch.train.optimizer import TRAINABLE
    from gaussiansplatting_tpu_torch.train.trainer import train_step, train_step_batched
    from gaussiansplatting_tpu_torch.utils import synthetic

    res, paths = {}, {}
    cfg_tf = cfg.replace(t_floor_exact=True)
    modes = (("default", cfg), ("tfloor", cfg_tf))
    trainable = [getattr(params, f) for f in TRAINABLE]

    # (i) strips against the full render, with their gradients
    with torch.no_grad():
        full = {mode: render(params, camera, c) for mode, c in modes}
    _reset_launches()
    res["strip_err"] = 0.0
    for n in PARALLEL_STRIPS:
        rows = strip_rows(HEIGHT, cfg.tile_size, n)
        for mode, c in modes:
            strips, pairs = [], 0
            for r in range(n):
                top = r * rows * cfg.tile_size
                with torch.enable_grad():
                    s, aux = render(params, camera, c, tile_rows=(r * rows, rows))
                    valid = s[:max(min(HEIGHT - top, s.shape[0]), 0)]
                    rep = photometric_loss(valid, gt[top:top + valid.shape[0]], Config().loss)
                    grads = torch.autograd.grad(rep.grad_loss, trainable)
                if bool(aux.overflow) or not all(bool(torch.isfinite(g).all()) for g in grads):
                    raise AssertionError(f"strip {r} of {n} ({mode}): overflow or non-finite")
                strips.append(s.detach())
                pairs += int(aux.num_pairs)
            err = float((torch.cat(strips)[:HEIGHT] - full[mode][0]).abs().max())
            res["strip_err"] = max(res["strip_err"], err)
            log(f"[parallel] {n} strips of {rows} tile rows ({mode}): max|stacked - full| "
                f"{err:.3e}; pairs {pairs} (full frame {int(full[mode][1].num_pairs)})")
            if pairs != int(full[mode][1].num_pairs) or err > STRIP_IMG_MAX:
                raise AssertionError(f"{n} strips ({mode}) differ from the full render")
    torch.cuda.synchronize()
    paths["strips"] = _tf_launches()
    _check_no_v1("the strips", paths["strips"])
    if min(paths["strips"][k] for k in MAIN_ENTRIES) < 1:
        raise AssertionError(f"the strips did not launch every kernel: {paths['strips']}")
    log(f"[parallel] strips main path: launches {paths['strips']}")
    log_thr = math.log(cfg_tf.transmittance_floor)
    res["strip_kernel_err"] = {}
    for n in PARALLEL_STRIPS:
        rows = strip_rows(HEIGHT, cfg.tile_size, n)
        tile_rows = ((n - 1) * rows, rows)                 # the last strip: row0 > 0
        top = tile_rows[0] * cfg.tile_size
        gt_rows = gt[top:top + rows * cfg.tile_size]
        label = f"strip row0={tile_rows[0]} of {rows} rows"
        with torch.no_grad():
            args, block_tile, _ = blend_windows(params, camera, cfg, tile_rows)
            out, gid = blend.windowed_blend_fwd(*args)
            e_fwd = _compare(label, (out, gid), blend.windowed_blend_fwd_plain(*args))
        g = _loss_cotangent(out, block_tile, camera, cfg, gt_rows, tile_rows)
        bargs = args[:6] + (g, out[:, 3].contiguous(), args[6])
        e_bwd = _compare_bwd(label, blend.windowed_blend_bwd(*bargs),
                             blend.windowed_blend_bwd_plain(*bargs))
        logti, out_tf, stop, _, g2 = _tf_pass_cotangents(args, out, block_tile, camera, cfg_tf,
                                                         gt_rows, log_thr, tile_rows)
        with torch.no_grad():
            want, _, margin = blend.windowed_blend_fwd_tf_plain(*args, logti, log_thr,
                                                                 return_margin=True)
            e_ftf, _ = _compare_tf(label, out_tf, want, margin)
            targs = args[:6] + (g2, out_tf[:, 3].contiguous(), stop, args[6], logti, log_thr)
            e_btf, _ = _compare_tf_bwd(label, blend.windowed_blend_bwd_tf(*targs),
                                       blend.windowed_blend_bwd_tf_plain(*targs), margin)
        res["strip_kernel_err"][tile_rows[0]] = (e_fwd, e_bwd, e_ftf, e_btf)

    # (ii) train_step_batched against train_step, then K views timed
    cfg_step = Config(raster=cfg)
    ref, _ = train_step(state_mod.create(params), camera, gt, cfg_step, TRAIN_TOTAL_ITERS)
    one, _ = train_step_batched(state_mod.create(params), [camera], [gt], cfg_step,
                                TRAIN_TOTAL_ITERS)
    two, _ = train_step_batched(state_mod.create(params), [camera, camera], [gt, gt], cfg_step,
                                TRAIN_TOTAL_ITERS)
    r, a, b = (state_mod.state_to_numpy(x) for x in (ref, one, two))
    differ = [k for k in r if not np.array_equal(a[k], r[k])]
    if differ:
        raise AssertionError(f"batched K = 1 differs from train_step in {differ}")
    params_differ = [f for f in TRAINABLE if not np.array_equal(b[f"params/{f}"],
                                                                r[f"params/{f}"])]
    moments = {k: (int((b[k] != r[k]).sum()), float(np.abs(b[k] - r[k]).max()))
               for k in r if k.startswith("opt/") and not np.array_equal(b[k], r[k])}
    res["k2_params_differ"], res["k2_moments_differ"] = params_differ, moments
    log(f"[parallel] batched K = 1: all {len(r)} state arrays = train_step's bit for bit; "
        f"K = 2 of one view: parameters differing {params_differ or 'none'}; moments "
        f"differing (entries, max|diff|) {moments or 'none'}")
    if params_differ:
        for f in params_differ:
            d = np.abs(b[f"params/{f}"] - r[f"params/{f}"])
            log(f"[parallel]   params/{f}: {int((d > 0).sum())} entries, max {d.max():.3e}")
        if max(float(np.abs(b[f"params/{f}"] - r[f"params/{f}"]).max())
               for f in params_differ) > STEP_ATOL:
            raise AssertionError("batched K = 2 of one view moves the parameters")
    del ref, one, two
    cams = [synthetic.make_canonical_camera(WIDTH, HEIGHT, fov_scale=f, device=DEVICE)
            for f in BATCH_FOVS]
    gts = [torch.from_numpy(np.random.default_rng(1 + v).uniform(
        0, 1, (HEIGHT, WIDTH, 3)).astype(np.float32)).to(DEVICE) for v in range(len(cams))]
    res["batched_ms"], res["batched_views_per_s"] = {}, {}
    _reset_launches()
    for k in BATCH_VIEWS:
        st, m = train_step_batched(state_mod.create(params), cams[:k], gts[:k], cfg_step,
                                   TRAIN_TOTAL_ITERS)
        overflow = [m.overflow]
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(PARALLEL_TIMED_STEPS):
            st, m = train_step_batched(st, cams[:k], gts[:k], cfg_step, TRAIN_TOTAL_ITERS)
            overflow.append(m.overflow)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / PARALLEL_TIMED_STEPS
        res["batched_ms"][k], res["batched_views_per_s"][k] = ms, k * 1e3 / ms
        _check_finite_state(f"batched K = {k}", st)
        if bool(torch.stack(overflow).any()) or not math.isfinite(float(m.loss)):
            raise AssertionError(f"batched K = {k}: overflow or non-finite loss")
        log(f"[parallel] train_step_batched K = {k}: {ms:.3f} ms/step, "
            f"{res['batched_views_per_s'][k]:.1f} views/s (CUDA events, "
            f"{PARALLEL_TIMED_STEPS} steps) on {smi}; num_pairs (max over views) "
            f"{int(m.num_pairs)}")
    paths["batched"] = _tf_launches()
    _check_no_v1("the batched steps", paths["batched"])
    if min(paths["batched"]["windowed_blend_fwd"], paths["batched"]["windowed_blend_bwd"]) < 1:
        raise AssertionError(f"the batched steps launched no kernel: {paths['batched']}")
    small = synthetic.make_scene(64, seed=5, spread=0.6)
    small_cfg = cfg_step.replace(raster=cfg.replace(pair_capacity=4096, pair_block=16))
    small_gts = np.random.default_rng(2).uniform(0, 1, (2, 48, 64, 3)).astype(np.float32)
    host = {f: getattr(small, f).detach().numpy() for f in gaussians.FIELDS}
    small_cams = [synthetic.make_canonical_camera(64, 48, fov_scale=f) for f in BATCH_FOVS[:2]]
    cpu_state, cpu_m = train_step_batched(
        state_mod.create(small), small_cams, [torch.from_numpy(g) for g in small_gts],
        small_cfg, 100)
    dev_state, dev_m = train_step_batched(
        state_mod.create(gaussians.params_from_numpy(host, DEVICE)),
        [c.to(DEVICE) for c in small_cams],
        [torch.from_numpy(g).to(DEVICE) for g in small_gts], small_cfg, 100)
    _compare_small_step(dev_state, dev_m, cpu_state, cpu_m,
                        schedule.learning_rates(small_cfg.optim, 0, 100),
                        label="64x48 batched step (K = 2)")

    # (iii) the sharded steps: 2 ranks sharing the card (gloo), 1 rank (nccl)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    res["sharded"] = {}
    for n_ranks in (2, 1):
        size = {"n": N_GAUSSIANS, "width": WIDTH, "height": HEIGHT, "reps": SHARDED_TIMED_STEPS,
                "pair_capacity": PAIR_CAPACITY, "pair_block": PAIR_BLOCK, "ranks": n_ranks,
                "smi": smi}
        ranks = launch.spawn(_sharded_rank, n_ranks, (size,), device=DEVICE)
        r0 = ranks[0]
        backend = r0["topo"]["backend"]
        if any(x["digests"] != r0["digests"] for x in ranks):
            raise AssertionError(f"{n_ranks} ranks: the ranks' states differ")
        res["sharded"][n_ranks] = {k: r0[k] for k in (
            "ms", "profile_host_ms", "collectives_ms", "collectives_share", "device_ms",
            "device_comm_ms", "render_err", "step", "batched")}
        res["sharded"][n_ranks]["backend"] = backend
        paths.setdefault("sharded", {k: 0 for k in r0["launches"]})
        for x in ranks:
            for k, v in x["launches"].items():
                paths["sharded"][k] += v
        log(f"[parallel] {r0['topo']}")
        log(f"[parallel] sharded step, {n_ranks} rank(s) on one card ({backend}; the strip "
            f"scheme's overhead on one card, not scaling): {r0['ms']:.3f} ms/step (host clock, "
            f"{SHARDED_TIMED_STEPS} steps, synchronized) on {smi}; profiled "
            f"{r0['profile_host_ms']:.3f} ms/step, of it in the collectives' spans "
            f"{r0['collectives_share']:.3f} ({r0['collectives_ms']} ms/step); device time "
            f"{r0['device_ms']:.3f} ms/step, of it nccl kernels and memcpys "
            f"{r0['device_comm_ms']:.3f} ({r0['device_comm_kernels']}); vs the single-card "
            f"step: step {r0['step']}, batched "
            f"{r0['batched']}; render max|err| {r0['render_err']:.3e}; ranks' states "
            f"bit-identical; chunked all-reduce bit-identical; launches rank 0 {r0['launches']}")
    _check_no_v1("the sharded steps", paths["sharded"])
    if min(paths["sharded"][k] for k in ("windowed_blend_fwd", "windowed_blend_bwd")) < 1:
        raise AssertionError(f"the sharded steps launched no kernel: {paths['sharded']}")

    # (iv) tools.train --batch-views 2 and --devices 2 on phase 7's scene
    root = os.path.join(SCRATCH, "parallel")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    sparse, image_dir, _ = write_colmap_scene(
        root, params, TRAINLOOP_VIEWS, WIDTH, HEIGHT,
        cfg.replace(pair_capacity=TRAINLOOP_PAIR_CAPACITY))
    res["cli"] = {}
    for flags in (["--batch-views", "2"], ["--devices", "2"]):
        out = os.path.join(root, flags[0][2:])
        metrics_path = os.path.join(out, "metrics.jsonl")
        t0 = time.time()
        _cli(["--colmap", sparse, "--images", image_dir, "--output", os.path.join(out, "out.ply"),
              "--device", DEVICE, "--pair-capacity", str(TRAINLOOP_PAIR_CAPACITY),
              "--eval-split", "4", "--epochs", str(PARALLEL_CLI_EPOCHS), "--metrics",
              metrics_path, *flags], os.path.join(root, "cli.log"))
        seconds = time.time() - t0
        lines = _read_jsonl(metrics_path)
        steps = [x for x in lines if x["event"] == "step"]
        n_train = TRAINLOOP_VIEWS - len(range(0, TRAINLOOP_VIEWS, 4))
        per_epoch = -(-n_train // (2 if flags[0] == "--batch-views" else 1))
        start = next(x for x in lines if x["event"] == "start")
        if ([x["iter"] for x in steps] != list(range(1, PARALLEL_CLI_EPOCHS * per_epoch + 1))
                or not all(math.isfinite(x["loss"]) and not x["overflow"] for x in steps)
                or sum(x["event"] == "export_ply" for x in lines) != 1):
            raise AssertionError(f"tools.train {' '.join(flags)}: {lines}")
        res["cli"][flags[0]] = {"iters": len(steps), "seconds": seconds,
                                "psnr": [steps[0]["psnr"], steps[-1]["psnr"]],
                                "process_count": start["process_count"],
                                "backend": start["backend"]}
        log(f"[parallel] tools.train {' '.join(flags)}: {len(steps)} iterations in "
            f"{seconds:.1f} s (start to exit, ranks' start-up included), PSNR "
            f"{steps[0]['psnr']:.2f} -> {steps[-1]['psnr']:.2f}, {start['process_count']} "
            f"process(es), backend {start['backend']}, one metrics stream and one PLY")
    shutil.rmtree(root)

    # (v) the scaling tool and the graft entry's dry run
    res["scaling"] = bench_scaling.bench([
        "--n", str(N_GAUSSIANS), "--width", str(WIDTH), "--height", str(HEIGHT),
        "--pair-capacity", str(PAIR_CAPACITY), "--steps", str(SHARDED_TIMED_STEPS),
        "--devices", "2", "--device", DEVICE])
    if any(x["overflow"] for x in res["scaling"]) or len(res["scaling"]) != 2:
        raise AssertionError(f"tools.bench_scaling: {res['scaling']}")
    res["dryrun"] = graft_entry.dryrun_multichip(2, device=DEVICE)
    log(f"[parallel] tools.bench_scaling (2 ranks on one card: overhead, not scaling): "
        f"{res['scaling']} on {smi}; graft_entry.dryrun_multichip(2): {res['dryrun'][0]}")
    res["launches"] = paths
    return res


def _packed_consts(cfg, pack_pos, tiles_x=50):
    return (16, cfg.power_floor, cfg.alpha_cap, cfg.alpha_floor, tiles_x, 1, int(pack_pos))


def _compare_packed_bwd(label, got, want, quiet=False):
    """Packed backward kernel vs plain: both unpacked, each of the nine
    columns within one bf16 ulp of the value (2^-7 |value|) plus
    PACKED_BWD_REL of the column's largest plain magnitude.  Returns the max
    |err| and the largest error beyond the ulp term over the column's
    largest."""
    import torch

    from gaussiansplatting_tpu_torch.ops import packing

    got = torch.stack(packing.unpack_cols(list(got), 9))
    want = torch.stack(packing.unpack_cols(list(want), 9))
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: packed backward has non-finite values")
    err = (got - want).abs()
    scale = want.abs().flatten(1).amax(1).clamp(min=1e-30)[:, None, None]
    beyond = ((err - 2.0 ** -7 * want.abs()).clamp(min=0) / scale)
    worst, rel = float(err.max()), float(beyond.max())
    if not quiet or rel > PACKED_BWD_REL:
        log(f"[modes] {label}: packed backward max|err| {worst:.3e}; beyond a bf16 ulp "
            f"{rel:.2e} of the column's largest (bar {PACKED_BWD_REL}); entries differing "
            f"{int((err > 0).sum())} of {err.numel()}")
    if rel > PACKED_BWD_REL:
        raise AssertionError(f"{label}: packed backward disagrees with the plain version")
    return worst, rel


def _compare_packed_fwd(label, got, want, quiet=False):
    """Packed forward kernel vs plain: (out, gid) as _compare, q_b within
    KERNEL_ATOL + KERNEL_RTOL.  Returns the max |err| over out and q_b."""
    err = _compare(label, got[:2], want[:2], quiet)
    q_err = (got[2] - want[2]).abs()
    if bool((q_err > KERNEL_ATOL + KERNEL_RTOL * want[2].abs()).any()):
        raise AssertionError(f"{label}: q_b disagrees with the plain version")
    return max(err, float(q_err.max()))


def _grads(params, camera, cfg, weights):
    """The trainable fields' gradients of sum(image * weights), the loss of
    JAX's bf16 gradient bar (tests/test_packing.py:111-131)."""
    import torch

    from gaussiansplatting_tpu_torch.ops.rasterize import render
    from gaussiansplatting_tpu_torch.train.optimizer import TRAINABLE

    with torch.enable_grad():
        img, _ = render(params, camera, cfg)
        return dict(zip(TRAINABLE, torch.autograd.grad(
            (img * weights).sum(), [getattr(params, f) for f in TRAINABLE])))


def _packed_launches(label, both):
    """The counts of a bf16 path just run: the packed forward (``both``:
    and backward) launched, the float32 entries not."""
    launches = _tf_launches()
    _check_no_v1(label, launches)
    names = ("windowed_blend_fwd_packed", "windowed_blend_bwd_packed")[:2 if both else 1]
    if (min(launches[n] for n in names) < 1
            or any(launches[n[:-len("_packed")]] for n in names)):
        raise AssertionError(f"{label}: packed kernels not launched or float32 ones were: "
                             f"{launches}")
    return launches


def phase_modes(params, camera, cfg, gt, smi):
    """The bf16 payload mode, the impact drop and the scatter reduction at
    full size: (i) the packed kernels (plain and pack_pos) against their
    plain versions on edge windows and on the canonical view's packed
    windows with the real loss cotangent (the backward launched twice,
    bit-identical), timed against the float32 Hopper kernels in turns,
    their work and bounds; (ii) the bf16 render (`modes_render`) and train
    step (`modes_train`, timed, replayed bit for bit, profiled) against
    the float32 ones at JAX's bars, only the packed kernels launching; a
    64x48 bf16 + pack_pos step on the card against the CPU; (iii) the
    impact drop's
    capacity plan on the card against the CPU (integer-exact) and a capped
    render; the scatter reduction twice bit for bit and against a float64
    sum, a scatter step; (iv) tools.train --payload-dtype bf16
    --pack-positions 1 (`modes_cli`)."""
    import dataclasses

    import numpy as np
    import torch

    from gaussiansplatting_tpu_torch.config import Config
    from gaussiansplatting_tpu_torch.core import gaussians
    from gaussiansplatting_tpu_torch.ops import blend, packing, pairs
    from gaussiansplatting_tpu_torch.ops import projection as proj_mod
    from gaussiansplatting_tpu_torch.ops.rasterize import (
        _plan, _windows, blend_windows, render)
    from gaussiansplatting_tpu_torch.tools import trace
    from gaussiansplatting_tpu_torch.train import schedule
    from gaussiansplatting_tpu_torch.train import state as state_mod
    from gaussiansplatting_tpu_torch.train.optimizer import TRAINABLE
    from gaussiansplatting_tpu_torch.train.trainer import train_step
    from gaussiansplatting_tpu_torch.utils import sol, synthetic

    res, paths = {"fwd": {}, "bwd": {}}, {}
    bf16 = cfg.replace(payload_dtype="bf16")
    modes = (("bf16", bf16), ("bf16+pack_pos", bf16.replace(pack_positions=True)))

    # (i) the packed kernels against their plain versions
    fwd_err = bwd_err = bwd_rel = 0.0
    with torch.no_grad():
        for block in EDGE_BLOCKS:
            for row0 in (0, 3):
                for pp in (False, True):
                    e = [torch.from_numpy(x).to(DEVICE)
                         for x in packed_edge_windows(block, block + row0, row0, pp)]
                    a = (*e, row0, block, _packed_consts(cfg, pp))
                    label = f"edge B={block} row0={row0} pack_pos={int(pp)}"
                    got = blend.windowed_blend_fwd_packed(*a)
                    fwd_err = max(fwd_err, _compare_packed_fwd(
                        label, got, blend.windowed_blend_fwd_packed_plain(*a), quiet=True))
                    g = torch.from_numpy(np.random.default_rng(block + row0).normal(
                        size=(e[1].shape[0], 4, 256)).astype(np.float32)).to(DEVICE)
                    b = a[:6] + (g, got[2], a[6])
                    err, rel = _compare_packed_bwd(label, blend.windowed_blend_bwd_packed(*b),
                                                   blend.windowed_blend_bwd_packed_plain(*b),
                                                   quiet=True)
                    bwd_err, bwd_rel = max(bwd_err, err), max(bwd_rel, rel)
        log(f"[modes] edge windows (B = {EDGE_BLOCKS}, row0 0 and 3, pack_pos 0 and 1): "
            f"packed forward max|err| {fwd_err:.3e} (bar {KERNEL_ATOL} + {KERNEL_RTOL} rel), "
            f"backward max|err| {bwd_err:.3e}, beyond a bf16 ulp {bwd_rel:.2e} of the "
            f"column's largest (bar {PACKED_BWD_REL})")
        f32_args, block_tile, _ = blend_windows(params, camera, cfg)
        f32_out, _ = blend.windowed_blend_fwd(*f32_args)
        g = _loss_cotangent(f32_out, block_tile, camera, cfg, gt)
        f32_bargs = f32_args[:6] + (g, f32_out[:, 3].contiguous(), f32_args[6])
        for name, c in modes:
            args, bt, aux = blend_windows(params, camera, c)
            if not torch.equal(bt, block_tile):
                raise AssertionError(f"{name}: the packed windows tile differently")
            got = blend.windowed_blend_fwd_packed(*args)
            want = blend.windowed_blend_fwd_packed_plain(*args)
            fe = _compare_packed_fwd(f"full size {name}", got, want)
            bargs = args[:6] + (g, got[2], args[6])
            once = blend.windowed_blend_bwd_packed(*bargs)
            again = blend.windowed_blend_bwd_packed(*bargs)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(once, again)):
                raise AssertionError(f"{name}: two packed backward launches differ")
            be, br = _compare_packed_bwd(f"full size {name} (loss cotangent)", once,
                                         blend.windowed_blend_bwd_packed_plain(*bargs))
            fwd_ms, f32_fwd_ms, t_fwd = _turns(lambda: blend.windowed_blend_fwd_packed(*args),
                                               lambda: blend.windowed_blend_fwd(*f32_args))
            bwd_ms, f32_bwd_ms, t_bwd = _turns(lambda: blend.windowed_blend_bwd_packed(*bargs),
                                               lambda: blend.windowed_blend_bwd(*f32_bargs))
            w = sol.blend_work(args)
            nb, p2, block = args[1].shape[0], 256, args[5]
            rows = 6 if "pack_pos" in name else 7
            fwd_bound, fline = sol.work_bound(
                w, "fwd", 4 * rows * w["live_fwd"] + 12 * nb + 4 * nb * (5 * p2 + block),
                sol.FWD_PACKED_OPS_PER_KEPT)
            bwd_bound, bline = sol.work_bound(
                w, "bwd", 4 * rows * w["live_bwd"] + 4 * nb + 8 * w["bwd_blocks"]
                + 20 * w["bwd_pixels"] + 20 * nb * block, sol.BWD_PACKED_OPS_PER_KEPT)
            log(f"[modes] {name}: {nb} blocks, {int(aux.num_pairs)} pairs; two backward "
                f"launches bit-identical; in turns (packed, float32, float32, packed) forward "
                f"{', '.join(f'{t:.4f}' for t in t_fwd)} ms, backward "
                f"{', '.join(f'{t:.4f}' for t in t_bwd)} ms (CUDA events, {KERNEL_REPS} "
                f"launches each) on {smi}")
            log(f"[modes] {name} forward work: {fline}")
            log(f"[modes] {name} backward work: {bline}")
            key = "pack_pos" if "pack_pos" in name else "bf16"
            res["fwd"][key] = {"max_abs_err": max(fwd_err, fe), "ms": fwd_ms,
                               "ms_f32": f32_fwd_ms, **fwd_bound}
            res["bwd"][key] = {"max_abs_err": max(bwd_err, be), "beyond_ulp_rel": max(bwd_rel, br),
                               "ms": bwd_ms, "ms_f32": f32_bwd_ms, **bwd_bound}
            if key == "bf16":
                res["fwd"][key]["plain_ms"] = cuda_time_ms(
                    lambda: blend.windowed_blend_fwd_packed_plain(*args), reps=3)
                res["bwd"][key]["plain_ms"] = cuda_time_ms(
                    lambda: blend.windowed_blend_bwd_packed_plain(*bargs), reps=3)
        del f32_args, f32_out, f32_bargs, args, bargs, got, want, once, again
    for k in ("fwd", "bwd"):
        r = res[k]["bf16"]
        log(f"[modes] full size packed {k}: {r['ms']:.4f} ms (pack_pos "
            f"{res[k]['pack_pos']['ms']:.4f}) vs float32 Hopper {r['ms_f32']:.4f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}) on {smi}")

    # (ii) the bf16 render and train step: main paths modes_render, modes_train
    with torch.no_grad():
        ref = render(params, camera, cfg)[0]
    _reset_launches()
    res["render"] = {}
    for name, c in modes:
        with torch.no_grad():
            img, aux = render(params, camera, c)
        d = (img - ref).abs()
        res["render"][name] = (float(d.max()), float(d.mean()))
        log(f"[modes] render {name} vs float32: max|diff| {float(d.max()):.3e}, mean "
            f"{float(d.mean()):.3e} (JAX's bars {MODE_IMG_MAX}, {MODE_IMG_MEAN}); "
            f"{int(aux.num_pairs)} pairs")
        if bool(aux.overflow) or not (float(d.max()) < MODE_IMG_MAX
                                      and float(d.mean()) < MODE_IMG_MEAN):
            raise AssertionError(f"render {name}: beyond JAX's bf16 bars or overflowed")
    torch.cuda.synchronize()
    paths["modes_render"] = _packed_launches("the bf16 render", False)
    weights = torch.from_numpy(np.random.default_rng(3).uniform(
        0.5, 1.0, tuple(gt.shape)).astype(np.float32)).to(DEVICE)
    g_ref = _grads(params, camera, cfg, weights)
    _reset_launches()
    res["grad_rel"] = {}
    for name, c in modes:
        gm = _grads(params, camera, c, weights)
        rel = {f: float((gm[f] - g_ref[f]).abs().max() / g_ref[f].abs().max())
               for f in TRAINABLE}
        res["grad_rel"][name] = rel
        log(f"[modes] gradients {name} vs float32, max|diff| over the field's largest: "
            + ", ".join(f"{f} {v:.2e}" for f, v in rel.items()) + f" (bar {MODE_GRAD_REL})")
        if max(rel.values()) >= MODE_GRAD_REL:
            raise AssertionError(f"gradients {name}: beyond JAX's bf16 bar")
    step_cfg = Config(raster=modes[1][1])
    state0 = state_mod.create(params)
    st, m = train_step(state0, camera, gt, step_cfg, TRAIN_TOTAL_ITERS)
    first = st
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    flags = [m.overflow]
    for _ in range(MODES_TIMED_STEPS):
        st, m = train_step(st, camera, gt, step_cfg, TRAIN_TOTAL_ITERS)
        flags.append(m.overflow)
    end.record()
    torch.cuda.synchronize()
    res["step_ms"] = start.elapsed_time(end) / MODES_TIMED_STEPS
    _check_finite_state("bf16 step", st)
    if bool(torch.stack(flags).any()):
        raise AssertionError("bf16 step overflowed")
    paths["modes_train"] = _packed_launches("the bf16 train step", True)
    _reset_launches()
    replay, _ = train_step(state0, camera, gt, step_cfg, TRAIN_TOTAL_ITERS)
    torch.cuda.synchronize()
    res["per_step"] = _tf_launches()
    a, b = state_mod.state_to_numpy(first), state_mod.state_to_numpy(replay)
    differ = [k for k in a if not np.array_equal(a[k], b[k])]
    if differ:
        raise AssertionError(f"replayed bf16 step differs in {differ}")
    log(f"[modes] bf16 + pack_pos train step at full size: {res['step_ms']:.3f} ms/step "
        f"(CUDA events, {MODES_TIMED_STEPS} steps) on {smi}; loss {float(m.loss):.5f}; "
        f"replayed bit for bit; launches per step {res['per_step']}")
    res["step_device_ms"], _ = trace.device_profile(
        "[modes] bf16 + pack_pos step", lambda: train_step(st, camera, gt, step_cfg,
                                                            TRAIN_TOTAL_ITERS),
        STEP_PROFILE_STEPS, smi, DEVICE, log, STEP_PROFILE_TOP)
    small = synthetic.make_scene(64, seed=5, spread=0.6)
    small_cfg = step_cfg.replace(raster=step_cfg.raster.replace(pair_capacity=4096,
                                                                pair_block=16))
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
                        schedule.learning_rates(small_cfg.optim, 0, 100),
                        label="64x48 bf16 + pack_pos step")

    # (iii) the impact drop and the scatter reduction
    with torch.no_grad():
        plan = _plan(params, camera, cfg)
        proj = proj_mod.project(params, camera, cfg)
        fields = {f.name: getattr(proj, f.name).detach() for f in dataclasses.fields(proj)}
        proj = proj_mod.Projected(**fields)
        tiles_x, tiles_y = plan.pcfg[2], plan.pcfg[3]
        cap = int(plan.aux.num_pairs) // 3
        dev_plan = pairs.capacity_plan(proj, tiles_x, tiles_y, cap, 0, "impact")
        cpu_proj = proj_mod.Projected(**{k: v.cpu() for k, v in fields.items()})
        cpu_plan = pairs.capacity_plan(cpu_proj, tiles_x, tiles_y, cap, 0, "impact")
        for x, y in zip(dev_plan, cpu_plan):
            if not torch.equal(x.cpu(), y):
                raise AssertionError("impact capacity plan: card and CPU differ")
        img, aux = render(params, camera, cfg.replace(pair_capacity=cap, overflow_drop="impact"))
        if not (bool(aux.overflow) and bool(torch.isfinite(img).all())
                and int(aux.num_pairs) <= cap):
            raise AssertionError("impact render at a third of the pairs")
        kept = int((dev_plan[0] > 0).sum())
        log(f"[modes] impact drop at {cap} pairs (a third of the frame's): card = CPU, "
            f"integer-exact; {kept} Gaussians keep {int(dev_plan[5])} pairs; the capped "
            f"render finite")
        win = _windows(plan.data, plan.ints, plan.pcfg)
        args = (win.table, win.block_src, win.block_valid, win.tile, 0, cfg.pair_block,
                plan.bconsts)
        out, gid = blend.windowed_blend_fwd(*args)
        d_rows = torch.stack([c.reshape(-1) for c in blend.windowed_blend_bwd(
            *args[:6], _loss_cotangent(out, win.block_tile, camera, cfg, gt),
            out[:, 3].contiguous(), args[6])])
        gid = gid.reshape(-1).to(torch.int32)
        counts, n = plan.ints[0], plan.pcfg[0]
        once = pairs.reduce_aligned_cotangents(d_rows, gid, counts, n, "scatter")
        again = pairs.reduce_aligned_cotangents(d_rows, gid, counts, n, "scatter")
        torch.cuda.synchronize()
        if not torch.equal(once, again):
            raise AssertionError("scatter reduction: two calls differ")
        live = gid >= 0
        ref64 = torch.zeros((n, 9), dtype=torch.float64).index_add_(
            0, gid[live].long().cpu(), d_rows[:, live].T.double().cpu())
        rel = float(((once.cpu().double() - ref64).norm(dim=0) / ref64.norm(dim=0)).max())
        res["scatter_rel_norm"] = rel
        res["scatter_ms"] = cuda_time_ms(
            lambda: pairs.reduce_aligned_cotangents(d_rows, gid, counts, n, "scatter"), reps=10)
        res["sortprefix_ms"] = cuda_time_ms(
            lambda: pairs.reduce_aligned_cotangents(d_rows, gid, counts, n), reps=10)
        packed_rows = torch.stack(packing.pack_cols(list(d_rows)))
        res["scatter_packed_ms"] = cuda_time_ms(
            lambda: pairs.reduce_aligned_cotangents(packed_rows, gid, counts, n, "scatter", 9),
            reps=10)
    log(f"[modes] scatter reduction at full size ({d_rows.shape[1]} lanes): two calls "
        f"bit-identical; each column within {rel:.3e} of a float64 sum in relative norm "
        f"(bar {SCATTER_REL_NORM}); {res['scatter_ms']:.4f} ms (packed rows "
        f"{res['scatter_packed_ms']:.4f} ms) vs sort-prefix {res['sortprefix_ms']:.4f} ms "
        f"(CUDA events, 10 calls) on {smi}")
    if rel > SCATTER_REL_NORM:
        raise AssertionError(f"scatter reduction {rel:.3e} off float64")
    sc_cfg = Config(raster=bf16.replace(grad_reduce="scatter"))
    sc1, _ = train_step(state0, camera, gt, sc_cfg, TRAIN_TOTAL_ITERS)
    sc2, _ = train_step(state0, camera, gt, sc_cfg, TRAIN_TOTAL_ITERS)
    a, b = state_mod.state_to_numpy(sc1), state_mod.state_to_numpy(sc2)
    if any(not np.array_equal(a[k], b[k]) for k in a):
        raise AssertionError("bf16 scatter step: a replay differs")
    log("[modes] bf16 train step with grad_reduce='scatter': replayed bit for bit")
    del state0, st, first, replay, sc1, sc2

    # (iv) tools.train in the bf16 mode with packed positions
    root = os.path.join(SCRATCH, "modes")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    sparse, image_dir, _ = write_colmap_scene(
        root, params, TRAINLOOP_VIEWS, WIDTH, HEIGHT,
        cfg.replace(pair_capacity=TRAINLOOP_PAIR_CAPACITY))
    metrics_path = os.path.join(root, "metrics.jsonl")
    _reset_launches()
    t0 = time.time()
    _cli(["--colmap", sparse, "--images", image_dir, "--output", os.path.join(root, "out.ply"),
          "--device", DEVICE, "--pair-capacity", str(TRAINLOOP_PAIR_CAPACITY),
          "--eval-split", "4", "--epochs", str(MODES_CLI_EPOCHS), "--metrics", metrics_path,
          "--payload-dtype", "bf16", "--pack-positions", "1"], os.path.join(root, "cli.log"))
    torch.cuda.synchronize()
    seconds = time.time() - t0
    paths["modes_cli"] = _packed_launches("tools.train --payload-dtype bf16", True)
    steps = [x for x in _read_jsonl(metrics_path) if x["event"] == "step"]
    if not steps or not all(np.isfinite(x["loss"]) and not x["overflow"] for x in steps):
        raise AssertionError(f"tools.train in the bf16 mode: {steps}")
    res["cli"] = {"iters": len(steps), "seconds": seconds,
                  "psnr": [steps[0]["psnr"], steps[-1]["psnr"]]}
    log(f"[modes] tools.train --payload-dtype bf16 --pack-positions 1: {len(steps)} "
        f"iterations in {seconds:.1f} s, PSNR {steps[0]['psnr']:.2f} -> "
        f"{steps[-1]['psnr']:.2f}; launches {paths['modes_cli']}")
    shutil.rmtree(root)
    res["launches"] = paths
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
    par = phase_parallel(params, camera, cfg, gt, smi)
    md = phase_modes(params, camera, cfg, gt, smi)
    del params, camera, gt
    torch.cuda.empty_cache()
    gd = phase_garden(smi)
    tools = phase_tools(work, smi)
    paths = dict(gd["launches"], tools=tools["launches"], **md["launches"])

    src = "gaussiansplatting_tpu_torch/csrc/"
    tpu = "gaussiansplatting_tpu/ops/pallas_blend.py:"

    def entry(name, source, replaces, design, by_path, per, res):
        by_path.update({k: v[name] for k, v in par["launches"].items()})
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "design": design,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "launches_per_step": per, **res, "library_ms": None}

    log(json.dumps({"kernels": [
        entry("windowed_blend_fwd", "blend_fwd.cu", f"{tpu}601, {tpu}161", "hopper",
              {"render": render_launches, "train": train_fwd,
               "tfloor": tf_launches["windowed_blend_fwd"],
               "trainloop": tl["launches"]["windowed_blend_fwd"],
               **{k: v["windowed_blend_fwd"] for k, v in paths.items()}},
              per_step["windowed_blend_fwd"],
              {k: fwd[k] for k in ("max_abs_err", "ms", "ms_v1", "plain_ms", "bound_ms",
                                   "bound_by", "power_tests", "kept_pairs",
                                   "culled_share")}),
        entry("windowed_blend_bwd", "blend_bwd.cu", f"{tpu}671, {tpu}188", "hopper",
              {"train": train_bwd, "tfloor": tf_launches["windowed_blend_bwd"],
               "trainloop": tl["launches"]["windowed_blend_bwd"],
               **{k: v["windowed_blend_bwd"] for k, v in paths.items()}},
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
        *(entry(f"windowed_blend_{k}_packed", f"blend_{k}.cu",
                f"{tpu}{line} (packed branch)", "hopper",
                {p: v[f"windowed_blend_{k}_packed"] for p, v in paths.items()},
                md["per_step"][f"windowed_blend_{k}_packed"],
                {**md[k]["bf16"], "ms_pack_pos": md[k]["pack_pos"]["ms"],
                 "ms_f32_pack_pos": md[k]["pack_pos"]["ms_f32"],
                 "bound_ms_pack_pos": md[k]["pack_pos"]["bound_ms"],
                 "max_abs_err": max(md[k]["bf16"]["max_abs_err"],
                                    md[k]["pack_pos"]["max_abs_err"])})
          for k, line in (("fwd", 601), ("bwd", 671))),
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
        "density_card_vs_cpu_max_abs_err": tl["density_err"],
        "dataset_ms_per_view": gd["dataset"]["render_ms_per_view"],
        "dataset_png_s": gd["dataset"]["png_s"],
        "dataset_views_s": gd["dataset"]["views_s"],
        "dataset_points_s": gd["dataset"]["points_s"],
        "dataset_total_s": gd["dataset"]["total_s"],
        "scene_card_vs_cpu_max_abs_err": gd["scene_err"],
        "garden_iters_per_s": gd["iters_per_s"],
        "garden_peak_pairs": gd["peak_pairs"],
        "garden_overflow_steps": gd["overflow_steps"],
        "garden_rebuckets": gd["rebuckets"],
        "garden_final_alive": gd["final_alive"],
        "garden_heldout_psnr": gd["heldout_psnr"],
        "garden_step_device_ms": gd["step_device_ms"],
        "facade_heldout_psnr": gd["facade_psnr"],
        "viewer_frame_ms_p50": gd["frame_ms_p50"],
        "viewer_frame_ms_p90": gd["frame_ms_p90"],
        "entry_max_abs_err": gd["entry_err"],
        "profile_stage_ms": tools["stages_ms"],
        "trace_device_ms_per_step": tools["device_ms"],
        "trace_host_ms_per_step": tools["host_ms"],
        "trace_idle_share": tools["idle"],
        "sol_floor_ms": tools["floor_ms"],
        "sol_bytes_total": tools["sol"]["bytes_total"],
        "sol_instructions": tools["sol"]["instructions"],
        "strip_max_abs_err_vs_full": par["strip_err"],
        "strip_kernel_max_abs_err_by_row0": par["strip_kernel_err"],
        "batched_step_ms": par["batched_ms"],
        "batched_views_per_s": par["batched_views_per_s"],
        "batched_k2_moments_differ": par["k2_moments_differ"],
        "sharded_by_ranks": par["sharded"],
        "parallel_cli": par["cli"],
        "bench_scaling": par["scaling"],
        "bf16_render_max_mean_vs_f32": md["render"],
        "bf16_grad_rel_vs_f32": md["grad_rel"],
        "bf16_train_step_ms": md["step_ms"],
        "bf16_train_step_device_ms": md["step_device_ms"],
        "scatter_rel_norm_vs_f64": md["scatter_rel_norm"],
        "scatter_ms": md["scatter_ms"], "scatter_packed_ms": md["scatter_packed_ms"],
        "sortprefix_ms": md["sortprefix_ms"],
        "bf16_cli": md["cli"]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
