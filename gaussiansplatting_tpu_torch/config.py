"""Central configuration for the TPU-native 3D Gaussian Splatting framework.

Every compile-time constant scattered through the reference implementation is
collected here as one dataclass (the reference spreads them over
mtl_engine.mm:1053-1068, density_control.mm:21-38, tiled_rasterizer.hpp:78-80,
tiled_shaders.metal:83-87,742-743).  These constants are the reproducibility
surface of the reference; defaults match it exactly.
"""

from __future__ import annotations

import dataclasses
import json


class _Replaceable:
    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass(frozen=True)
class RasterConfig(_Replaceable):
    """Rasterizer kernel constants (reference: tiled_shaders.metal:83-87,742-743)."""

    tile_size: int = 16            # TILE_SIZE (tiled_rasterizer.hpp:78)
    max_radius: float = 512.0      # MAX_RADIUS (tiled_shaders.metal:85)
    max_log_scale: float = 5.0     # MAX_SCALE log-space clamp (tiled_shaders.metal:87)
    ndc_cull: float = 1.2          # frustum cull |ndc| > 1.2 (tiled_shaders.metal:144)
    z_cull: float = 0.1            # clipPos.w/viewPos.z <= 0.1 cull (tiled_shaders.metal:135)
    lowpass: float = 0.3           # 2D covariance diagonal low-pass (tiled_shaders.metal:233-234)
    min_det: float = 1e-4          # 2D covariance determinant floor (tiled_shaders.metal:241)
    aspect_clamp: float = 20.0     # max 3D scale aspect ratio (tiled_shaders.metal:166)
    jacobian_clamp: float = 1.3    # EWA frustum clamp 1.3*f/z (tiled_shaders.metal:198-199)
    power_floor: float = -4.5      # skip power < -4.5 (tiled_shaders.metal:359)
    alpha_cap: float = 0.99        # alpha = min(opacity*G, 0.99) (tiled_shaders.metal:363)
    alpha_floor: float = 1.0 / 255.0   # skip alpha < 1/255 (tiled_shaders.metal:366)
    transmittance_floor: float = 1e-4  # terminate when T <= 1e-4 (tiled_shaders.metal:334)
    # Exact early-termination parity mode: zero every pair whose incoming
    # transmittance is <= transmittance_floor and freeze T for the background
    # composite, exactly like the reference's per-pixel loop exit
    # (tiled_shaders.metal:334 `T > 0.0001h` checked before each pair).  The
    # unmasked prefix transmittance is monotone decreasing, so the mask is
    # exact without iteration; costs a second blend pass (opt-in).
    t_floor_exact: bool = False
    raw_opacity_clamp: float = 8.0     # raw opacity clamp +/-8 (tiled_shaders.metal:293)
    pair_min_opacity: float = 0.005    # GPU_MIN_OPACITY pairgen skip (tiled_shaders.metal:742)
    max_tiles_per_gaussian: int = 256  # GPU_MAX_TILES_PER_GAUSSIAN (tiled_shaders.metal:743)
    white_background: bool = True      # white bg composite (tiled_shaders.metal:377)
    # TPU-design knobs (no reference equivalent)
    pair_block: int = 128          # pairs per render block (MXU K dimension granularity)
    pair_capacity: int = 1 << 20   # MAX padded (tile,depth) pairs per device per frame
    # SH evaluation degree: 0 = reference parity (evalSH uses DC only,
    # shaders.metal:58-61); 1 = view-dependent band-1 color, trainable;
    # 2, 3 = Kerbl et al. 2023's bands 2 and 3 (a [C, 16, 3] row at 3), which
    # the training loop ramps in one degree per 1,000 iterations
    # (train/schedule.sh_degree_at).
    sh_degree: int = 0
    # Block-blend implementation: "auto" = Pallas kernels on TPU, XLA
    # elsewhere; "pallas" forces the kernels (interpret mode off-TPU);
    # "xla" forces the checkpointed-scan fallback.
    blend_impl: str = "auto"
    # Per-Gaussian gradient reduction (ops/pairs._pair_rows_bwd):
    # "sortprefix" = sort cotangents by Gaussian id, then prefix-sum
    # differences over the contiguous runs (~9 ms at 2M pairs on v5e);
    # "scatter" = one fused duplicate-index scatter-add (~30 ms, kept as the
    # numerically boring fallback).  Both are deterministic, unlike the
    # reference's relaxed float atomics.
    grad_reduce: str = "sortprefix"
    # Sort payload precision (windowed Pallas path only): "f32" carries all
    # render data / cotangents as one f32 sort operand each; "bf16" packs
    # them two-per-i32 (ops/packing.py), cutting the fat pair sort 11 -> 8
    # operands and the backward by-gid sort 10 -> 6 at bf16 precision for
    # conic/opacity/color and gradients (screen positions stay f32).  The
    # reference blends in HALF precision (tiled_shaders.metal:326-328), so
    # bf16 render data is inside its numerical envelope.
    payload_dtype: str = "f32"
    # With payload_dtype="bf16", additionally pack TILE-RELATIVE screen
    # positions as one bf16 pair computed at expansion time (docs/DESIGN.md
    # roadmap #5): mx = sx - tile_center is bounded by the splat radius, so
    # bf16's 2^-8 relative error stays sub-pixel and the worst-case power
    # error (~r^2/sigma^2 * 2^-8 ~ 0.035) is inside the bf16 blend
    # envelope.  Drops the fat (tile, depth) sort by one payload operand
    # (~1 ms at 2M pairs, ~6 ms at 16M) and removes the in-kernel tile-
    # center subtraction.  WINDOWED Pallas path only (blend_impl "pallas",
    # or "auto" on TPU, with t_floor_exact=False); ignored elsewhere, and
    # no effect unless payload_dtype="bf16".
    pack_positions: bool = False
    # Which Gaussians lose their pairs when the frame exceeds pair_capacity:
    # "index" reproduces the reference's write-cursor bounds check
    # (tiled_shaders.metal:779-780) as a deterministic emission-order prefix;
    # "impact" keeps the highest opacity x tiles-covered set instead, so a
    # capped capacity under CHRONIC overflow sheds the least visible content
    # (see ops/pairs.capacity_plan).
    overflow_drop: str = "index"
    # Scales the expansion chunk-padding allowance (ops/pairs._chunk_capacity):
    # 1.0 provisions the worst case (one wasted chunk per live Gaussian);
    # 0.5 matches typical waste and cuts the fat-sort rows ~20% at reference
    # scale.  Undersizing only trips the chunk-cap overflow path (whole-
    # Gaussian drop + adaptive growth) — never memory unsafety.
    chunk_slack: float = 1.0
    # The primitive the frame renders: "gaussian", the 3D Gaussian of Kerbl
    # et al. 2023 (the JAX package's only one); "surfel", the 2D Gaussian
    # disc of Huang et al. 2024 (arXiv:2403.17888) with two log-scales a
    # row, rendered by ray-splat intersection (ops/surfel_*.py), on the
    # float32 windowed path only.  Port-only: left out of to_json at its
    # default.
    primitive: str = "gaussian"


@dataclasses.dataclass(frozen=True)
class OptimConfig(_Replaceable):
    """Optimizer + LR schedule (reference: mtl_engine.mm:1053-1068, optimizer.mm:276-283,
    shaders.metal:536-713)."""

    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    scale_lr: float = 5e-3
    rotation_lr: float = 1e-3
    opacity_lr: float = 0.025
    sh_lr: float = 2.5e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 0.5           # per-element gradient clip (shaders.metal:585)
    position_update_norm_clip: float = 0.1  # update magnitude limit (shaders.metal:615-618)
    log_scale_clamp: float = 4.0     # MAX_SCALE_TRAIN (shaders.metal adamStep scale clamp)
    raw_opacity_clamp: float = 8.0   # opacity param clamp (shaders.metal:693)
    sh_clamp: float = 2.0            # SH coefficient clamp (shaders.metal:709-711)
    # learning rate of the SH bands above the DC (None: sh_lr); Kerbl et
    # al. 2023 train them at sh_lr / 20.  Left out of to_json while None, so
    # the JSON stays the JAX package's.
    sh_rest_lr: float | None = None


@dataclasses.dataclass(frozen=True)
class DensityConfig(_Replaceable):
    """Densify / prune / split control (reference: density_control.mm:21-38,229-307,
    mtl_engine.mm:1053-1056)."""

    grad_threshold: float = 2e-4       # GRAD_THRESHOLD
    opacity_prune_threshold: float = 0.005  # OPACITY_PRUNE_THRESHOLD
    percent_dense: float = 0.01        # PERCENT_DENSE (split-vs-clone scale threshold)
    max_gaussians: int = 1_500_000     # MAX_GAUSSIANS hard cap
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_interval: int = 100        # every 100 iters (mtl_engine.mm:1112)
    max_scale_log: float = 4.0         # scale clamp inside density decisions
    opacity_reset_interval: int = 3000
    opacity_reset_value: float = -4.6  # sigmoid^-1(0.01) (mtl_engine.mm:1062)
    world_prune_factor: float = 0.1    # prune maxScale > 0.1*extent after first reset
    screen_prune_pixels: float = 40.0  # approx screen radius prune (density_control.mm:231)
    split_scale_factor: float = 1.6    # children scale /= 1.6 (density_control.mm:425)
    viewspace_grad_clip: float = 1.0   # per-view accumulated grad-mag clamp (density_control.mm:162)


@dataclasses.dataclass(frozen=True)
class LossConfig(_Replaceable):
    """Photometric loss (reference: shaders.metal:320-511, mtl_engine.hpp:147)."""

    lambda_dssim: float = 0.2
    ssim_window: int = 11
    ssim_sigma: float = 1.5
    ssim_c1: float = 0.01 ** 2
    ssim_c2: float = 0.03 ** 2
    # The reference computes D-SSIM for the *scalar* loss only and backpropagates
    # pure L1 (tiled_shaders.metal:417-423).  We differentiate the full combined
    # loss by default; set False for strict reference-gradient parity.
    dssim_in_grad: bool = True
    # 2D Gaussian Splatting's regularizers (Huang et al. 2024, eq. 15),
    # read with RasterConfig.primitive "surfel" only: the weight of the mean
    # depth distortion (alpha; 100 for unbounded scenes) and of the mean
    # normal consistency (beta; 0.05).  Port-only: left out of to_json at
    # their defaults.
    lambda_dist: float = 0.0
    lambda_normal: float = 0.0


@dataclasses.dataclass(frozen=True)
class InitConfig(_Replaceable):
    """Point-cloud initialization (reference: main.mm:59-187, colmap_loader.cpp:232-264)."""

    knn_k: int = 3
    knn_sample_threshold: int = 10_000  # above this, sample 1000 pts and use median
    knn_sample_size: int = 1000
    min_scale_factor: float = 1e-4      # clamp knn scale to [1e-4, 0.1] * extent
    max_scale_factor: float = 0.1
    init_raw_opacity: float = 0.0       # sigmoid(0) = 0.5
    extent_multiplier: float = 1.1      # scene extent = 1.1 * max cam dist from centroid


@dataclasses.dataclass(frozen=True)
class TrainConfig(_Replaceable):
    """Training loop schedule (reference: mtl_engine.mm:1047-1221, main.mm:198-199)."""

    epochs: int = 155
    near: float = 0.1    # projection near plane (mtl_engine.mm:914)
    far: float = 1000.0  # projection far plane (mtl_engine.mm:914)
    snapshot_interval: int = 500   # PPM debug snapshot cadence (mtl_engine.mm:976)
    log_interval: int = 20
    checkpoint_interval: int = 0   # 0 = only at end (reference has no mid-train ckpt)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class Config:
    raster: RasterConfig = dataclasses.field(default_factory=RasterConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    density: DensityConfig = dataclasses.field(default_factory=DensityConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    init: InitConfig = dataclasses.field(default_factory=InitConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        for (group, name), default in PORT_ONLY.items():
            if d[group][name] == default:
                del d[group][name]
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(text: str) -> "Config":
        raw = json.loads(text)
        return Config(
            raster=RasterConfig(**raw.get("raster", {})),
            optim=OptimConfig(**raw.get("optim", {})),
            density=DensityConfig(**raw.get("density", {})),
            loss=LossConfig(**raw.get("loss", {})),
            init=InitConfig(**raw.get("init", {})),
            train=TrainConfig(**raw.get("train", {})),
        )

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


# The fields the JAX package's Config lacks, by (group, name), at their
# defaults: to_json leaves each out while it holds its default, so the JSON
# of a Config the JAX package could hold is the JAX package's.
PORT_ONLY = {("optim", "sh_rest_lr"): None, ("raster", "primitive"): "gaussian",
             ("loss", "lambda_dist"): 0.0, ("loss", "lambda_normal"): 0.0}

DEFAULT_CONFIG = Config()
