"""Densify / prune / split density control: the per-view accumulation the
train step runs and the density event, a masked compaction of the padded
arrays.

Counterpart of gaussiansplatting_tpu/density/control.py.  The reference
rebuilds its buffers on the CPU (density_control.mm:188-500); here, as in
the JAX package, the population lives in fixed-capacity arrays and the
rebuild is a scatter to cumsum-derived destinations: the same interleaved
output order (keep / clone pair / split pair), the same thresholds, the same
integer machinery.  Adam m/v ride the permutation (the JAX package's
deliberate divergence from the reference, control.py:9-14): survivors keep
their moments, clone copies and split children start from zero.

The randomness of a split is an argument: ``apply`` takes the [C, 3]
uniform(-1, 1) draw ``r``, which ``draw_split_offsets`` makes on the state's
CPU generator, so a card and the CPU split with the same offsets.  The
iteration is an int or, as in JAX where it is a traced value
(control.py:113, 121-124), a 0-d integer tensor: the decisions are tensor
ops on it, so an event captured as a CUDA graph (train/graph.py) reads it
from its buffer; the booleans are the same either way.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from gaussiansplatting_tpu_torch.config import DensityConfig
from gaussiansplatting_tpu_torch.core.gaussians import GaussianParams
from gaussiansplatting_tpu_torch.core.transforms import (
    normalize_quat, quat_to_rotmat, sigmoid,
)
from gaussiansplatting_tpu_torch.train.optimizer import TRAINABLE, AdamState


@dataclasses.dataclass
class DensityAccum:
    """Per-Gaussian view-space gradient statistics
    (density_control.mm:121-185)."""

    grad_accum: torch.Tensor      # [C] sum of clamped ||dL/dscreen|| per view
    grad_count: torch.Tensor      # [C] int32 contributing views
    pos_grad_accum: torch.Tensor  # [C, 3] summed position gradients


def init_accum(capacity: int, device=None) -> DensityAccum:
    return DensityAccum(
        grad_accum=torch.zeros((capacity,), dtype=torch.float32, device=device),
        grad_count=torch.zeros((capacity,), dtype=torch.int32, device=device),
        pos_grad_accum=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
    )


@torch.no_grad()
def accumulate(
    accum: DensityAccum,
    vs_grad: torch.Tensor,   # [C, 2] this view's screen-space gradient
    pos_grad: torch.Tensor,  # [C, 3] this view's position gradient
    cfg: DensityConfig,
) -> DensityAccum:
    mag = torch.clamp(torch.linalg.norm(vs_grad, dim=-1), max=cfg.viewspace_grad_clip)
    contrib = torch.isfinite(mag) & (mag > 0.0)
    return DensityAccum(
        grad_accum=accum.grad_accum + torch.where(contrib, mag, 0.0),
        grad_count=accum.grad_count + contrib.to(torch.int32),
        pos_grad_accum=accum.pos_grad_accum
        + torch.where(contrib[:, None], pos_grad, 0.0),
    )


class DensityStats(NamedTuple):
    pruned: torch.Tensor   # 0-dim int32 tensors
    cloned: torch.Tensor
    split: torch.Tensor
    count: torch.Tensor


class DensityPlan(NamedTuple):
    """The integer half of a density event: the decisions after the
    capacity clamp, where each source row lands (slot C = dropped) and the
    counts."""

    prune: torch.Tensor          # [C] bool
    clone: torch.Tensor          # [C] bool
    split: torch.Tensor          # [C] bool
    primary_dst: torch.Tensor    # [C] int64, C where the row is not kept
    secondary_dst: torch.Tensor  # [C] int64, C where the row has no copy
    stats: DensityStats


def _max_scale(log_scales, max_scale_log):
    return torch.exp(torch.clamp(log_scales, -max_scale_log, max_scale_log)).amax(-1)


def _approx_screen_radius_px(log_scales, focal, avg_depth, max_scale_log):
    """focal * maxScale * 3 / depth in pixels (density_control.mm:56-76).
    The depth is a 0-d tensor made by a fill (a captured event copies
    nothing from the host)."""
    max_scale = _max_scale(log_scales, max_scale_log)
    depth = torch.clamp(torch.full((), avg_depth, dtype=torch.float32,
                                   device=log_scales.device), min=0.1)
    return focal * max_scale * 3.0 / depth


def _sum32(mask):
    return mask.sum(dtype=torch.int32)


def _cumsum32(x):
    return torch.cumsum(x.to(torch.int32), 0, dtype=torch.int32)


def draw_split_offsets(generator: torch.Generator, capacity: int, device) -> torch.Tensor:
    """The [C, 3] uniform(-1, 1) draw of one density event, made on the CPU
    generator and copied to ``device``: every device splits with the same
    offsets (a copy of at most 18 MB at the 1.5M cap, once per event; to a
    CUDA device from pinned memory, without waiting for the device)."""
    cuda = torch.device(device).type == "cuda"
    r = torch.empty((capacity, 3), dtype=torch.float32, pin_memory=cuda)
    return r.uniform_(-1.0, 1.0, generator=generator).to(device, non_blocking=cuda)


@torch.no_grad()
def decide(
    params: GaussianParams,
    accum: DensityAccum,
    iteration: int | torch.Tensor,
    scene_extent: float,
    focal: torch.Tensor,
    avg_depth: float,
    cfg: DensityConfig,
) -> DensityPlan:
    """Decisions, capacity clamp and destinations of one density event
    (JAX control.py:95-175).  ``iteration``: an int, or a 0-d integer
    tensor on the parameters' device."""
    C = params.capacity
    alive = params.alive
    opacity = sigmoid(params.raw_opacities.detach())
    log_scales = params.log_scales.detach()
    avg_grad = torch.where(
        accum.grad_count > 0,
        accum.grad_accum / torch.clamp(accum.grad_count, min=1).to(torch.float32),
        0.0,
    )
    max_scale = _max_scale(log_scales, cfg.max_scale_log)

    # ---- decisions (density_control.mm:262-348) ----
    # the iteration's tests are tensor ops where it is a tensor (a bool or
    # a 0-d bool tensor), as JAX's are, never a branch on the host
    prune = opacity < cfg.opacity_prune_threshold
    screen_pruning = iteration > cfg.opacity_reset_interval
    world_prune = max_scale > cfg.world_prune_factor * scene_extent
    screen_px = _approx_screen_radius_px(log_scales, focal, avg_depth, cfg.max_scale_log)
    prune = prune | (screen_pruning & (world_prune | (screen_px > cfg.screen_prune_pixels)))
    prune = prune & alive

    can_densify = (iteration > cfg.densify_from_iter) & (iteration < cfg.densify_until_iter)
    wants = alive & ~prune & (avg_grad > cfg.grad_threshold) & can_densify
    split = wants & (max_scale > cfg.percent_dense * scene_extent)
    clone = wants & ~split

    # ---- capacity clamp: drop clones first, then splits, lowest index first
    #      (density_control.mm:358-382); also respect the array capacity ----
    n_alive = _sum32(alive)
    hard_cap = min(cfg.max_gaussians, C)
    n_pruned = _sum32(prune)
    n_clone = _sum32(clone)
    n_split = _sum32(split)
    excess = torch.clamp(n_alive - n_pruned + n_clone + n_split - hard_cap, min=0)

    drop_clones = torch.minimum(excess, n_clone)
    clone = clone & (_cumsum32(clone) - 1 >= drop_clones)   # rank among clones
    excess = excess - drop_clones
    drop_splits = torch.minimum(excess, n_split)
    split = split & (_cumsum32(split) - 1 >= drop_splits)
    n_clone = _sum32(clone)
    n_split = _sum32(split)
    new_count = n_alive - n_pruned + n_clone + n_split

    # ---- destinations of the interleaved compaction: a kept row at its
    #      offset, a clone copy or second split child right after it ----
    keep = alive & ~prune & ~clone & ~split
    out_size = keep.to(torch.int32) + 2 * clone.to(torch.int32) + 2 * split.to(torch.int32)
    out_off = _cumsum32(out_size) - out_size
    primary_dst = torch.where(out_size > 0, out_off, C).to(torch.int64)
    secondary_dst = torch.where(out_size == 2, out_off + 1, C).to(torch.int64)
    stats = DensityStats(pruned=n_pruned, cloned=n_clone, split=n_split, count=new_count)
    return DensityPlan(prune, clone, split, primary_dst, secondary_dst, stats)


@torch.no_grad()
def apply(
    params: GaussianParams,
    opt: AdamState,
    accum: DensityAccum,
    iteration: int | torch.Tensor,
    r: torch.Tensor,
    scene_extent: float,
    focal: torch.Tensor,
    avg_depth: float,
    cfg: DensityConfig,
):
    """One density-control event.  Returns (params, opt, accum, stats).

    Thresholds and ordering match DensityController::apply
    (density_control.mm:188-500) with the engine's call-site arguments
    (mtl_engine.mm:1117-1147: avg_depth = 2*extent, focal at texture scale);
    ``r`` is the event's [C, 3] uniform(-1, 1) draw (draw_split_offsets);
    ``iteration`` as decide takes it.  Reads no device value back to the
    host.
    """
    C = params.capacity
    plan = decide(params, accum, iteration, scene_extent, focal, avg_depth, cfg)
    p = {f: getattr(params, f).detach() for f in TRAINABLE}

    # ---- split children geometry (density_control.mm:422-480) ----
    scale_lin = torch.exp(torch.clamp(p["log_scales"], -cfg.max_scale_log, cfg.max_scale_log))
    if scale_lin.shape[1] == 2:
        # a surfel splits in its own plane: the draw's third axis has a
        # zero std (2D Gaussian Splatting's densify_and_split)
        r = r * r.new_tensor([1.0, 1.0, 0.0])
        scale_lin = torch.nn.functional.pad(scale_lin, (0, 1))
    r_norm = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
    r = torch.where(r_norm > 1e-3, r / torch.clamp(r_norm, min=1e-3), r)
    R = quat_to_rotmat(normalize_quat(p["quats"]))
    offset = (R * (r * scale_lin)[:, None, :]).sum(-1)          # R @ (r * s)
    log_factor = float(np.log(np.float32(1.0 / cfg.split_scale_factor)))

    def build(primary, secondary):
        # JAX scatters into C + 1 rows with mode="drop".  Here every row
        # that is not kept goes to slot C, the only slot that receives
        # duplicate indices (on CUDA their writes land in unspecified order),
        # and slot C is cut off.
        buf = primary.new_zeros((C + 1,) + primary.shape[1:])
        buf[plan.primary_dst] = primary
        buf[plan.secondary_dst] = secondary
        return buf[:C]

    split_col = plan.split[:, None]
    means = p["means"]
    new_means = build(torch.where(split_col, means + offset, means),
                      torch.where(split_col, means - offset, means))
    child_scales = p["log_scales"] + log_factor
    scales = torch.where(split_col, child_scales, p["log_scales"])
    new_scales = build(scales, scales)
    new_quats = build(p["quats"], p["quats"])
    new_ops = build(p["raw_opacities"], p["raw_opacities"])
    new_sh = build(p["sh"], p["sh"])

    new_alive = torch.arange(C, device=means.device) < plan.stats.count
    identity_q = torch.zeros_like(new_quats)
    identity_q[:, 0] = 1.0
    new_params = GaussianParams(
        means=new_means,
        log_scales=new_scales,
        quats=torch.where(new_alive[:, None], new_quats, identity_q),
        raw_opacities=new_ops,
        sh=new_sh,
        alive=new_alive,
    )

    # ---- Adam state through the permutation: survivors and clone
    #      originals keep their moments, clone copies and split children
    #      start at zero ----
    new_m, new_v = {}, {}
    for f in TRAINABLE:
        m, v = opt.m[f], opt.v[f]
        fresh = plan.split.reshape((C,) + (1,) * (m.dim() - 1))  # split child 1 is new
        new_m[f] = build(torch.where(fresh, 0.0, m), torch.zeros_like(m))
        new_v[f] = build(torch.where(fresh, 0.0, v), torch.zeros_like(v))
    new_opt = dataclasses.replace(opt, m=new_m, v=new_v)
    return new_params, new_opt, init_accum(C, device=means.device), plan.stats
