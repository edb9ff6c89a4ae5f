"""Adam with the reference's exact clip/clamp set (the reference's
per-thread adamStep kernel, shaders.metal:536-713, driven by
optimizer.mm:241-296).

Counterpart of gaussiansplatting_tpu/train/optimizer.py, as a plain function
on tensors rather than ``torch.optim.Adam``, whose update has none of these
clips.  Per-field semantics:
  * all gradients element-clipped to +/-0.5 before the moment update;
  * positions: update-vector norm limited to 0.1, result sanity-checked
    (finite, |x| < 1e6) or the position is left unchanged;
  * log-scales: result clamped to +/-4 (MAX_SCALE_TRAIN, shaders.metal:55);
  * rotations: renormalized after the step (identity fallback);
  * raw opacity: clamped to +/-8;
  * SH: clamped to +/-2;
  * a Gaussian is skipped entirely when its position/opacity/sh gradients are
    NaN/Inf or its position is corrupt (shaders.metal:567-576);
  * dead (padding) Gaussians are frozen so their m/v stay zero.

``step`` is functional, like the JAX one: it returns new parameters and a new
state and leaves its inputs as they were.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from gaussiansplatting_tpu_torch.config import OptimConfig
from gaussiansplatting_tpu_torch.core.gaussians import GaussianParams


@dataclasses.dataclass
class AdamState:
    m: dict   # field name -> first-moment tensor, same shapes as params
    v: dict   # field name -> second-moment tensor
    t: int    # timestep, incremented per step (optimizer.mm:251)


TRAINABLE = ("means", "log_scales", "quats", "raw_opacities", "sh")


def init_state(params: GaussianParams) -> AdamState:
    return AdamState(
        m={f: torch.zeros_like(getattr(params, f).detach()) for f in TRAINABLE},
        v={f: torch.zeros_like(getattr(params, f).detach()) for f in TRAINABLE},
        t=0,
    )


class LearningRates(NamedTuple):
    """Per-group learning rates, float32 values as Python floats."""
    position: float
    scale: float
    rotation: float
    opacity: float
    sh: float


def _bc(beta: float, t: int) -> float:
    """Bias correction 1 - beta^t in float32, as the JAX step computes it."""
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(t))


@torch.no_grad()
def step(
    params: GaussianParams,
    grads: dict,
    state: AdamState,
    lrs: LearningRates,
    cfg: OptimConfig,
) -> tuple[GaussianParams, AdamState]:
    t = state.t + 1
    bc1 = _bc(cfg.beta1, t)
    bc2 = _bc(cfg.beta2, t)
    p = {f: getattr(params, f).detach() for f in TRAINABLE}

    # per-Gaussian skip mask (shaders.metal:567-576): invalid grads or a
    # corrupt position freeze the whole Gaussian for this step
    bad = (
        ~torch.isfinite(grads["means"]).all(-1)
        | ~torch.isfinite(grads["raw_opacities"])
        | ~torch.isfinite(grads["sh"]).flatten(1).all(-1)
        | ~torch.isfinite(p["means"]).all(-1)
        | (p["means"].abs() > 1e6).any(-1)
    )
    active = params.alive & ~bad  # [C]

    def moments(field):
        g = torch.clamp(grads[field], -cfg.grad_clip, cfg.grad_clip)
        m = cfg.beta1 * state.m[field] + (1.0 - cfg.beta1) * g
        v = cfg.beta2 * state.v[field] + (1.0 - cfg.beta2) * g * g
        return m, v, (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)

    def mask(x):
        return active.reshape(active.shape + (1,) * (x.ndim - 1))

    new_m, new_v, new_p = {}, {}, {}

    # --- positions
    new_m["means"], new_v["means"], d = moments("means")
    upd = lrs.position * d
    norm = torch.linalg.norm(upd, dim=-1, keepdim=True)
    clip = cfg.position_update_norm_clip
    upd = upd * torch.where(norm > clip, clip / torch.clamp(norm, min=1e-20), 1.0)
    new_pos = p["means"] - upd
    pos_ok = torch.isfinite(new_pos).all(-1, keepdim=True) & (
        new_pos.abs().amax(-1, keepdim=True) < 1e6
    )
    new_p["means"] = torch.where(mask(new_pos) & pos_ok, new_pos, p["means"])

    # --- log scales
    new_m["log_scales"], new_v["log_scales"], d = moments("log_scales")
    new_scale = torch.clamp(p["log_scales"] - lrs.scale * d,
                            -cfg.log_scale_clamp, cfg.log_scale_clamp)
    new_p["log_scales"] = torch.where(mask(new_scale), new_scale, p["log_scales"])

    # --- rotations (renormalize, identity fallback; shaders.metal:676-681)
    new_m["quats"], new_v["quats"], d = moments("quats")
    new_q = p["quats"] - lrs.rotation * d
    qn = torch.linalg.norm(new_q, dim=-1, keepdim=True)
    identity = torch.zeros_like(new_q)
    identity[:, 0] = 1.0
    new_q = torch.where(qn > 1e-3, new_q / torch.clamp(qn, min=1e-3), identity)
    new_p["quats"] = torch.where(mask(new_q), new_q, p["quats"])

    # --- raw opacity
    new_m["raw_opacities"], new_v["raw_opacities"], d = moments("raw_opacities")
    new_op = torch.clamp(p["raw_opacities"] - lrs.opacity * d,
                         -cfg.raw_opacity_clamp, cfg.raw_opacity_clamp)
    new_p["raw_opacities"] = torch.where(active, new_op, p["raw_opacities"])

    # --- SH
    new_m["sh"], new_v["sh"], d = moments("sh")
    new_sh = torch.clamp(p["sh"] - lrs.sh * d, -cfg.sh_clamp, cfg.sh_clamp)
    new_p["sh"] = torch.where(mask(new_sh), new_sh, p["sh"])

    # freeze moments of inactive Gaussians (keeps padding state exactly zero)
    for f in TRAINABLE:
        new_m[f] = torch.where(mask(new_m[f]), new_m[f], state.m[f])
        new_v[f] = torch.where(mask(new_v[f]), new_v[f], state.v[f])

    return (
        GaussianParams(**new_p, alive=params.alive),
        AdamState(m=new_m, v=new_v, t=t),
    )


def reset_opacity_and_scale_momentum(state: AdamState) -> AdamState:
    """Zero opacity and scale m/v at opacity resets
    (optimizer.mm:137-147, called from mtl_engine.mm:1188-1189)."""
    m = dict(state.m)
    v = dict(state.v)
    for f in ("raw_opacities", "log_scales"):
        m[f] = torch.zeros_like(m[f])
        v[f] = torch.zeros_like(v[f])
    return dataclasses.replace(state, m=m, v=v)
