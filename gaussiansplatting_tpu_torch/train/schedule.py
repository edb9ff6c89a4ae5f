"""Learning-rate schedule (reference: exponentialLRDecay,
mtl_engine.mm:1039-1045).  Counterpart of
gaussiansplatting_tpu/train/schedule.py, evaluated on the host in float32 as
the JAX package evaluates it on the device.

Two values of a step change with the iteration: the position LR and Adam's
bias corrections.  ``step_scalars`` tabulates them for K steps; the train
step reads its row as a device tensor (train/trainer.py), so a captured
step (train/graph.py) reads each replay's values from its buffer instead
of the numbers it was captured with."""

from __future__ import annotations

import numpy as np

from gaussiansplatting_tpu_torch.config import OptimConfig
from gaussiansplatting_tpu_torch.train.optimizer import LearningRates, _bc


def exponential_lr_decay(lr_init: float, lr_final: float, current_iter: int,
                         max_iter: int) -> float:
    """lr_init * (lr_final/lr_init)^(t/T), clamped to lr_final at t >= T."""
    if current_iter >= max_iter:
        return float(np.float32(lr_final))
    t = np.float32(current_iter) / max(np.float32(max_iter), np.float32(1.0))
    return float(np.float32(lr_init) * np.float32(lr_final / lr_init) ** t)


def learning_rates(cfg: OptimConfig, current_iter: int,
                   total_iters: int) -> LearningRates:
    """Only the position LR decays; the rest are constant
    (mtl_engine.mm:1059-1068, 1092-1094)."""
    return rates(cfg, exponential_lr_decay(
        cfg.position_lr_init, cfg.position_lr_final, current_iter, total_iters))


def rates(cfg: OptimConfig, position) -> LearningRates:
    """The learning rates with ``position`` (a float or a 0-d tensor) as
    the position LR and the constant ones of ``cfg``."""
    return LearningRates(
        position=position,
        scale=float(np.float32(cfg.scale_lr)),
        rotation=float(np.float32(cfg.rotation_lr)),
        opacity=float(np.float32(cfg.opacity_lr)),
        sh=float(np.float32(cfg.sh_lr)),
    )


SH_DEGREE_INTERVAL = 1000


def sh_degree_at(sh_degree: int, iteration: int) -> int:
    """The SH degree the step at ``iteration`` (completed steps, the Adam
    timestep before it) renders at, for a configured ``sh_degree``: one
    degree more every SH_DEGREE_INTERVAL iterations up to it, Kerbl et al.
    2023's oneupSHdegree (which counts from 1, so it raises the degree one
    step earlier); degrees 0 and 1 have no ramp, as in the JAX package."""
    if sh_degree <= 1:
        return sh_degree
    return min(sh_degree, int(iteration) // SH_DEGREE_INTERVAL)


def step_scalars(cfg: OptimConfig, t0: int, k: int, total_iters: int) -> np.ndarray:
    """[k, 3] float32, one row per step of the k that start at Adam
    timesteps t = t0 .. t0 + k - 1: the position LR at the pre-increment t
    (learning_rates) and the bias corrections 1 - beta1^(t+1), 1 -
    beta2^(t+1) (optimizer._bc), each bit for bit the float the scalar
    forms give."""
    out = np.empty((k, 3), np.float32)
    for i in range(k):
        t = t0 + i
        out[i] = (exponential_lr_decay(cfg.position_lr_init, cfg.position_lr_final, t,
                                       total_iters),
                  _bc(cfg.beta1, t + 1), _bc(cfg.beta2, t + 1))
    return out


# 2D Gaussian Splatting's regularizer schedule (its training script): the
# depth distortion from iteration 3,000 on, the normal consistency from
# 7,000
DIST_FROM, NORMAL_FROM = 3000, 7000


def regularizers_at(loss_cfg, iteration: int):
    """The LossConfig the step at ``iteration`` (completed steps) trains
    with: 2DGS's ``lambda_dist if iteration > 3000`` and ``lambda_normal if
    iteration > 7000`` of its 1-based count, i.e. from iteration 3,000 and
    7,000 of this one on; zero before."""
    return loss_cfg.replace(
        lambda_dist=loss_cfg.lambda_dist if iteration >= DIST_FROM else 0.0,
        lambda_normal=loss_cfg.lambda_normal if iteration >= NORMAL_FROM else 0.0)
