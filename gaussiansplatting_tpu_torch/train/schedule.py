"""Learning-rate schedule (reference: exponentialLRDecay,
mtl_engine.mm:1039-1045).  Counterpart of
gaussiansplatting_tpu/train/schedule.py, evaluated on the host in float32 as
the JAX package evaluates it on the device."""

from __future__ import annotations

import numpy as np

from gaussiansplatting_tpu_torch.config import OptimConfig
from gaussiansplatting_tpu_torch.train.optimizer import LearningRates


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
    return LearningRates(
        position=exponential_lr_decay(
            cfg.position_lr_init, cfg.position_lr_final, current_iter, total_iters
        ),
        scale=float(np.float32(cfg.scale_lr)),
        rotation=float(np.float32(cfg.rotation_lr)),
        opacity=float(np.float32(cfg.opacity_lr)),
        sh=float(np.float32(cfg.sh_lr)),
    )
