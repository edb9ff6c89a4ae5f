"""Full training state: parameters + Adam moments + density-control
accumulators + a random generator.

Counterpart of gaussiansplatting_tpu/train/state.py; a ``torch.Generator``
stands in for the PRNG key (the two give different numbers from one seed).
``state_to_numpy`` / ``state_from_numpy`` carry a state between the packages
as host arrays keyed like the JAX checkpoint's leaves (``params/means``,
``opt/m/means``, ``opt/t``, ``accum/grad_count``, ...); the PRNG ``key`` leaf
is not carried.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gaussiansplatting_tpu_torch.core import gaussians as gaussians_mod
from gaussiansplatting_tpu_torch.core.gaussians import GaussianParams
from gaussiansplatting_tpu_torch.density.control import DensityAccum, init_accum
from gaussiansplatting_tpu_torch.train.optimizer import (
    TRAINABLE, AdamState, init_state,
)

_ACCUM_FIELDS = ("grad_accum", "grad_count", "pos_grad_accum")


@dataclasses.dataclass
class TrainState:
    params: GaussianParams
    opt: AdamState
    accum: DensityAccum
    generator: torch.Generator

    @property
    def iteration(self) -> int:
        """Completed optimizer steps (== Adam timestep, optimizer.mm:251)."""
        return self.opt.t


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def create(params: GaussianParams, seed: int = 0) -> TrainState:
    return TrainState(
        params=params,
        opt=init_state(params),
        accum=init_accum(params.capacity, device=params.means.device),
        generator=_generator(params.means.device, seed),
    )


def state_to_numpy(state: TrainState) -> dict[str, np.ndarray]:
    """Host arrays of every leaf but the generator."""
    out = {f"params/{f}": getattr(state.params, f).detach().cpu().numpy()
           for f in gaussians_mod.FIELDS}
    for f in TRAINABLE:
        out[f"opt/m/{f}"] = state.opt.m[f].cpu().numpy()
        out[f"opt/v/{f}"] = state.opt.v[f].cpu().numpy()
    out["opt/t"] = np.asarray(state.opt.t, np.int32)
    for f in _ACCUM_FIELDS:
        out[f"accum/{f}"] = getattr(state.accum, f).cpu().numpy()
    return out


def state_from_numpy(d: dict, device=None, seed: int = 0) -> TrainState:
    """TrainState from host arrays keyed as ``state_to_numpy`` writes them
    (and as the JAX TrainState's leaves are named)."""
    def t(key, dtype):
        return torch.from_numpy(np.array(d[key], dtype)).to(device)

    params = gaussians_mod.params_from_numpy(
        {f: d[f"params/{f}"] for f in gaussians_mod.FIELDS}, device
    )
    opt = AdamState(
        m={f: t(f"opt/m/{f}", np.float32) for f in TRAINABLE},
        v={f: t(f"opt/v/{f}", np.float32) for f in TRAINABLE},
        t=int(np.asarray(d["opt/t"])),
    )
    accum = DensityAccum(
        grad_accum=t("accum/grad_accum", np.float32),
        grad_count=t("accum/grad_count", np.int32),
        pos_grad_accum=t("accum/pos_grad_accum", np.float32),
    )
    return TrainState(params, opt, accum, _generator(params.means.device, seed))
