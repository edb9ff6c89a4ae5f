"""Full training state: parameters + Adam moments + density-control
accumulators + a random generator.

Counterpart of gaussiansplatting_tpu/train/state.py; a ``torch.Generator``
stands in for the PRNG key (the two give different numbers from one seed).
The generator always lives on the CPU, whatever the parameters' device, so a
state draws the same numbers on every device and its generator state can be
saved on one device and restored on another.  A function that draws clones
the generator first (``clone_generator``) and puts the advanced clone in the
state it returns: the input state never changes, so a step can be replayed.

``state_to_numpy`` / ``state_from_numpy`` carry a state between the packages
as host arrays keyed like the JAX checkpoint's leaves (``params/means``,
``opt/m/means``, ``opt/t``, ``accum/grad_count``, ...); the PRNG ``key`` leaf
is not carried (train/checkpoint.py writes it).
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


def make_generator(seed: int) -> torch.Generator:
    """The state's random generator: on the CPU, seeded from ``seed``."""
    return torch.Generator(device="cpu").manual_seed(seed)


def clone_generator(g: torch.Generator) -> torch.Generator:
    """An independent generator at the same point of the stream as ``g``."""
    out = torch.Generator(device=g.device)
    out.set_state(g.get_state())
    return out


def create(params: GaussianParams, seed: int = 0) -> TrainState:
    return TrainState(
        params=params,
        opt=init_state(params),
        accum=init_accum(params.capacity, device=params.means.device),
        generator=make_generator(seed),
    )


@torch.no_grad()
def grow(state: TrainState, new_capacity: int) -> TrainState:
    """Re-pad every per-Gaussian array to ``new_capacity`` slots (JAX
    state.py:43-82, the reference's buffer reallocation on densify,
    density_control.mm:385-490).  New slots are dead: alive=False, identity
    quaternions, zero Adam moments and accumulators."""
    old = state.params.capacity
    if new_capacity <= old:
        return state

    def pad(x):
        return torch.cat([x, x.new_zeros((new_capacity - old,) + x.shape[1:])])

    p = state.params
    new_quats = p.quats.new_zeros((new_capacity - old, 4))
    new_quats[:, 0] = 1.0
    params = GaussianParams(
        means=pad(p.means.detach()),
        log_scales=pad(p.log_scales.detach()),
        quats=torch.cat([p.quats.detach(), new_quats]),
        raw_opacities=pad(p.raw_opacities.detach()),
        sh=pad(p.sh.detach()),
        alive=pad(p.alive),
    )
    opt = dataclasses.replace(
        state.opt,
        m={k: pad(v) for k, v in state.opt.m.items()},
        v={k: pad(v) for k, v in state.opt.v.items()},
    )
    accum = DensityAccum(*(pad(getattr(state.accum, f)) for f in _ACCUM_FIELDS))
    return dataclasses.replace(state, params=params, opt=opt, accum=accum)


def leaf_keys() -> list[str]:
    """The keys ``state_to_numpy`` writes (the JAX TrainState's leaf paths
    but ``key``)."""
    return ([f"params/{f}" for f in gaussians_mod.FIELDS]
            + [f"opt/{mom}/{f}" for mom in ("m", "v") for f in TRAINABLE]
            + ["opt/t"] + [f"accum/{f}" for f in _ACCUM_FIELDS])


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
    return TrainState(params, opt, accum, make_generator(seed))
