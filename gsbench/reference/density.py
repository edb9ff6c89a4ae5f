"""Plain PyTorch reference of a densify event (the Metal reference's
DensityController::apply, density_control.mm:188-500, with the engine's
call-site arguments, mtl_engine.mm:1117-1147): prune the transparent,
clone the small and split the large Gaussians whose mean view-space gradient
passes the threshold, drop clones then splits (lowest index first) past the
capacity, and lay the survivors out in source order, a clone's copy or a
split's second child right after its first.  A split's children sit at
mean +/- R (r / |r| * scale) with scales divided by 1.6, r the event's
uniform(-1, 1) draw.

It works from the state the event starts from (the trained parameters and
the per-Gaussian gradient statistics); the decisions run in float32 on the
float32 state, the children's geometry in float64.  Nothing here imports the
port.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gsbench.reference.raster import FIELDS, quat_to_rotmat

DENSITY_DEFAULTS = dict(
    grad_threshold=2e-4, opacity_prune_threshold=0.005, percent_dense=0.01,
    max_gaussians=1_500_000, densify_from_iter=500, densify_until_iter=15_000,
    max_scale_log=4.0, opacity_reset_interval=3000, world_prune_factor=0.1,
    screen_prune_pixels=40.0, split_scale_factor=1.6,
)


def density_constants(cfg: dict) -> dict:
    return {k: cfg.get("density", {}).get(k, v) for k, v in DENSITY_DEFAULTS.items()}


class Event(NamedTuple):
    params: dict    # the five fields of the live Gaussians after the event, in order
    counts: dict    # pruned, cloned, split, count


def split_draw(generator_state: torch.Tensor, capacity: int) -> torch.Tensor:
    """The event's [C, 3] uniform(-1, 1) draw from a CPU generator at
    ``generator_state``."""
    g = torch.Generator()
    g.set_state(generator_state)
    return torch.empty((capacity, 3)).uniform_(-1.0, 1.0, generator=g)


def densify(p: dict, grad_accum: torch.Tensor, grad_count: torch.Tensor, iteration: int,
            extent: float, focal: float, r: torch.Tensor, dc: dict) -> Event:
    """The event on parameters ``p`` (five fields and alive, float32)."""
    f32 = torch.float32
    alive = p["alive"]
    cap = alive.shape[0]
    log_scales = p["log_scales"].to(f32)
    opacity = 1.0 / (1.0 + torch.exp(-p["raw_opacities"].to(f32)))
    avg = torch.where(grad_count > 0, grad_accum / grad_count.clamp(min=1).to(f32),
                      torch.zeros_like(grad_accum))
    msl = dc["max_scale_log"]
    max_scale = torch.exp(log_scales.clamp(-msl, msl)).amax(-1)
    prune = opacity < dc["opacity_prune_threshold"]
    if iteration > dc["opacity_reset_interval"]:
        depth = max(2.0 * extent, 0.1)
        screen = focal * max_scale * 3.0 / depth
        prune = prune | (max_scale > dc["world_prune_factor"] * extent) | (
            screen > dc["screen_prune_pixels"])
    prune = prune & alive
    can = dc["densify_from_iter"] < iteration < dc["densify_until_iter"]
    wants = alive & ~prune & (avg > dc["grad_threshold"]) & can
    split = wants & (max_scale > dc["percent_dense"] * extent)
    clone = wants & ~split
    n_alive, n_pruned = int(alive.sum()), int(prune.sum())
    excess = max(n_alive - n_pruned + int(clone.sum()) + int(split.sum())
                 - min(dc["max_gaussians"], cap), 0)
    for mask in (clone, split):
        drop = min(excess, int(mask.sum()))
        mask &= torch.cumsum(mask.long(), 0) - 1 >= drop
        excess -= drop
    keep = alive & ~prune & ~clone & ~split

    d = {f: p[f].double() for f in FIELDS}
    scale = torch.exp(d["log_scales"].clamp(-msl, msl))
    rr = r.to(d["means"].device).double()
    rn = torch.linalg.vector_norm(rr, dim=-1, keepdim=True)
    rr = torch.where(rn > 1e-3, rr / rn.clamp(min=1e-3), rr)
    q = d["quats"]
    qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    ident = torch.zeros_like(q)
    ident[:, 0] = 1.0
    q = torch.where(qn > 1e-3, q / qn.clamp(min=1e-3), ident)
    offset = (quat_to_rotmat(q) * (rr * scale)[:, None, :]).sum(-1)
    shrink = math.log(1.0 / dc["split_scale_factor"])

    first = {f: d[f].clone() for f in FIELDS}
    second = {f: d[f].clone() for f in FIELDS}
    first["means"] = torch.where(split[:, None], d["means"] + offset, d["means"])
    second["means"] = torch.where(split[:, None], d["means"] - offset, d["means"])
    for x in (first, second):
        x["log_scales"] = torch.where(split[:, None], d["log_scales"] + shrink, d["log_scales"])
    twice = clone | split
    rows = torch.nonzero(keep | twice).squeeze(1)
    reps = 1 + twice[rows].long()
    src = torch.repeat_interleave(rows, reps)
    is_second = torch.zeros_like(src, dtype=torch.bool)
    is_second[1:] = src[1:] == src[:-1]
    out = {f: torch.where(is_second.reshape((-1,) + (1,) * (d[f].dim() - 1)),
                          second[f][src], first[f][src]) for f in FIELDS}
    counts = dict(pruned=n_pruned, cloned=int(clone.sum()), split=int(split.sum()),
                  count=int(src.numel()))
    return Event(out, counts)


def readings(prog_params: dict, prog_counts: dict, ref: Event) -> dict:
    """densify_count_gap: the summed differences of the four counts (an
    exact comparison); densify_gap: the worst leaf's norm of the difference
    of the live Gaussians' fields over the reference leaf's norm (1 where
    the counts differ)."""
    count_gap = sum(abs(int(prog_counts[k]) - ref.counts[k]) for k in ref.counts)
    n = ref.counts["count"]
    if count_gap or prog_params["means"].shape[0] < n:
        return {"densify_count_gap": float(count_gap), "densify_gap": 1.0}
    gap = max(float(torch.linalg.vector_norm(prog_params[f][:n].double() - ref.params[f])
                    / max(float(torch.linalg.vector_norm(ref.params[f])), 1e-30))
              for f in FIELDS)
    return {"densify_count_gap": 0.0, "densify_gap": gap}
