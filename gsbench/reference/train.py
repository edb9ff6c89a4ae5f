"""Plain PyTorch reference of one training step: the frame (reference/
raster.py), the photometric loss (per-pixel L1 and D-SSIM, summed for the
gradient), its gradient by autograd, and Adam with the system's clips and
clamps (the Metal reference's adamStep, shaders.metal:536-713): gradients
clipped to +/-0.5, the position update's norm limited to 0.1, log-scales
clamped to +/-4, rotations renormalised, raw opacity clamped to +/-8, SH to
+/-2, a Gaussian with a non-finite gradient or a corrupt position left as it
is, and the position learning rate decayed exponentially over the run.
Nothing here imports the port.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from gsbench.reference import raster

OPTIM_DEFAULTS = dict(
    position_lr_init=1.6e-4, position_lr_final=1.6e-6, scale_lr=5e-3, rotation_lr=1e-3,
    opacity_lr=0.025, sh_lr=2.5e-3, beta1=0.9, beta2=0.999, eps=1e-8, grad_clip=0.5,
    position_update_norm_clip=0.1, log_scale_clamp=4.0, raw_opacity_clamp=8.0, sh_clamp=2.0,
)
LOSS_DEFAULTS = dict(lambda_dssim=0.2, ssim_window=11, ssim_sigma=1.5, ssim_c1=0.01 ** 2,
                     ssim_c2=0.03 ** 2, dssim_in_grad=True)


def optim_constants(cfg: dict) -> dict:
    return {k: cfg.get("optim", {}).get(k, v) for k, v in OPTIM_DEFAULTS.items()}


def loss_constants(cfg: dict) -> dict:
    return {k: cfg.get("loss", {}).get(k, v) for k, v in LOSS_DEFAULTS.items()}


class LossReport(NamedTuple):
    grad_loss: torch.Tensor      # what is differentiated: the per-pixel sums
    combined_mean: torch.Tensor  # (1 - l) mean L1 + l mean D-SSIM, the logged loss


def _blur(x: torch.Tensor, window: int, sigma: float, prec=None) -> torch.Tensor:
    """Separable Gaussian blur of [K, H, W] planes, replicated edges, the
    1-D kernel normalised to sum 1 (operands rounded to TF32 with
    ``prec`` "tf32")."""
    r = window // 2
    d = torch.arange(-r, r + 1, dtype=x.dtype, device=x.device)
    k = torch.exp(-(d * d) / (2.0 * sigma * sigma))
    k = k / k.sum()
    k = raster.mm_in(k, prec)
    y = F.pad(x[:, None], (r, r, r, r), mode="replicate")
    y = F.conv2d(raster.mm_in(y, prec), k.reshape(1, 1, 1, -1))
    return F.conv2d(raster.mm_in(y, prec), k.reshape(1, 1, -1, 1))[:, 0]


def photometric_loss(img: torch.Tensor, gt: torch.Tensor, lc: dict, prec=None) -> LossReport:
    """L1 (mean over RGB) and D-SSIM (grey = mean RGB, 11 x 11 Gaussian
    window, clamp((1 - SSIM) / 2, 0, 1)) per pixel."""
    l1 = (img - gt).abs().mean(-1)
    x, y = img.mean(-1), gt.mean(-1)
    mu_x, mu_y, e_xx, e_yy, e_xy = _blur(torch.stack([x, y, x * x, y * y, x * y]),
                                        lc["ssim_window"], lc["ssim_sigma"], prec)
    var_x, var_y, cov = e_xx - mu_x * mu_x, e_yy - mu_y * mu_y, e_xy - mu_x * mu_y
    c1, c2 = lc["ssim_c1"], lc["ssim_c2"]
    ssim = ((2 * mu_x * mu_y + c1) * (2 * cov + c2)) / ((mu_x * mu_x + mu_y * mu_y + c1)
                                                        * (var_x + var_y + c2))
    dssim = torch.clamp((1.0 - ssim) / 2.0, 0.0, 1.0)
    lam = lc["lambda_dssim"]
    if lc["dssim_in_grad"]:
        grad_loss = (1.0 - lam) * l1.sum() + lam * dssim.sum()
    else:
        grad_loss = l1.sum()
    return LossReport(grad_loss, (1.0 - lam) * l1.mean() + lam * dssim.mean())


def position_lr(oc: dict, t: int, total_iters: int) -> float:
    if t >= total_iters:
        return oc["position_lr_final"]
    return oc["position_lr_init"] * (oc["position_lr_final"] / oc["position_lr_init"]) ** (
        t / max(total_iters, 1))


class State(NamedTuple):
    params: dict   # the five fields and alive
    m: dict
    v: dict
    t: int
    prec: object   # float64, float32 or "tf32" (raster.real)


def init_state(params: dict, prec=torch.float64) -> State:
    p = {f: params[f].detach().to(raster.real(prec)).clone() for f in raster.FIELDS}
    p["alive"] = params["alive"].clone()
    zeros = {f: torch.zeros_like(p[f]) for f in raster.FIELDS}
    return State(p, zeros, {f: torch.zeros_like(p[f]) for f in raster.FIELDS}, 0, prec)


@torch.no_grad()
def adam(st: State, grads: dict, oc: dict, total_iters: int) -> State:
    """One Adam step with the system's clips and clamps."""
    t = st.t + 1
    bc1, bc2 = 1.0 - oc["beta1"] ** t, 1.0 - oc["beta2"] ** t
    p = st.params
    bad = (~torch.isfinite(grads["means"]).all(-1) | ~torch.isfinite(grads["raw_opacities"])
           | ~torch.isfinite(grads["sh"]).flatten(1).all(-1) | ~torch.isfinite(p["means"]).all(-1)
           | (p["means"].abs() > 1e6).any(-1))
    active = p["alive"] & ~bad
    new_p, new_m, new_v = {"alive": p["alive"]}, {}, {}
    rates = dict(log_scales=oc["scale_lr"], quats=oc["rotation_lr"],
                 raw_opacities=oc["opacity_lr"], sh=oc["sh_lr"])
    for f in raster.FIELDS:
        g = grads[f].clamp(-oc["grad_clip"], oc["grad_clip"])
        m = oc["beta1"] * st.m[f] + (1.0 - oc["beta1"]) * g
        v = oc["beta2"] * st.v[f] + (1.0 - oc["beta2"]) * g * g
        d = (m / bc1) / (torch.sqrt(v / bc2) + oc["eps"])
        keep = active.reshape(active.shape + (1,) * (g.ndim - 1))
        if f == "means":
            upd = position_lr(oc, st.t, total_iters) * d
            norm = torch.linalg.vector_norm(upd, dim=-1, keepdim=True)
            clip = oc["position_update_norm_clip"]
            upd = upd * torch.where(norm > clip, clip / norm.clamp(min=1e-20), torch.ones_like(norm))
            x = p[f] - upd
            keep = keep & (torch.isfinite(x).all(-1, keepdim=True)
                           & (x.abs().amax(-1, keepdim=True) < 1e6))
        elif f == "quats":
            x = p[f] - rates[f] * d
            n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
            ident = torch.zeros_like(x)
            ident[:, 0] = 1.0
            x = torch.where(n > 1e-3, x / n.clamp(min=1e-3), ident)
        else:
            lim = {"log_scales": oc["log_scale_clamp"], "raw_opacities": oc["raw_opacity_clamp"],
                   "sh": oc["sh_clamp"]}[f]
            x = torch.clamp(p[f] - rates[f] * d, -lim, lim)
        new_p[f] = torch.where(keep, x, p[f])
        mom = active.reshape(active.shape + (1,) * (g.ndim - 1))
        new_m[f] = torch.where(mom, m, st.m[f])
        new_v[f] = torch.where(mom, v, st.v[f])
    return State(new_p, new_m, new_v, t, st.prec)


class StepOut(NamedTuple):
    state: State
    loss: float            # the logged loss of the step
    grads: dict            # the loss's gradient, before the clip
    frame: raster.Frame


def step(st: State, pose: dict, gt: torch.Tensor, cfg: dict, total_iters: int,
         loss_fn=None) -> StepOut:
    """One training step on one view at the state's precision.
    ``loss_fn(img, gt, lc, prec)`` replaces the photometric loss (a planted
    fault)."""
    rc = raster.raster_constants(cfg.get("raster", {}))
    lc = loss_constants(cfg)
    gt = gt.to(raster.real(st.prec))
    fn = loss_fn or photometric_loss
    report, grads, frame = raster.render_grad(st.params, pose, rc,
                                              lambda img: fn(img, gt, lc, st.prec), st.prec)
    return StepOut(adam(st, grads, optim_constants(cfg), total_iters),
                   float(report.combined_mean.detach()), grads, frame)
