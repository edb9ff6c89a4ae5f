"""Graft entry points, counterparts of the repository's __graft_entry__.py.

``entry`` returns a single-card forward render on the flagship model (the
differentiable tiled 3DGS rasterizer) plus example arguments: 1,024
Gaussians of ``utils/synthetic.make_scene(seed=0)``, the canonical 256x256
camera, ``pair_capacity=2^15`` and ``pair_block=64``.

``dryrun_multichip(n)`` runs the sharded training step (parallel/sharded.py)
on n ranks started by ``parallel.launch.spawn`` and holds it against the
single-card step.

    forward, (params, camera) = entry()          # on the card
    image = forward(params, camera)              # [256, 256, 3]
    dryrun_multichip(2)                          # 2 ranks
"""

from __future__ import annotations


def entry(device="cuda"):
    """(forward, (params, camera)) with params and camera on ``device``;
    forward(params, camera) returns the rendered image [H, W, 3]."""
    from gaussiansplatting_tpu_torch.config import RasterConfig
    from gaussiansplatting_tpu_torch.ops.rasterize import render
    from gaussiansplatting_tpu_torch.utils import synthetic

    cfg = RasterConfig(pair_capacity=1 << 15, pair_block=64)
    params = synthetic.make_scene(n=1024, seed=0, device=device)
    camera = synthetic.make_canonical_camera(width=256, height=256, device=device)

    def forward(params, camera):
        image, aux = render(params, camera, cfg)
        return image

    return forward, (params, camera)


# dryrun_multichip's bars (__graft_entry__.py:68-110): loss, parameters
LOSS_ATOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6


def _close(label, got, want):
    import numpy as np

    from gaussiansplatting_tpu_torch.train.optimizer import TRAINABLE

    for f in TRAINABLE:
        a = getattr(got, f).detach().cpu().numpy()
        b = getattr(want, f).detach().cpu().numpy()
        if not np.allclose(a, b, rtol=PARAM_RTOL, atol=PARAM_ATOL):
            raise AssertionError(f"{label}: {f} max|err| {np.abs(a - b).max():.3e}")


def _dryrun_rank(topo, n_devices):
    """One rank of dryrun_multichip: the checks of __graft_entry__.py:33-110,
    returning the losses it compared."""
    import numpy as np
    import torch

    from gaussiansplatting_tpu_torch.config import Config, RasterConfig
    from gaussiansplatting_tpu_torch.parallel import mesh as mesh_mod
    from gaussiansplatting_tpu_torch.parallel.sharded import (
        make_sharded_train_step, make_sharded_train_step_batched)
    from gaussiansplatting_tpu_torch.train import state as train_state
    from gaussiansplatting_tpu_torch.train.trainer import train_step, train_step_batched
    from gaussiansplatting_tpu_torch.utils import synthetic

    device = topo["device"]
    mesh = mesh_mod.make_mesh(n_devices)
    cfg = Config(raster=RasterConfig(pair_capacity=2048, pair_block=16))
    params = synthetic.make_scene(n=48, seed=3, spread=0.6, device=device)
    camera = synthetic.make_canonical_camera(width=64, height=16 * n_devices, device=device)
    gt = torch.zeros((camera.height, camera.width, 3), device=device)

    st0 = train_state.create(params)
    st, metrics = make_sharded_train_step(mesh, cfg, total_iters=100)(st0, camera, gt)
    if not np.isfinite(float(metrics.loss)):
        raise AssertionError("sharded step: non-finite loss")
    ref_st, ref_metrics = train_step(st0, camera, gt, cfg, 100)
    if abs(float(metrics.loss) - float(ref_metrics.loss)) >= LOSS_ATOL:
        raise AssertionError(f"sharded loss {float(metrics.loss)} != single-card "
                             f"{float(ref_metrics.loss)}")
    _close("sharded step", st.params, ref_st.params)

    # chunked gradient all-reduce: bit-identical to one all-reduce per group
    st_ov, _ = make_sharded_train_step(mesh, cfg, total_iters=100,
                                       grad_psum_chunks=4)(st0, camera, gt)
    for f in ("means", "log_scales", "quats", "raw_opacities", "sh"):
        if not torch.equal(getattr(st_ov.params, f), getattr(st.params, f)):
            raise AssertionError(f"chunked all-reduce: {f} differs")

    # batched (K views) x sharded against the single-card batched step
    cams, gts = [camera, camera], [gt, gt * 0.5 + 0.25]
    stb, mb = make_sharded_train_step_batched(mesh, cfg, 100, 2)(
        train_state.create(params), cams, gts)
    ref_stb, ref_mb = train_step_batched(train_state.create(params), cams, gts, cfg, 100)
    if abs(float(mb.loss) - float(ref_mb.loss)) >= LOSS_ATOL:
        raise AssertionError(f"batched sharded loss {float(mb.loss)} != {float(ref_mb.loss)}")
    _close("batched sharded step", stb.params, ref_stb.params)
    return {"loss": float(metrics.loss), "ref_loss": float(ref_metrics.loss),
            "batched_loss": float(mb.loss), "batched_ref_loss": float(ref_mb.loss)}


def dryrun_multichip(n_devices: int, device: str = "cuda") -> list:
    """Run one sharded training step over ``n_devices`` ranks (started by
    parallel.launch.spawn, the backend by launch.BACKEND_RULE) and hold it
    against the single-card step: loss within 1e-5 and every updated
    parameter within rtol 1e-5 / atol 1e-6; the chunked gradient all-reduce
    bit-identical to the unchunked one; the batched (K = 2) sharded step
    against train_step_batched.  The JAX dry run's last block (bf16 payload
    and packed positions through the sharded step, __graft_entry__.py:112-
    130) waits for those modes' port (ROADMAP.md §A, modes and variants).
    Returns each rank's compared losses."""
    from gaussiansplatting_tpu_torch.parallel import launch

    return launch.spawn(_dryrun_rank, n_devices, (n_devices,), device=device)
