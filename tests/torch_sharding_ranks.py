"""Rank bodies of tests/test_torch_sharding.py.  ``parallel.launch.spawn``
starts each rank as a fresh process that imports this module, so it
imports no JAX (nor conftest, which does): its inputs arrive as numpy
arrays and its results leave as numpy arrays."""

import numpy as np
import torch
import torch.distributed as dist

from gaussiansplatting_tpu_torch.config import Config, DensityConfig, OptimConfig, RasterConfig
from gaussiansplatting_tpu_torch.core import camera as tcam
from gaussiansplatting_tpu_torch.core import gaussians as TG
from gaussiansplatting_tpu_torch.density import control as density
from gaussiansplatting_tpu_torch.ops.losses import photometric_loss
from gaussiansplatting_tpu_torch.parallel import mesh as mesh_mod
from gaussiansplatting_tpu_torch.parallel import sharded
from gaussiansplatting_tpu_torch.train import graph, optimizer, schedule
from gaussiansplatting_tpu_torch.train import state as tstate
from gaussiansplatting_tpu_torch.train import trainer

SMALL = dict(pair_capacity=2048, pair_block=16)
METRICS = ("loss", "l1", "dssim", "psnr", "num_pairs", "overflow")


def camera_arrays(cam) -> tuple:
    """A camera as the arguments of core.camera.camera_from_numpy."""
    return tuple(np.asarray(x) for x in (cam.view, cam.proj, cam.viewproj, cam.cam_pos,
                                         cam.fx, cam.fy)) + (cam.width, cam.height)


def metrics_np(m) -> dict:
    return {f: float(getattr(m, f)) for f in METRICS}


# a position LR that decays over FLOAT_FORM_STEPS steps
FLOAT_FORM_OPTIM = dict(position_lr_init=2e-3, position_lr_final=2e-4)
FLOAT_FORM_STEPS = 3


def _float_scalar_sharded_step(mesh, state, camera, gt, cfg, total_iters):
    """The sharded step with its changing scalars as Python floats
    (learning_rates and _bc's defaults), the form before the bodies took
    them as a device tensor."""
    params = state.params
    trainable = [getattr(params, f) for f in optimizer.TRAINABLE]
    vs_zero = torch.zeros((params.capacity, 2), requires_grad=True)
    with torch.enable_grad():
        img, _ = sharded._full_image(params, camera, cfg.raster, mesh, vs_zero)
        rep = photometric_loss(img, gt, cfg.loss)
        *grads, vs_grad = torch.autograd.grad(rep.grad_loss, trainable + [vs_zero])
    grad = sharded.chunked_all_reduce(dict(zip(optimizer.TRAINABLE, grads)), mesh)
    vs_grad = sharded._all_reduce(vs_grad, mesh)
    lrs = schedule.learning_rates(cfg.optim, state.opt.t, total_iters)
    new_params, new_opt = optimizer.step(params, grad, state.opt, lrs, cfg.optim)
    accum = density.accumulate(state.accum, vs_grad, grad["means"], cfg.density)
    return tstate.TrainState(new_params, new_opt, accum, state.generator), rep.combined_mean


def _float_scalar_sharded_batched(mesh, state, cameras, gts, cfg, total_iters):
    """The sharded batched step in the float-scalar form."""
    k = len(cameras)

    def render_view(p, cam, vs):
        return sharded._full_image(p, cam, cfg.raster, mesh, vs)

    grad, vs_grad, pos_grad, reps, _, _ = trainer.batched_view_grads(
        state.params, cameras, gts, cfg, render_view)
    grad = sharded.chunked_all_reduce(grad, mesh)
    vs_grad = sharded._all_reduce(vs_grad, mesh)
    pos_grad = sharded._all_reduce(pos_grad, mesh)
    lrs = schedule.learning_rates(cfg.optim, state.opt.t, total_iters)
    new_params, new_opt = optimizer.step(state.params, grad, state.opt, lrs, cfg.optim)
    accum = state.accum
    for v in range(k):
        accum = density.accumulate(accum, vs_grad[v] * k, pos_grad[v] * k, cfg.density)
    loss = torch.stack([r.combined_mean for r in reps]).mean()
    return tstate.TrainState(new_params, new_opt, accum, state.generator), loss


def _bits_differ(a, b):
    """The state arrays (and the loss) in which two (state, loss) results
    differ bit for bit."""
    x, y = tstate.state_to_numpy(a[0]), tstate.state_to_numpy(b[0])
    out = [k for k in x if x[k].tobytes() != y[k].tobytes()]
    if a[1].detach().numpy().tobytes() != b[1].detach().numpy().tobytes():
        out.append("loss")
    return out


def float_form_checks(mesh, params, cams, gts):
    """FLOAT_FORM_STEPS sharded steps and batched steps (decaying position
    LR) through make_sharded_* against the float-scalar forms: the state
    arrays and the losses that differ after each step (none, bit for
    bit)."""
    cfg = Config(raster=RasterConfig(**SMALL), optim=OptimConfig(**FLOAT_FORM_OPTIM))
    total = FLOAT_FORM_STEPS
    step = sharded.make_sharded_train_step(mesh, cfg, total)
    batched = sharded.make_sharded_train_step_batched(mesh, cfg, total, 2)
    out = {"step": [], "batched": []}
    a = b = c = d = tstate.create(params)
    for _ in range(FLOAT_FORM_STEPS):
        a, ma = step(a, cams[0], gts[0])
        b, lb = _float_scalar_sharded_step(mesh, b, cams[0], gts[0], cfg, total)
        out["step"].append(_bits_differ((a, ma.loss), (b, lb)))
        c, mc = batched(c, cams, gts)
        d, ld = _float_scalar_sharded_batched(mesh, d, cams, gts, cfg, total)
        out["batched"].append(_bits_differ((c, mc.loss), (d, ld)))
    return out


def sharded_checks(topo, case):
    """On every rank of a 2-rank group: the sharded render, the sharded
    step and batched step (each also with chunked gradient all-reduces),
    a sharded train_loop across density events, the steps against their
    float-scalar forms, and the graph counts (none on gloo).  ``case``: params
    (FIELDS arrays), cams (two camera_arrays), gts (two images), loop
    (start params, camera, gt, density schedule, epochs)."""
    torch.set_num_threads(1)
    cfg = Config(raster=RasterConfig(**SMALL))
    cams = [tcam.camera_from_numpy(*c) for c in case["cams"]]
    gts = [torch.from_numpy(g) for g in case["gts"]]
    mesh = mesh_mod.make_mesh(2)
    out = {"topo": topo, "mesh": tuple(mesh[1:])}

    r = sharded.make_sharded_render(mesh, cfg)(TG.params_from_numpy(case["target"]), cams[0])
    out["render"] = (r.image.numpy(), int(r.num_pairs))

    def start():
        return tstate.create(TG.params_from_numpy(case["params"]))

    st, m = sharded.make_sharded_train_step(mesh, cfg, 100)(start(), cams[0], gts[0])
    out["step"] = (tstate.state_to_numpy(st), metrics_np(m))
    st, _ = sharded.make_sharded_train_step(mesh, cfg, 100, grad_psum_chunks=4)(
        start(), cams[0], gts[0])
    out["step_chunked"] = tstate.state_to_numpy(st)
    st, m = sharded.make_sharded_train_step_batched(mesh, cfg, 100, 2)(start(), cams, gts)
    out["batched"] = (tstate.state_to_numpy(st), metrics_np(m))
    st, _ = sharded.make_sharded_train_step_batched(mesh, cfg, 100, 2, grad_psum_chunks=3)(
        start(), cams, gts)
    out["batched_chunked"] = tstate.state_to_numpy(st)

    loop = case["loop"]
    lcfg = Config(raster=RasterConfig(**SMALL), density=DensityConfig(**loop["density"]))
    logs = []
    st = trainer.train_loop(
        tstate.create(TG.params_from_numpy(loop["start"])),
        [tcam.camera_from_numpy(*loop["camera"])], [torch.from_numpy(loop["gt"])], lcfg,
        scene_extent=1.0, num_epochs=loop["epochs"], mesh_devices=2, log_fn=logs.append)
    out["loop"] = (tstate.state_to_numpy(st), logs)

    out["float_forms"] = float_form_checks(mesh, TG.params_from_numpy(case["params"]), cams, gts)
    # a gloo rank runs the bodies op by op: no graph was captured
    out["replays"] = sharded.replays(dist.get_backend(mesh.group), "cpu")
    out["captures"] = {k: v for k, v in graph.counts.items() if v}
    return out


def nccl_graph_checks(topo):
    """On one NCCL rank (tests/test_torch_dispatch.py, on the card): the
    sharded step, batched step and render replays against their bodies run
    eagerly, bit for bit, and the captures they made."""
    from gaussiansplatting_tpu_torch.utils import synthetic

    dev = torch.device(topo["device"])
    mesh = mesh_mod.make_mesh()
    params = synthetic.make_scene(300, seed=4, device=dev)
    cams = [synthetic.make_canonical_camera(64, 48, fov_scale=f, device=dev) for f in (1.2, 1.1)]
    gts = [torch.rand(48, 64, 3, device=dev) for _ in cams]
    cfg = Config(raster=RasterConfig(pair_capacity=1 << 14, pair_block=16))
    st = tstate.create(params)
    scalars = trainer.device_scalars(cfg, 0, 1, 100, dev)[0]
    a, _ = sharded.make_sharded_train_step(mesh, cfg, 100)(st, cams[0], gts[0])
    b, _ = sharded.step_body(st, cams[0], gts[0], cfg, scalars, mesh)
    c, _ = sharded.make_sharded_train_step_batched(mesh, cfg, 100, 2)(st, cams, gts)
    d, _ = sharded.batched_body(st, cams, gts, cfg, scalars, mesh)
    r = sharded.make_sharded_render(mesh, cfg)(params, cams[0])
    e = sharded.render_body(params, cams[0], cfg.raster, mesh)

    def same(x, y):
        x, y = tstate.state_to_numpy(x), tstate.state_to_numpy(y)
        return all(x[k].tobytes() == y[k].tobytes() for k in x)

    return {"step": same(a, b), "batched": same(c, d),
            "render": bool(torch.equal(r.image, e.image)),
            "captures": graph.counts["sharded_captures"]}
