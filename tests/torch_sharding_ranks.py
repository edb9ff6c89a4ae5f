"""Rank bodies of tests/test_torch_sharding.py.  ``parallel.launch.spawn``
starts each rank as a fresh process that imports this module, so it
imports no JAX (nor conftest, which does): its inputs arrive as numpy
arrays and its results leave as numpy arrays."""

import numpy as np
import torch

from gaussiansplatting_tpu_torch.config import Config, DensityConfig, RasterConfig
from gaussiansplatting_tpu_torch.core import camera as tcam
from gaussiansplatting_tpu_torch.core import gaussians as TG
from gaussiansplatting_tpu_torch.parallel import mesh as mesh_mod
from gaussiansplatting_tpu_torch.parallel import sharded
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


def sharded_checks(topo, case):
    """On every rank of a 2-rank group: the sharded render, the sharded
    step and batched step (each also with chunked gradient all-reduces),
    and a sharded train_loop across density events.  ``case``: params
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
    return out
