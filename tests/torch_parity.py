"""Shared helpers for the torch-port parity tests (tests/test_torch_*.py):
the same seeded numpy inputs handed to the JAX package and to its PyTorch
port, and the JAX windowed-path intermediates the port is held against."""

import numpy as np

import jax
import jax.numpy as jnp

from gaussiansplatting_tpu.config import RasterConfig as JRasterConfig
from gaussiansplatting_tpu.core import gaussians as JG
from gaussiansplatting_tpu.ops import pairs as jpairs
from gaussiansplatting_tpu.ops import projection as jproj

from gaussiansplatting_tpu_torch.config import RasterConfig
from gaussiansplatting_tpu_torch.core import camera as tcam
from gaussiansplatting_tpu_torch.core import gaussians as TG

from conftest import make_camera_for_scene, make_scene

# the JAX package's own small sizes (tests/test_pallas_blend.py:28-33)
SMALL = dict(pair_capacity=2048, pair_block=16)


def scene_params(seed, n=48, spread=0.6, **kw):
    """(jax GaussianParams, torch GaussianParams) of one seeded scene."""
    rng = np.random.default_rng(seed)
    means, log_scales, quats, raw_op, sh_dc = make_scene(rng, n=n, spread=spread, **kw)
    sh = np.zeros((n, 4, 3), np.float32)
    sh[:, 0, :] = sh_dc
    jp = JG.from_arrays(means, log_scales, quats, raw_op, sh)
    return jp, to_torch_params(jp)


def to_torch_params(jp):
    return TG.params_from_numpy({f: np.asarray(getattr(jp, f)) for f in TG.FIELDS})


def to_torch_camera(jc):
    return tcam.camera_from_numpy(
        np.asarray(jc.view), np.asarray(jc.proj), np.asarray(jc.viewproj),
        np.asarray(jc.cam_pos), np.asarray(jc.fx), np.asarray(jc.fy),
        jc.width, jc.height,
    )


def cameras(width=64, height=48):
    jc = make_camera_for_scene(width=width, height=height)
    return jc, to_torch_camera(jc)


def configs(**kw):
    """(JAX config on the windowed Pallas path, port config)."""
    kw = {**SMALL, **kw}
    return JRasterConfig(**kw, blend_impl="pallas"), RasterConfig(**kw)


def t2n(x):
    return x.detach().cpu().numpy()


def jax_presorted_inputs(jp, jc, jcfg):
    """The JAX render's depth-presorted projection and data, as render
    builds them before the capacity plan (rasterize.py:297-357)."""
    proj = jproj.project(jp, jc, jcfg)
    order = jnp.argsort(proj.depth)
    proj_p = jax.tree_util.tree_map(lambda x: x[order], proj)
    data = jnp.concatenate(
        [proj_p.screen_pos, proj_p.conic, proj_p.opacity[:, None],
         jnp.clip(proj_p.color, 0.0, 1.0)], axis=-1,
    )
    return proj_p, data


def jax_windows(jp, jc, jcfg, packed=False, pack_pos=False, tile_rows=None):
    """JAX capacity plan + pair windows for one view (of the strip
    ``tile_rows`` = (row0, n_rows)), with the bf16 payload flags.  Returns
    (plan, windows, pcfg) with plan = capacity_plan's 7-tuple and windows =
    pair_windows_fwd's 5-tuple."""
    proj_p, data = jax_presorted_inputs(jp, jc, jcfg)
    tiles_x = jproj.num_tiles(jc.width, jcfg.tile_size)
    row0, tiles_y = tile_rows or (0, jproj.num_tiles(jc.height, jcfg.tile_size))
    n = proj_p.depth.shape[0]
    plan = jpairs.capacity_plan(
        proj_p, tiles_x, tiles_y, jcfg.pair_capacity, jnp.int32(row0),
        jcfg.overflow_drop,
    )
    counts, ccounts, coffsets, ty_lo, span_x, total, _ = plan
    pcfg = (
        n, jcfg.pair_capacity, tiles_x, tiles_y, jcfg.pair_block,
        jcfg.grad_reduce, jpairs._chunk_capacity(jcfg.pair_capacity, n),
        True, packed, packed and pack_pos, jcfg.tile_size,
    )
    windows = jpairs.pair_windows_fwd(
        data, proj_p.depth, jnp.int32(row0), counts, ccounts, coffsets, ty_lo,
        proj_p.tile_min[:, 0], span_x, pcfg,
    )
    return plan, windows, pcfg
