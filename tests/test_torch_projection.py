"""The port's projection (gaussiansplatting_tpu_torch.ops.projection) and
transforms against the JAX package on the same seeded inputs, and against
the scalar NumPy oracle."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaussiansplatting_tpu.config import RasterConfig as JRasterConfig
from gaussiansplatting_tpu.core import transforms as JT
from gaussiansplatting_tpu.ops import projection as jproj

from gaussiansplatting_tpu_torch.config import RasterConfig
from gaussiansplatting_tpu_torch.core import gaussians as TG
from gaussiansplatting_tpu_torch.core import transforms as TT
from gaussiansplatting_tpu_torch.ops import projection as tproj

from conftest import make_scene
from reference_renderer import project_one
from torch_parity import cameras, scene_params, t2n

torch.set_num_threads(1)

INT_FIELDS = ("tile_min", "tile_max", "n_tiles", "valid")
FLOAT_FIELDS = ("screen_pos", "conic", "depth", "opacity", "color", "radius")


def _both(seed, sh_degree=0, n=64):
    jp, tp = scene_params(seed, n=n, spread=2.0)
    if sh_degree:
        sh = np.random.default_rng(seed).uniform(-1, 1, (n, 4, 3)).astype(np.float32)
        jp = jp.replace(sh=jnp.asarray(sh))
        with torch.no_grad():
            tp.sh.copy_(torch.from_numpy(sh))
    jc, tc = cameras()
    kw = dict(pair_capacity=2048, pair_block=16, sh_degree=sh_degree)
    pj = jproj.project(jp, jc, JRasterConfig(**kw))
    with torch.no_grad():
        pt = tproj.project(tp, tc, RasterConfig(**kw))
    return pj, pt


@pytest.mark.parametrize("seed,sh_degree", [(51, 0), (52, 0), (53, 1)])
def test_project_matches_jax(seed, sh_degree):
    pj, pt = _both(seed, sh_degree)
    for f in INT_FIELDS:
        a, b = np.asarray(getattr(pj, f)), t2n(getattr(pt, f))
        assert b.dtype == a.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=f)
    for f in FLOAT_FIELDS:
        a, b = np.asarray(getattr(pj, f)), t2n(getattr(pt, f))
        assert b.dtype == np.float32
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=f)
    valid = t2n(pt.valid)
    assert 10 < valid.sum() < valid.size           # some culled, most not


def test_project_matches_oracle(rng):
    """Mirrors test_render_forward.py::test_projection_matches_oracle."""
    means, log_scales, quats, raw_op, sh_dc = make_scene(rng, n=64)
    sh = np.zeros((64, 4, 3), np.float32)
    sh[:, 0, :] = sh_dc
    tp = TG.from_arrays(means, log_scales, quats, raw_op, sh)
    jc, tc = cameras()
    with torch.no_grad():
        proj = tproj.project(tp, tc, RasterConfig(pair_capacity=4096, pair_block=32))
    view = np.asarray(jc.view, np.float64)
    viewproj = np.asarray(jc.viewproj, np.float64)
    n_checked = 0
    for i in range(64):
        ref = project_one(
            means[i], log_scales[i], quats[i], raw_op[i], sh_dc[i],
            view, viewproj, float(jc.fx), float(jc.fy), jc.width, jc.height,
        )
        if ref is None:
            assert not bool(proj.valid[i])
            continue
        assert bool(proj.valid[i])
        np.testing.assert_allclose(t2n(proj.screen_pos[i]), ref["screen"], atol=1e-2)
        np.testing.assert_allclose(t2n(proj.conic[i]), ref["conic"], rtol=2e-3, atol=1e-4)
        np.testing.assert_allclose(float(proj.depth[i]), ref["depth"], rtol=1e-5)
        np.testing.assert_allclose(float(proj.opacity[i]), ref["opacity"], rtol=1e-5)
        np.testing.assert_allclose(t2n(proj.color[i]), ref["color"], atol=1e-5)
        assert float(proj.radius[i]) == ref["radius"]
        assert tuple(t2n(proj.tile_min[i])) == ref["tmin"]
        assert tuple(t2n(proj.tile_max[i])) == ref["tmax"]
        n_checked += 1
    assert n_checked > 10


def test_dead_and_nonfinite_gaussians_are_culled():
    jp, tp = scene_params(54, n=16)
    with torch.no_grad():
        tp.means[3, 0] = float("nan")
        tp.log_scales[4, 1] = float("inf")
        tp.alive[5] = False
        _, tc = cameras()
        pt = tproj.project(tp, tc, RasterConfig())
    for i in (3, 4, 5):
        assert not bool(pt.valid[i]) and int(pt.n_tiles[i]) == 0


# ---- core/transforms: each function against its JAX counterpart ----

def _rand(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _cases():
    rng = np.random.default_rng(55)
    q = _rand(rng, 32, 4)
    q[0] = 0.0                                      # degenerate -> identity
    scale = _rand(rng, 32, 3, lo=0.001, hi=0.5)
    cov2d = np.stack([_rand(rng, 32, lo=0.3, hi=5), _rand(rng, 32, lo=-0.5, hi=0.5),
                      _rand(rng, 32, lo=0.3, hi=5)], -1)
    cov2d[1] = (1e-3, 0.0, 1e-3)                    # det below min_det
    view_pos = np.concatenate([_rand(rng, 32, 2, lo=-3, hi=3),
                               _rand(rng, 32, 1, lo=0.5, hi=6)], -1)
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    sh = _rand(rng, 32, 4, 3)
    dirs = _rand(rng, 32, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    x = _rand(rng, 32, lo=-9, hi=9)
    qn = np.asarray(JT.normalize_quat(jnp.asarray(q)))
    cov3d = np.asarray(JT.covariance_3d(jnp.asarray(scale), jnp.asarray(qn)))
    return {
        "quat_to_rotmat": ((q,), {}),
        "normalize_quat": ((q,), {}),
        "clamp_scale_aspect": ((scale,), {"max_aspect": 20.0}),
        "covariance_3d": ((scale, qn), {}),
        "ewa_project": ((cov3d, view_pos, rot, np.array(70.0, np.float32),
                         np.array(65.0, np.float32)), {}),
        "conic_from_cov2d": ((cov2d,), {}),
        "radius_from_cov2d": ((cov2d,), {}),
        "sigmoid": ((x,), {}),
        "sh_dc_to_rgb": ((sh[:, 0],), {}),
        "rgb_to_sh_dc": ((sh[:, 0],), {}),
        "sh_eval_0": ((sh, dirs, 0), {}),
        "sh_eval_1": ((sh, dirs, 1), {}),
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_transform_matches_jax(name):
    args, kw = _cases()[name]
    fn = name.removesuffix("_0").removesuffix("_1")

    def conv(a, to):
        return to(np.array(a)) if isinstance(a, np.ndarray) else a

    want = getattr(JT, fn)(*[conv(a, jnp.asarray) for a in args], **kw)
    got = getattr(TT, fn)(*[conv(a, torch.from_numpy) for a in args], **kw)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        w, g = np.asarray(w), t2n(g)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)


# ---- the presort's rows (ops/projection.rows_plain, _Project) ----

def _sh_scene(seed, degree, n=64):
    """The seeded scene of _both at SH degree ``degree``: every coefficient
    of the row drawn."""
    _, tp = scene_params(seed, n=n, spread=2.0)
    k = TT.sh_coeffs(degree)
    sh = np.random.default_rng(seed).uniform(-1, 1, (n, k, 3)).astype(np.float32)
    return TG.GaussianParams(tp.means.detach(), tp.log_scales.detach(), tp.quats.detach(),
                             tp.raw_opacities.detach(), torch.from_numpy(sh), tp.alive)


def _rows_as_built_before(params, camera, cfg, vs_dummy):
    """The rows as the render built them before the kernels: project, the
    dead zone, the [N, 9] data cat and the [N, 15] presort cat."""
    proj = tproj.project(params, camera, cfg)
    screen_pos = proj.screen_pos if vs_dummy is None else proj.screen_pos + vs_dummy
    c = torch.clamp(proj.color, 0.0, 1.0)
    color = torch.where((c > 0.01) & (c < 0.99), c, c.detach())
    data = torch.cat([screen_pos, proj.conic, proj.opacity[:, None], color], dim=-1)
    f32 = torch.float32
    return torch.cat([proj.depth[:, None], proj.tile_min.to(f32), proj.tile_max.to(f32),
                      proj.n_tiles.to(f32)[:, None], data], dim=-1)


@pytest.mark.parametrize("vs", [False, True])
@pytest.mark.parametrize("seed,degree", [(61, 0), (62, 1), (63, 3)])
def test_rows_plain_is_project_dead_zone_and_cat(seed, degree, vs):
    """rows_plain with default_color equals project -> dead zone -> cat bit
    for bit, and so do the gradients of every field, the SH row and
    vs_dummy for a cotangent on the data columns."""
    params = _sh_scene(seed, degree)
    for p in params.parameters():
        p.requires_grad_(True)
    _, cam = cameras()
    cfg = RasterConfig(pair_capacity=2048, pair_block=16, sh_degree=degree)
    vs_dummy = (torch.from_numpy(np.random.default_rng(seed).uniform(-1, 1, (64, 2))
                                 .astype(np.float32)).requires_grad_(True) if vs else None)
    want = _rows_as_built_before(params, cam, cfg, vs_dummy)
    got, depth, valid = tproj.rows_plain(params, cam, cfg, tproj.default_color(params, cam, cfg),
                                         vs_dummy)
    assert torch.equal(got, want) and torch.equal(depth, want[:, 0])
    assert 10 < int(valid.sum()) < 64
    w = torch.randn(want.shape, generator=torch.Generator().manual_seed(seed))
    w[:, :tproj.DATA_COL] = 0
    leaves = list(params.parameters()) + ([vs_dummy] if vs else [])
    for a, b in zip(torch.autograd.grad((got * w).sum(), leaves),
                    torch.autograd.grad((want * w).sum(), leaves)):
        assert torch.equal(a, b)


def _fd_camera():
    """64x48 with fy < fx, so the Jacobian clamp can bind on both axes
    inside the NDC cull; float64."""
    from gaussiansplatting_tpu_torch.core.camera import make_camera

    cam = make_camera(np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32),
                      76.8, 40.0, 32.0, 24.0, 64, 48)
    return dataclasses.replace(cam, **{f: getattr(cam, f).double()
                                       for f in ("view", "proj", "viewproj", "cam_pos", "fx",
                                                 "fy")})


LN = np.log
# rows (mean, log-scales, quaternion, raw opacity, colour) where each clamp
# and cull of the projection binds
FD_CASES = {
    "aspect": [((0.3, -0.2, 4.0), (LN(0.2), LN(0.005), LN(0.004)), (0.9, 0.3, -0.2, 0.1)),
               ((-0.4, 0.1, 3.5), (LN(0.003), LN(0.004), LN(0.3)), (0.2, 0.7, 0.5, -0.4))],
    "aspect_tie": [((0.1, 0.2, 4.0), (LN(0.2), LN(0.004), LN(0.004)), (0.9, 0.3, -0.2, 0.1)),
                   ((0.2, -0.3, 3.0), (LN(0.2), LN(0.2), LN(0.004)), (0.5, -0.5, 0.5, 0.5)),
                   ((-0.2, 0.0, 5.0), (LN(0.05), LN(0.05), LN(0.06)), (0.3, 0.3, 0.8, 0.1))],
    "jacobian": [((105.0, 3.0, 240.0), (2.1, 1.9, 2.0), (0.9, 0.1, 0.3, 0.2)),
                 ((-105.0, -2.0, 240.0), (2.0, 2.2, 1.8), (0.6, -0.5, 0.2, 0.3)),
                 ((1.0, 60.0, 100.0), (1.6, 1.5, 1.7), (0.7, 0.2, -0.6, 0.1)),
                 ((-2.0, -60.0, 100.0), (1.5, 1.4, 1.6), (0.4, 0.4, 0.4, 0.6))],
    "quat_fallback": [((0.2, 0.1, 4.0), (-3.5, -3.0, -3.2), (4e-4, 1e-4, -2e-4, 3e-4))],
    "scale_and_opacity_clamps": [((0.1, 0.1, 4.0), (-6.0, -5.5, -4.6), (0.8, 0.2, 0.1, 0.5))],
    "culled": [((0.1, 0.0, -1.0), (-3.0, -3.0, -3.0), (1.0, 0, 0, 0)),      # behind
               ((10.0, 0.0, 4.0), (-3.0, -3.0, -3.0), (1.0, 0, 0, 0)),      # off-screen
               ((np.nan, 0.0, 4.0), (-3.0, -3.0, -3.0), (1.0, 0, 0, 0)),    # non-finite
               ((0.1, 0.0, 4.0), (-3.0, np.inf, -3.0), (1.0, 0, 0, 0)),
               ((0.1, 0.2, 4.0), (-3.0, -3.2, -3.1), (1.0, 0, 0, 0))],      # dead
}


def _fd_rows(case):
    rows = FD_CASES[case]
    n = len(rows)
    t = lambda i: torch.tensor([r[i] for r in rows], dtype=torch.float64)  # noqa: E731
    raw = torch.tensor([0.5, 9.0, -9.5, 1.0, -0.3][:n], dtype=torch.float64)
    alive = torch.ones(n, dtype=torch.bool)
    if case == "culled":
        alive[-1] = False
    fields = tproj.Fields(t(0), t(1), t(2), raw, alive)
    color = torch.tensor([[0.3, 0.995, 0.004], [0.5, -0.2, 1.3], [0.7, 0.2, 0.985],
                          [0.02, 0.6, 0.4], [0.4, 0.4, 0.4]][:n], dtype=torch.float64)
    return fields, color


@pytest.mark.parametrize("case", list(FD_CASES))
def test_plain_rows_grad_matches_finite_differences(case):
    """project_bwd_plain in float64 against central differences of
    rows_plain's data columns, element by element, on rows where each clamp
    binds: the aspect clamp (and a tie between two axes, where amax / amin
    share the gradient and central differences average the two sides), the
    Jacobian clamp on both axes and signs (its bounds carry gradient into
    z), the quaternion's identity fallback, the log-scale and raw-opacity
    clamps, the colour clamp; culled and non-finite rows get exactly 0.
    The colour's dead zone is the reference's rule, not a derivative: a
    channel in it gets 0 where differences see a slope."""
    cam, cfg = _fd_camera(), RasterConfig()
    fields, color = _fd_rows(case)
    rows, _, valid = tproj.rows_plain(fields, cam, cfg, color)
    assert bool(valid.all()) == (case != "culled") and not (case == "culled" and valid.any())
    w = torch.randn(rows.shape, dtype=torch.float64, generator=torch.Generator().manual_seed(7))
    grads = tproj.project_bwd_plain(w, fields, color, cam, cfg)
    inputs = [*fields[:4], color]
    c = torch.clamp(color, 0, 1)
    dead = (c <= 0.01) | (c >= 0.99)

    def loss(xs):
        out = tproj.rows_plain(tproj.Fields(*xs[:4], fields.alive), cam, cfg, xs[4])[0]
        return float((out[:, tproj.DATA_COL:] * w[:, tproj.DATA_COL:]).sum())

    h = 1e-6
    for k, (x, g) in enumerate(zip(inputs, grads)):
        assert g.dtype == torch.float64 and g.shape == x.shape
        if case == "culled":
            assert bool((g == 0).all()), k
        fd = torch.zeros_like(x)
        for i in range(x.numel()):
            if not torch.isfinite(x.view(-1)[i]):
                continue
            up, dn = [t.clone() for t in inputs], [t.clone() for t in inputs]
            up[k].view(-1)[i] += h
            dn[k].view(-1)[i] -= h
            fd.view(-1)[i] = (loss(up) - loss(dn)) / (2 * h)
        if k == 4:     # colour: the dead zone passes nothing, differences see 1
            assert bool((g[dead] == 0).all())
            fd = torch.where(dead, 0.0, fd)
        torch.testing.assert_close(g, fd, rtol=1e-5, atol=1e-6 * max(1.0, float(fd.abs().max())))
    if case == "quat_fallback":
        assert bool((grads[2] == 0).all())
    if case in ("aspect", "aspect_tie", "scale_and_opacity_clamps"):
        assert bool((grads[1] != 0).any())


def test_projection_counters_round_trip():
    """The kernels' counters are registered; the plain versions launch
    nothing; a replay's recorded launches add to them by name."""
    from gaussiansplatting_tpu_torch.utils import tracing

    before = tracing.launch_counts()
    assert {"project_fwd", "project_bwd"} <= set(before)
    params = _sh_scene(64, 0)
    _, cam = cameras()
    cfg = RasterConfig()
    color = tproj.default_color(params, cam, cfg)
    rows, _ = tproj.project_fwd(tproj.Fields(*(getattr(params, f) for f in (
        "means", "log_scales", "quats", "raw_opacities", "alive"))), color, None, cam, cfg)
    tproj.project_bwd(torch.ones_like(rows), tproj.Fields(*(getattr(params, f) for f in (
        "means", "log_scales", "quats", "raw_opacities", "alive"))), color, cam, cfg)
    assert tracing.launch_counts() == before
    tracing.add_launches({"project_fwd": 3, "project_bwd": 2})
    after = tracing.launch_counts()
    assert after["project_fwd"] - before["project_fwd"] == 3
    assert after["project_bwd"] - before["project_bwd"] == 2
    tracing.add_launches({k: before[k] - after[k] for k in before})
    assert tracing.launch_counts() == before
