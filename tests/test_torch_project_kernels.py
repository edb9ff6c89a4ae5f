"""Projection's kernel pair (ops/projection.py, csrc/projection.cu): the
checks that hold the kernels to the plain form, run here on the plain
float32 form standing in for the kernels, and on the card against the
kernels at the benchmark cells' row counts (1.5M Gaussians of
``garden_c4.render``, 5.8M of ``garden_mip360.refine``):

  forward   every float column no farther from the plain form run in
            float64 than twice the plain float32 form's own distance (norm
            over the rows every version decides alike); the integer columns
            (tile rects, tile counts) and the cull equal to float64's but
            on rows within rounding of a boundary, which are counted: each
            such row must be one where the plain float32 form decides apart
            from float64 too, or where a perturbation of its float inputs
            by 2^-20 makes float64 decide as the kernel did; culled rows
            zero; the depth key the rows' column 0;
  backward  each field's gradient within a relative norm of 1e-5 of the
            plain form's in float64 (autograd's vector-Jacobian product),
            and apart on the rows where the EWA Jacobian's clamp binds,
            exactly 0 on every culled row;
  and two launches giving the same bits, one ``project_fwd`` a frame and
  one ``project_bwd`` a step in the captured graphs.

The scenes are built to reach every branch: scales over e^-6 to e^-0.5
(the aspect clamp binds, cov2D's condition up to ~400), Gaussians far off
axis (the Jacobian clamp binds), ties between two axes, quaternions of
norm below 1e-3, dead, non-finite and behind-camera rows, colours in and
out of the dead zone.  chip_smoke.py's projection phase runs the same
checks (it loads this file's helpers).

No JAX here: on the machine with the card this file runs alone,
``python -m pytest --noconftest tests/test_torch_project_kernels.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gaussiansplatting_tpu_torch.config import RasterConfig
from gaussiansplatting_tpu_torch.core.camera import make_camera
from gaussiansplatting_tpu_torch.ops import projection as tproj
from gaussiansplatting_tpu_torch.utils import synthetic, tracing

torch.set_num_threads(1)

BWD_REL_NORM = 1e-5      # kernel gradients against float64, per field
FLOAT_RATIO = 2.0        # kernel's distance to float64 over plain float32's
PERTURB = 2.0 ** -20     # relative perturbation that explains an integer flip
PERTURB_DRAWS = 16
GROUPS = {"depth": [0], "screen_pos": [6, 7], "conic": [8, 9, 10], "opacity": [11],
          "color": [12, 13, 14]}
FIELDS = ("means", "log_scales", "quats", "raw_opacities", "color")


def camera(width, height, device=None):
    """A posed camera (rotated, translated, fx != fy) at width x height."""
    q = np.array([0.95, 0.1, 0.2, -0.15], np.float32)
    q /= np.linalg.norm(q)
    return make_camera(q, np.array([0.2, -0.1, 0.5], np.float32), 1.1 * width, 1.05 * width,
                       0.51 * width, 0.49 * height, width, height, device=device)


def scene(n, seed, cam, device=None, vs=False):
    """(Fields, colour [N, 3], vs_dummy [N, 2] or None) of n Gaussians that
    reach every branch of the projection (the module docstring) in the
    camera ``cam``: a 37th of them far in front of it, where the EWA
    Jacobian's clamp (limx = 1.3 fx / z at RasterConfig's default) binds
    on one or both axes inside the NDC cull, with splats ~1-2% of their
    depth across."""
    p = synthetic.make_scene(n, seed=seed, spread=2.0, log_scale_range=(-6.0, -0.5))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        p.quats.mul_(torch.from_numpy(rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)))
        far = torch.arange(19, n, 37)
        fx, fy = float(cam.fx), float(cam.fy)
        z = rng.uniform(4.5, 5.5, far.numel()) * fx
        jc = RasterConfig().jacobian_clamp
        lim = np.stack([jc * fx / z, jc * fy / z], -1)
        u = (rng.choice([-1.0, 1.0], (far.numel(), 2)) * lim
             * rng.uniform(1.05, 1.3, (far.numel(), 2)))
        u[::3, 1] *= 0.5                                   # one axis binds, the other not
        view = cam.view.double().cpu().numpy()
        v = np.concatenate([u * z[:, None], z[:, None]], -1)
        p.means[far] = torch.from_numpy(((v - view[:3, 3]) @ view[:3, :3]).astype(np.float32))
        p.log_scales[far] = torch.from_numpy(
            np.log(rng.uniform(0.005, 0.02, (far.numel(), 3)) * z[:, None]).astype(np.float32))
        p.log_scales[11::89, 1] = p.log_scales[11::89, 0]   # a tie between two axes
        p.quats[7::103] *= 1e-4                         # the quaternion fallback
        p.alive[::97] = False
        p.means[5::101, 2] = -1.0                       # behind the camera
        p.means[13::211, 0] = float("nan")
        p.log_scales[17::223, 2] = float("inf")
    color = torch.from_numpy(rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32))
    fields = tproj.Fields(*(getattr(p, f).detach().to(device) for f in FIELDS[:4]),
                          p.alive.to(device))
    vs_dummy = (torch.from_numpy(rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)).to(device)
                if vs else None)
    return fields, color.to(device), vs_dummy


def _cam64(cam):
    return dataclasses.replace(cam, **{f: getattr(cam, f).double()
                                       for f in ("view", "proj", "viewproj", "cam_pos", "fx",
                                                 "fy")})


def _f64(fields, color, vs):
    return (tproj.Fields(*(t.double() for t in fields[:4]), fields.alive), color.double(),
            None if vs is None else vs.double())


def _decisions(rows):
    """Each row's integer columns (tile rect, tile count) and its cull (a
    live row's conic a / det > 0), float64 [N, 6]."""
    return torch.cat([rows[:, 1:6].double(), (rows[:, 10] > 0).double()[:, None]], dim=-1)


def _explained(k_dec, idx, fields, color, cam, cfg):
    """Of the rows ``idx``, those for which some perturbation of their float
    inputs by a relative PERTURB makes the float64 plain form decide as
    ``k_dec`` (the kernel's decisions of those rows)."""
    gen = torch.Generator(fields.means.device).manual_seed(0)
    sub = [t[idx].double() for t in fields[:4]]
    out = torch.zeros(idx.numel(), dtype=torch.bool, device=idx.device)
    for _ in range(PERTURB_DRAWS):
        pert = [t * (1 + PERTURB * (2 * torch.rand(t.shape, generator=gen, device=t.device,
                                                    dtype=t.dtype) - 1)) for t in sub]
        rows = tproj.rows_plain(tproj.Fields(*pert, fields.alive[idx]), _cam64(cam), cfg,
                                color[idx].double())[0]
        out |= (_decisions(rows) == k_dec).all(-1)
    return out


def check_fwd(rows, depth, fields, color, vs, cam, cfg):
    """Hold forward rows [N, 15] and depth [N] (the kernel's, or another
    float32 form's) to the plain form (the module docstring).  Returns
    {"rows", "valid" (float64's live rows), "flips" (rows deciding apart
    from float64, each within rounding), "flips_plain32", "ratio" by column
    group, "live" (the rows' own cull), "same" (rows every version decides
    alike, live in float64)}."""
    r32, _, _ = tproj.rows_plain(fields, cam, cfg, color, vs)
    f64, c64, vs64 = _f64(fields, color, vs)
    r64, _, valid64 = tproj.rows_plain(f64, _cam64(cam), cfg, c64, vs64)
    assert rows.dtype == torch.float32 and tuple(rows.shape) == tuple(r32.shape)
    assert torch.equal(depth, rows[:, 0])
    d_k, d_32, d_64 = _decisions(rows), _decisions(r32), _decisions(r64)
    flip_k = (d_k != d_64).any(-1)
    flip_32 = (d_32 != d_64).any(-1)
    idx = torch.nonzero(flip_k & ~flip_32).flatten()
    if idx.numel():
        unexplained = idx[~_explained(d_k[idx], idx, fields, color, cam, cfg)]
        assert unexplained.numel() == 0, (
            f"rows {unexplained[:8].tolist()} decide apart from float64 beyond rounding")
    # culled rows: zero but for vs_dummy
    live = rows[:, 10] > 0
    want = torch.zeros_like(rows[~live])
    if vs is not None:
        want[:, 6:8] = vs[~live]
    assert torch.equal(rows[~live], want)
    same = ~flip_k & ~flip_32 & valid64
    ratio = {}
    for name, cols in GROUPS.items():
        ref = r64[same][:, cols]
        dk = float((rows[same][:, cols].double() - ref).norm())
        d32 = float((r32[same][:, cols].double() - ref).norm())
        assert dk <= FLOAT_RATIO * d32, (name, dk, d32)
        ratio[name] = dk / d32 if d32 else 0.0
    return {"rows": rows.shape[0], "valid": int(valid64.sum()), "flips": int(flip_k.sum()),
            "flips_plain32": int(flip_32.sum()), "ratio": ratio, "live": live, "same": same}


def _clamp_binds(fields, cam, cfg):
    """Rows whose EWA Jacobian clamp binds on either axis (in float64)."""
    view = cam.view.double()
    v = fields.means.double() @ view[:3, :3].T + view[:3, 3]
    z = v[:, 2]
    lim = cfg.jacobian_clamp * torch.stack([cam.fx.double(), cam.fy.double()]) / z[:, None]
    return ((v[:, :2] / z[:, None]).abs() > lim).any(-1)


def check_bwd(grads, g_rows, fields, color, cam, cfg, live, same):
    """Hold the gradients (d_means, d_log_scales, d_quats, d_raw_opacities,
    d_color) of the cotangent g_rows to the plain form's in float64 on the
    rows ``same`` (check_fwd's), and apart on those of them where the
    Jacobian clamp binds (far rows, whose gradients the near ones would
    drown), each exactly 0 on a row the forward culled (not ``live``).
    Returns each field's relative norm over the rows and, under
    "clamp_binds", over the binding rows."""
    f64, c64, _ = _f64(fields, color, None)
    want = tproj.project_bwd_plain(g_rows.double(), f64, c64, _cam64(cam), cfg)
    binds = same & _clamp_binds(fields, cam, cfg)
    assert int(binds.sum()) > 0
    rel = {"clamp_binds": {}}
    for name, a, b in zip(FIELDS, grads, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert bool((a[~live] == 0).all()), f"{name}: nonzero gradient on a culled row"
        for rows, out in ((same, rel), (binds, rel["clamp_binds"])):
            x, y = a[rows].double(), b[rows]
            out[name] = float((x - y).norm() / y.norm())
            assert out[name] <= BWD_REL_NORM, (name, out is rel, out[name])
    return rel


def test_checks_pass_the_plain_form():
    """The checks themselves, on the CPU: the plain float32 form passes them
    as the kernels must (ratio 1, no flip beyond its own), with and without
    vs_dummy, every branch reached; a perturbation explains float64's own
    decisions."""
    cfg = RasterConfig()
    cam = camera(160, 120)
    for vs in (False, True):
        fields, color, vs_dummy = scene(6_000, 3, cam, vs=vs)
        rows, depth = tproj.project_fwd(fields, color, vs_dummy, cam, cfg)
        res = check_fwd(rows, depth, fields, color, vs_dummy, cam, cfg)
        assert 0.2 * res["rows"] < res["valid"] < res["rows"]
        assert all(r == 1.0 for name, r in res["ratio"].items() if name != "color")
    g = torch.randn(rows.shape, generator=torch.Generator().manual_seed(1))
    grads = tproj.project_bwd(g, fields, color, cam, cfg)
    rel = check_bwd(grads, g, fields, color, cam, cfg, res["live"], res["same"])
    assert max(v for k, v in rel.items() if k != "clamp_binds") < BWD_REL_NORM
    idx = torch.arange(64)
    f64, c64, _ = _f64(fields, color, None)
    d64 = _decisions(tproj.rows_plain(f64, _cam64(cam), cfg, c64)[0])
    assert bool(_explained(d64[idx], idx, fields, color, cam, cfg).all())


# -- on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the projection kernels have no CPU mode")
    return torch.device("cuda")


# the benchmark cells' Gaussians and frames
CELLS = {"garden_c4": (1_500_000, 800, 608), "garden_mip360": (5_800_000, 1297, 840)}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CELLS))
def test_project_kernels_match_plain_cuda(cell):
    """At the cells' row counts: project_fwd with and without vs_dummy, and
    project_bwd on a random cotangent, against the plain form (check_fwd,
    check_bwd)."""
    dev = _cuda()
    n, width, height = CELLS[cell]
    cfg = RasterConfig()
    cam = camera(width, height, dev)
    for vs in (False, True):
        fields, color, vs_dummy = scene(n, 7, cam, dev, vs=vs)
        rows, depth = tproj.project_fwd(fields, color, vs_dummy, cam, cfg)
        torch.cuda.synchronize()
        res = check_fwd(rows, depth, fields, color, vs_dummy, cam, cfg)
        print(f"{cell} vs={vs}: {res['flips']} rows decide apart from float64 (plain float32: "
              f"{res['flips_plain32']}), distance ratios {res['ratio']}")
    g = torch.randn(rows.shape, device=dev, generator=torch.Generator(dev).manual_seed(2))
    grads = tproj.project_bwd(g, fields, color, cam, cfg)
    rel = check_bwd(grads, g, fields, color, cam, cfg, res["live"], res["same"])
    print(f"{cell}: gradients' relative norms against float64 {rel}")


@pytest.mark.cuda
def test_project_kernels_repeat_their_bits_cuda():
    """Two launches on the same inputs give the same bits, both ways."""
    dev = _cuda()
    cfg = RasterConfig()
    cam = camera(800, 608, dev)
    fields, color, vs_dummy = scene(1_500_000, 8, cam, dev, vs=True)
    a, b = (tproj.project_fwd(fields, color, vs_dummy, cam, cfg) for _ in range(2))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    g = torch.randn(a[0].shape, device=dev, generator=torch.Generator(dev).manual_seed(3))
    da, db = (tproj.project_bwd(g, fields, color, cam, cfg) for _ in range(2))
    for x, y in zip(da, db):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_project_rows_function_cuda():
    """project_rows (the autograd Function) on the card: the kernels'
    values, their gradients, vs_dummy's gradient the screen columns'
    cotangent as it is, and the launches counted."""
    dev = _cuda()
    cfg = RasterConfig()
    cam = camera(800, 608, dev)
    fields, color, vs_dummy = scene(200_000, 9, cam, dev, vs=True)
    leaves = [t.clone().requires_grad_(True) for t in (*fields[:4], color, vs_dummy)]
    params = tproj.Fields(*leaves[:4], fields.alive)
    before = tracing.launch_counts()
    rows, depth = tproj.project_rows(params, cam, cfg, leaves[4], leaves[5])
    g = torch.randn(rows.shape, device=dev, generator=torch.Generator(dev).manual_seed(4))
    got = torch.autograd.grad(rows, leaves, g)
    after = tracing.launch_counts()
    assert after["project_fwd"] - before["project_fwd"] == 1
    assert after["project_bwd"] - before["project_bwd"] == 1
    want_rows, want_depth = tproj.project_fwd(fields, color, vs_dummy, cam, cfg)
    assert torch.equal(rows, want_rows) and torch.equal(depth, want_depth)
    assert not depth.requires_grad
    for a, b in zip(got, tproj.project_bwd(g, fields, color, cam, cfg)):
        assert torch.equal(a, b)
    assert torch.equal(got[5], g[:, 6:8])


@pytest.mark.cuda
def test_project_graph_launches_cuda():
    """A captured render graph records one project_fwd a frame; a captured
    step graph one project_fwd and one project_bwd a step, and its replays
    add them."""
    dev = _cuda()
    from gaussiansplatting_tpu_torch.config import Config
    from gaussiansplatting_tpu_torch.train import graph as tgraph
    from gaussiansplatting_tpu_torch.train import state as tstate
    from gaussiansplatting_tpu_torch.train import trainer as ttrainer

    raster = RasterConfig(pair_capacity=1 << 14)
    params = synthetic.make_scene(300, seed=4, device=dev)
    cam = synthetic.make_canonical_camera(64, 48, device=dev)
    tgraph.render_frame(params, cam, raster)
    render = tgraph.live_renders()[-1]
    assert render.launches["project_fwd"] == 1 and render.launches.get("project_bwd", 0) == 0
    gt = torch.zeros((48, 64, 3), device=dev)
    before = tgraph.launch_counts()
    ttrainer.train_steps(tstate.create(params), [cam] * 3, [gt] * 3, Config(raster=raster), 100)
    torch.cuda.synchronize()
    step = tgraph.live()[-1]
    assert step.launches["project_fwd"] == 1 and step.launches["project_bwd"] == 1
    after = tgraph.launch_counts()
    n = 3 + tgraph.WARMUP_STEPS
    assert after["project_bwd"] - before["project_bwd"] == n
    tgraph.clear()
