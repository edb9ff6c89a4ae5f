"""2D Gaussian Splatting's surfels on the port (RasterConfig.primitive
"surfel") against the float64 plain reference of tests/reference_surfel.py
on seeded random surfels at a small size: the frame's maps (image, alpha,
expected depth, normal, depth distortion), the loss with both regularizers
and the gradient of every field, a train step; an edge-on surfel where the
low-pass wins; a tile whose pairs span several blocks (compose's cross-block
distortion); each new kernel's plain form against the reference; the
surfel split in the disc's plane; a PLY of two scales; the paths that raise
for surfels; the marks and counters; the tools.  The ``cuda`` tests hold
the kernels to their plain forms on the card.

Tolerances, each float32 against float64 (measured on the CPU, the bars
~10x above): the image within 2e-5 (sums of ~100 rounded terms), alpha
within 2e-5 (A = 1 - exp(S), S a float32 sum), the expected depth and the
normal within a relative norm of 1e-5, the distortion within 2e-6 absolute
(A M2 - M1^2 of float32 moments of size ~1 cancels to values ~1e-4: a few
ulps of the products), the loss within 1e-6 relative; each field's
gradient within a relative norm of 2e-4: the intersection's gradient
through (c0, c1) / c2 is ill-conditioned for surfels seen near edge-on (a
2^-23 perturbation of the means moves the float32 gradient of the means
by ~2e-4 in relative norm at 20k surfels), measured ~2e-5 here.

No JAX here: on the machine with the card this file runs alone,
``python -m pytest --noconftest tests/test_torch_surfel.py``.
"""

import json
import math

import numpy as np
import pytest
import torch

import reference_surfel as ref
from gaussiansplatting_tpu_torch.config import Config, LossConfig, OptimConfig, RasterConfig
from gaussiansplatting_tpu_torch.core import gaussians as TG
from gaussiansplatting_tpu_torch.core.camera import make_camera
from gaussiansplatting_tpu_torch.density import control as tdensity
from gaussiansplatting_tpu_torch.io import ply as tply
from gaussiansplatting_tpu_torch.ops import compose as tcompose
from gaussiansplatting_tpu_torch.ops import losses as tlosses
from gaussiansplatting_tpu_torch.ops import rasterize as trast
from gaussiansplatting_tpu_torch.ops import surfel_blend as sblend
from gaussiansplatting_tpu_torch.ops import surfel_compose as scompose
from gaussiansplatting_tpu_torch.ops import surfel_projection as sproj
from gaussiansplatting_tpu_torch.train import schedule, trainer
from gaussiansplatting_tpu_torch.train import state as tstate
from gaussiansplatting_tpu_torch.utils import tracing

torch.set_num_threads(2)

FIELDS = ref.FIELDS
W, H = 64, 48
POSE = dict(quat=[0.9930, 0.0830, -0.0700, 0.0290], t=[0.25, -0.3, 0.6], fx=76.8, fy=76.8,
            cx=32.0, cy=24.0, width=W, height=H)
RCFG = RasterConfig(primitive="surfel", pair_capacity=1 << 15, pair_block=16)
LAMBDA_DIST, LAMBDA_NORMAL = 100.0, 0.05
LCFG = LossConfig(lambda_dist=LAMBDA_DIST, lambda_normal=LAMBDA_NORMAL)

IMG_ATOL = ALPHA_ATOL = 2e-5
MAP_REL = 1e-5
DIST_ATOL = 2e-6
LOSS_REL = 1e-6
GRAD_REL = 2e-4


def _camera(pose=POSE, device=None):
    return make_camera(pose["quat"], pose["t"], pose["fx"], pose["fy"], pose["cx"], pose["cy"],
                       pose["width"], pose["height"], device=device)


def scene(n=400, seed=3, sh_coeffs=4, device=None):
    """Port surfels in front of POSE (random orientations, scales e^-5.5 to
    e^-2.6, opacities around 0.5) and the reference's float64 dict."""
    g = torch.Generator().manual_seed(seed)
    means = ((torch.rand(n, 3, generator=g) - 0.5) * torch.tensor([1.6, 1.2, 1.0])
             + torch.tensor([0.0, 0.0, 1.5]))
    ls = torch.log(torch.rand(n, 2, generator=g) * 0.07 + 0.004)
    q = torch.randn(n, 4, generator=g)
    q = q / q.norm(dim=-1, keepdim=True)
    ro = torch.randn(n, generator=g)
    sh = torch.randn(n, sh_coeffs, 3, generator=g) * 0.5
    p = TG.GaussianParams(means, ls, q, ro, sh, torch.ones(n, dtype=torch.bool)).to(device)
    d = {f: getattr(p, f).detach().double().cpu() for f in FIELDS}
    d["alive"] = p.alive.cpu().clone()
    return p, d


def _rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _check_frame(fr, rf):
    assert (fr.image.double() - rf.image).abs().max() < IMG_ATOL
    assert (fr.alpha.double() - rf.alpha).abs().max() < ALPHA_ATOL
    assert _rel(fr.depth, rf.depth) < MAP_REL
    assert _rel(fr.normal, rf.normal) < MAP_REL
    assert (fr.dist.double() - rf.dist).abs().max() < DIST_ATOL


def test_frame_maps_match_the_reference():
    """Image, alpha, expected depth, normal and distortion of a 400-surfel
    64 x 48 frame."""
    p, d = scene()
    with torch.no_grad():
        fr = trast.render_surfel(p, _camera(), RCFG)
    assert not bool(fr.aux.overflow) and int(fr.aux.num_pairs) > 400
    rf = ref.render(d, POSE)
    _check_frame(fr, rf)
    # the maps are not trivial: a tenth of the pixels covered, depths and
    # distortions of the surfels' range
    assert float((rf.alpha > 0.5).double().mean()) > 0.1
    assert float(rf.dist.max()) > 1e-4 and float(rf.depth.max()) > 1.0
    # render() gives the surfel frame's image
    with torch.no_grad():
        img, _ = trast.render(p, _camera(), RCFG)
    assert torch.equal(img, fr.image)


def test_loss_and_gradients_match_the_reference():
    """The loss with both regularizers and the gradient of every field and
    of vs_dummy (the screen-space shift the density statistics read)."""
    p, d = scene(seed=4)
    gt = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(5))
    cam = _camera()
    vs = torch.zeros((p.capacity, 2), requires_grad=True)
    fr = trast.render_surfel(p, cam, RCFG, vs)
    rep = tlosses.photometric_loss(fr.image, gt, LCFG)
    reg = tlosses.surfel_regularizers(fr, cam, LCFG)
    grads = torch.autograd.grad(rep.grad_loss + reg.grad_sum,
                                [getattr(p, f) for f in FIELDS] + [vs])
    rf, rl, rg, rvs = ref.render_grad(d, POSE, gt.double(), 0, LAMBDA_DIST, LAMBDA_NORMAL)
    got = float(rep.combined_mean + reg.weighted_mean)
    assert abs(got - float(rl.combined_mean)) / float(rl.combined_mean) < LOSS_REL
    assert abs(float(reg.dist_mean) - float(rl.dist_mean)) < DIST_ATOL
    assert abs(float(reg.normal_mean) - float(rl.normal_mean)) < LOSS_REL
    # both terms weigh in: each moves the loss by more than the tolerance
    assert LAMBDA_DIST * float(rl.dist_mean) > 1e-3 and LAMBDA_NORMAL * float(rl.normal_mean) > 1e-2
    for f, g in zip(FIELDS, grads):
        assert _rel(g, rg[f]) < GRAD_REL, (f, _rel(g, rg[f]))
    assert _rel(grads[-1], rvs) < GRAD_REL


def test_train_step_matches_the_reference():
    """One train_steps step from Adam timestep 15,000: the logged loss, the
    gradient as Adam took it and the parameters after Adam."""
    p, d = scene(seed=6)
    gt = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(7))
    cfg = Config(raster=RCFG, loss=LCFG, optim=OptimConfig(sh_rest_lr=0.0025 / 20))
    st = tstate.create(p)
    st.opt.t = 15_000
    s1, m = trainer.train_steps(st, [_camera()], [gt], cfg, 30_000)
    rs = ref.rsh.init_state(d, t=15_000)
    out, loss, rgrads = ref.step(rs, POSE, gt.double(), 0, 30_000, LAMBDA_DIST, LAMBDA_NORMAL)
    assert abs(float(m.loss[0]) - loss) / loss < LOSS_REL
    for f in FIELDS:
        g_prog = s1.opt.m[f] / (1.0 - cfg.optim.beta1)
        assert _rel(g_prog, rgrads[f].clamp(-0.5, 0.5)) < GRAD_REL, f
        change = getattr(s1.params, f).detach().double() - d[f]
        # Adam's first step moves a coefficient by about its rate whatever
        # its gradient's size, so a gradient near 0 rounded to the other
        # sign moves it the other way (tests/test_torch_sh.py's bar)
        assert _rel(change, out.params[f] - d[f]) < 3e-3, f


def _edge_on(device=None):
    """One surfel seen nearly edge-on: its normal 2 degrees off the camera's
    x axis, so its plane nearly holds the view ray through its centre and
    its image is a line ~0.2 px wide."""
    pose = dict(POSE, quat=[1.0, 0.0, 0.0, 0.0], t=[0.0, 0.0, 0.0])
    half = math.radians(88.0) / 2
    q = torch.tensor([[math.cos(half), 0.0, math.sin(half), 0.0]])
    p = TG.GaussianParams(torch.tensor([[0.0, 0.0, 2.0]]), torch.log(torch.tensor([[0.05, 0.05]])),
                          q, torch.tensor([2.0]), torch.rand(1, 4, 3) * 0.3,
                          torch.ones(1, dtype=torch.bool)).to(device)
    d = {f: getattr(p, f).detach().double().cpu() for f in FIELDS}
    d["alive"] = p.alive.cpu().clone()
    return p, d, pose


def test_edge_on_surfel_takes_the_low_pass():
    """A surfel seen near edge-on projects to a line, and the object-space
    low-pass (eq. 11) keeps it visible around its projected centre: the
    frame matches the reference, whose pixels beside the line are kept by
    the low-pass alone (left out, they are empty)."""
    p, d, pose = _edge_on()
    with torch.no_grad():
        fr = trast.render_surfel(p, _camera(pose), RCFG)
    rf = ref.render(d, pose)
    _check_frame(fr, rf)
    no_lp = ref.render(d, pose, lowpass=False)
    beside = (slice(22, 26), slice(31, 33))   # 0.5 px beside the line, within 2 px of (32, 24)
    assert float(rf.alpha[beside].min()) > 0.05
    assert float(no_lp.alpha[beside].max()) < 1e-6
    # where the low-pass wins the depth is the centre's
    assert torch.allclose(fr.depth[beside].double(), torch.full((4, 2), 2.0, dtype=torch.float64),
                          atol=1e-5)


def test_a_tile_over_several_blocks_composes_the_distortion():
    """Pairs of one tile spread over at least three blocks of 16 lanes: the
    distortion, which compose adds across blocks (A M2 - M1^2 of the
    composed moments), matches the reference's lane-by-lane sum."""
    p, d = scene(n=600, seed=8)
    cam = _camera()
    with torch.no_grad():
        plan = trast._plan_surfel(p, cam, RCFG)
        win = trast._windows(plan.data, plan.ints, plan.pcfg, 0)
        tiles = win.block_tile[win.block_valid > 0]
        per_tile = torch.bincount(tiles.long())
        fr = trast.render_surfel(p, cam, RCFG)
    assert int(per_tile.max()) >= 3
    rf = ref.render(d, POSE)
    _check_frame(fr, rf)


def test_projection_plain_form_matches_the_reference():
    """The projection's plain form (the CPU path and its kernel's oracle):
    T, the normal and the opacity of every emitting surfel against the
    reference's float64, and the culls alike."""
    p, d = scene(seed=9)
    fields = sproj.Fields(p.means.detach(), p.log_scales.detach(), p.quats.detach(),
                          p.raw_opacities.detach(), p.alive)
    color = torch.rand((p.capacity, 3))
    rows, depth, valid = sproj.rows_plain(fields, _camera(), RCFG, color)
    sf = ref.project(d, POSE, 0)
    emit = rows[:, 5] > 0
    assert torch.equal(emit, sf.emit)
    assert torch.equal(depth, rows[:, 0])
    t = rows[emit, 6:15].double()
    assert _rel(t, sf.tmat[emit].reshape(-1, 9)) < 1e-6
    assert _rel(rows[emit, 19:22], sf.normal[emit]) < 1e-6
    assert _rel(rows[emit, 15], sf.opacity[emit]) < 1e-6
    assert bool((rows[~valid] == 0).all())


def _compose_autograd(out, seg, consts):
    """The compose forward written out for autograd, in float64: each
    block's t_in = exp(sum of its tile's earlier S_b), the per-tile sums by
    index_add."""
    ts, tiles_x, tiles_y, width, rows, bg = consts
    nt = tiles_x * tiles_y
    live = seg < nt
    o, t = out[live], seg[live].long()
    s = o[:, 3]
    excl = torch.cumsum(s, 0) - s
    first = torch.searchsorted(t, t, right=False)
    t_in = torch.exp(excl - excl[first])
    lin = o[:, list(scompose.LIN)] * t_in[:, None, :]
    tiles = torch.zeros((nt, len(scompose.LIN), ts * ts), dtype=o.dtype).index_add(0, t, lin)
    trans = torch.exp(torch.zeros((nt, ts * ts), dtype=o.dtype).index_add(0, t, s))
    img = tiles[:, :3] + bg * trans[:, None, :]
    aux = torch.cat([tiles[:, 3:], trans[:, None, :]], 1)
    return tcompose._image(img, consts), tcompose._image(aux, consts)


def test_compose_plain_backward_is_its_forwards_gradient():
    """The compose plain forms against a forward written out for autograd,
    in float64, on a frame's real blend sums: the maps alike, and the
    backward its vector-Jacobian product."""
    p, _ = scene(n=600, seed=10)
    cam = _camera()
    with torch.no_grad():
        plan = trast._plan_surfel(p, cam, RCFG)
        win = trast._windows(plan.data, plan.ints, plan.pcfg, 0)
        out, _ = sblend.surfel_blend_fwd(win.table, win.block_src, win.block_valid, win.tile, 0,
                                         RCFG.pair_block, plan.bconsts)
    consts = trast.compose_consts(cam, RCFG)
    o = out.double().requires_grad_(True)
    g = torch.Generator().manual_seed(1)
    gi = torch.randn((H, W, 3), generator=g, dtype=torch.float64)
    ga = torch.randn((H, W, scompose.AUX), generator=g, dtype=torch.float64)
    with torch.enable_grad():
        img, aux = _compose_autograd(o, win.block_tile, consts)
        (want,) = torch.autograd.grad((img * gi).sum() + (aux * ga).sum(), o)
    pimg, paux = scompose.surfel_compose_fwd_plain(o.detach(), win.block_tile, consts)
    assert _rel(pimg, img) < 1e-14 and _rel(paux, aux) < 1e-14
    got = scompose.surfel_compose_bwd_plain(gi, ga, o.detach(), win.block_tile, consts)
    live = win.block_valid > 0
    assert _rel(got[live], want[live]) < 1e-12


def _split_one(log_scales, quat, r):
    """The two children of one primitive that a density event splits (the
    only live row of a capacity of 4, its gradient statistics far over the
    threshold, its scale over percent_dense x the extent), given the
    event's draw ``r`` [4, 3]: (children's means [2, 3], the parent's)."""
    mean = torch.tensor([[0.1, -0.2, 1.5]])
    p = TG.from_arrays(mean.numpy(), log_scales.numpy(), quat.numpy(), np.zeros(1, np.float32),
                       np.zeros((1, 4, 3), np.float32), capacity=4)
    st = tstate.create(p)
    with torch.no_grad():
        st.accum.grad_accum.fill_(1.0)
        st.accum.grad_count.fill_(1)
    new, _, _, stats = tdensity.apply(st.params, st.opt, st.accum, 1000, r, 1e-3,
                                      torch.tensor(76.8), 2e-3, Config().density)
    assert int(stats.split) == 1 and int(stats.count) == 2
    return new.means.detach()[:2], mean


def test_surfel_split_stays_in_the_disc_plane():
    """A split surfel's children sit in its plane (the draw's third axis has
    a zero std, 2DGS's densify_and_split), mirrored about its centre; a 3D
    Gaussian's split keeps the draw's bits: its offset R (r / |r| * s)."""
    gen = torch.Generator().manual_seed(3)
    for _ in range(4):
        q = torch.randn(1, 4, generator=gen)
        q = q / q.norm()
        r = tdensity.draw_split_offsets(gen, 4, "cpu")
        rot = trast.proj_mod.T.quat_to_rotmat(q)[0]
        kids, mean = _split_one(torch.log(torch.tensor([[0.05, 0.03]])), q, r)
        off = kids - mean
        assert torch.allclose(off[0], -off[1], atol=1e-6) and float(off[0].norm()) > 1e-3
        assert float((off[0] @ rot[:, 2]).abs()) < 1e-6 * float(off[0].norm()) + 1e-7
        kids3, _ = _split_one(torch.log(torch.tensor([[0.05, 0.03, 0.04]])), q, r)
        s3 = torch.tensor([0.05, 0.03, 0.04])
        want = rot @ (r[0] / r[0].norm() * s3)
        assert torch.allclose(kids3[0] - mean[0], want, atol=1e-6)
        assert float((want @ rot[:, 2]).abs()) > 1e-4


def test_ply_round_trip_keeps_two_scales(tmp_path):
    """A surfel cloud writes scale_0 and scale_1 alone and reads back [N, 2]."""
    p, _ = scene(n=50, seed=13, sh_coeffs=16)
    cloud = tply.cloud_from_params(p)
    path = str(tmp_path / "surfels.ply")
    assert tply.export_gaussian_ply(path, cloud) == 50
    header = open(path, "rb").read(2000).split(b"end_header")[0].decode()
    assert "scale_1" in header and "scale_2" not in header
    back = tply.load_gaussian_ply(path)
    assert back.log_scales.shape == (50, 2)
    np.testing.assert_array_equal(back.log_scales, cloud.log_scales)
    np.testing.assert_array_equal(back.sh, cloud.sh)
    q = TG.from_arrays(back.means, back.log_scales, back.quats, back.raw_opacities, back.sh)
    assert TG.primitive_of(q) == "surfel"


@pytest.mark.parametrize("case", ["bf16", "t_floor", "batched", "sharded", "scales", "strip"])
def test_paths_without_surfels_raise(case):
    """The bf16 packed payload, the exact T-floor, the batched step, the
    tile-sharded step and render, a row of three scales and a strip of tile
    rows raise for surfels, naming what they do not take."""
    from gaussiansplatting_tpu_torch.parallel import sharded

    p, _ = scene(n=50, seed=14)
    cam = _camera()
    cfg = Config(raster=RCFG, loss=LCFG)
    gt = torch.zeros((H, W, 3))
    with pytest.raises(ValueError, match={"bf16": "float32 payload", "t_floor": "T-floor",
                                          "batched": "batched step", "sharded": "tile-sharded",
                                          "scales": "two log-scales",
                                          "strip": "strips"}[case]):
        if case == "bf16":
            trast.render_surfel(p, cam, RCFG.replace(payload_dtype="bf16"))
        elif case == "t_floor":
            trast.render_surfel(p, cam, RCFG.replace(t_floor_exact=True))
        elif case == "batched":
            trainer.train_step_batched(tstate.create(p), [cam, cam], [gt, gt], cfg, 100)
        elif case == "sharded":
            sharded.make_sharded_train_step(None, cfg, 100)
        elif case == "scales":
            q = TG.GaussianParams(p.means, torch.cat([p.log_scales, p.log_scales[:, :1]], 1),
                                  p.quats, p.raw_opacities, p.sh, p.alive)
            trast.render_surfel(q, cam, RCFG)
        else:
            trast.render(p, cam, RCFG, tile_rows=(0, 1))


def _marks(monkeypatch):
    seen = []
    real = tracing.mark

    def mark(stage, where):
        seen.append(stage)
        return real(stage, where)

    monkeypatch.setattr(tracing, "mark", mark)
    return seen


def test_step_marks_and_counts_its_frames(monkeypatch):
    """A surfel step marks the frame's stages, then loss, regularizer,
    regularizer_bwd before the gradient, and counts one surfel frame."""
    seen = _marks(monkeypatch)
    p, _ = scene(n=100, seed=15)
    before = tracing.launch_counts()["primitive.surfel"]
    trainer.train_step(tstate.create(p), _camera(), torch.zeros((H, W, 3)),
                       Config(raster=RCFG, loss=LCFG), 100)
    assert tracing.launch_counts()["primitive.surfel"] == before + 1
    assert seen[:7] == ["projection", "pairs", "blend", "compose", "loss", "regularizer",
                        "regularizer_bwd"]
    assert {"blend_bwd", "reduction", "projection_bwd", "adam"} <= set(seen[7:])
    assert "regularizer" in tracing.STAGES and "regularizer_bwd" in tracing.STAGES


def test_regularizer_schedule():
    """2DGS's schedule: the distortion on from iteration 3,000, the normal
    term from 7,000; the training loop's chunks stop at each switch."""
    lc = LCFG
    assert schedule.regularizers_at(lc, 2999) == lc.replace(lambda_dist=0.0, lambda_normal=0.0)
    assert schedule.regularizers_at(lc, 3000) == lc.replace(lambda_normal=0.0)
    assert schedule.regularizers_at(lc, 7000) == lc
    cfg = Config(raster=RCFG, loss=lc)
    assert trainer._steps_until_event(2995, cfg, False, 50, 0, 0) == 5
    assert trainer._steps_until_event(6990, cfg, False, 50, 0, 0) == 10


def test_the_loop_switches_the_regularizers_on(monkeypatch):
    """train_loop trains with the weights of regularizers_at at each step."""
    p, _ = scene(n=50, seed=16)
    seen = []

    def step(st, cam, gt, cfg, total):
        seen.append((int(st.opt.t), cfg.loss.lambda_dist, cfg.loss.lambda_normal))
        st.opt.t += 1
        return st, trainer.StepMetrics(*(torch.zeros(()) for _ in trainer.StepMetrics._fields))

    monkeypatch.setattr(trainer, "train_step", step)
    st = tstate.create(p)
    st.opt.t = 2998
    cfg = Config(raster=RCFG, loss=LCFG)
    cfg = cfg.replace(density=cfg.density.replace(densify_until_iter=0),
                      train=cfg.train.replace(log_interval=1000))
    trainer.train_loop(st, [_camera()] * 4, [torch.zeros((H, W, 3))] * 4, cfg, 1.0, num_epochs=1)
    assert seen == [(2998, 0.0, 0.0), (2999, 0.0, 0.0), (3000, LAMBDA_DIST, 0.0),
                    (3001, LAMBDA_DIST, 0.0)]


def _colmap_scene(tmp_path):
    """A 3-view COLMAP scene (the port's writers), ground truth of a hidden
    surfel cloud rendered by the port."""
    from gaussiansplatting_tpu_torch.io import images as timages
    from gaussiansplatting_tpu_torch.utils import scenegen

    poses = [([1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0]),
             ([1.0, 0.0, 0.0, 0.0], [0.15, 0.0, 0.0]),
             ([0.9987503, 0.0, 0.0499792, 0.0], [-0.1, 0.05, 0.0])]
    sparse, images = tmp_path / "sparse", tmp_path / "images"
    sparse.mkdir()
    images.mkdir()
    scenegen.write_cameras_bin(str(sparse / "cameras.bin"), 76.8, 76.8, 32.0, 32.0, 64, 64)
    scenegen.write_images_bin(str(sparse / "images.bin"),
                              [(q, t, f"v{i}.ppm") for i, (q, t) in enumerate(poses)])
    p, _ = scene(n=60, seed=17)
    scenegen.write_points_bin(str(sparse / "points3D.bin"), p.means.detach().numpy(),
                              np.random.default_rng(1).uniform(0, 1, (60, 3)))
    for i, (q, t) in enumerate(poses):
        cam = make_camera(np.array(q, np.float32), np.array(t, np.float32), 76.8, 76.8, 32.0,
                          32.0, 64, 64)
        with torch.no_grad():
            img = trast.render_surfel(p, cam, RCFG).image
        timages.save_ppm(str(images / f"v{i}.ppm"), img.numpy())
    return tmp_path


def test_train_and_render_tools_take_surfels(tmp_path, monkeypatch):
    """tools/train.py --primitive surfel trains on the CPU (finite steps,
    two scales a row in the PLY it writes) and tools/render.py renders that
    PLY as surfels."""
    from gaussiansplatting_tpu_torch.io import init as tinit
    from gaussiansplatting_tpu_torch.tools import render as render_cli
    from gaussiansplatting_tpu_torch.tools import train as train_cli

    monkeypatch.setattr(tinit, "_knn_dist", lambda pts, q, k: np.full((len(q), k), 0.05))
    root = _colmap_scene(tmp_path)
    cfg = Config(raster=RasterConfig(pair_capacity=4096, pair_block=16),
                 train=Config().train.replace(epochs=2, log_interval=100))
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    out = tmp_path / "out"
    assert train_cli.main(["--colmap", str(root / "sparse"), "--images", str(root / "images"),
                           "--output", str(out / "out.ply"), "--config", str(tmp_path / "cfg.json"),
                           "--capacity", "128", "--metrics", str(out / "metrics.jsonl"),
                           "--primitive", "surfel", "--lambda-dist", "100",
                           "--lambda-normal", "0.05", "--device", "cpu"]) == 0
    steps = [s for s in map(json.loads, open(out / "metrics.jsonl")) if s["event"] == "step"]
    assert len(steps) == 6 and all(np.isfinite(s["loss"]) for s in steps)
    assert tply.load_gaussian_ply(str(out / "out.ply")).log_scales.shape[1] == 2
    before = tracing.launch_counts()["primitive.surfel"]
    assert render_cli.main(["--ply", str(out / "out.ply"), "--output", str(out / "renders"),
                            "--orbit", "2", "--width", "48", "--height", "32",
                            "--pair-capacity", "8192", "--device", "cpu"]) == 0
    assert tracing.launch_counts()["primitive.surfel"] == before + 2


# -- the card


def _kernel_case(device, n=3000, w=160, h=120):
    p, _ = scene(n=n, seed=21, device=device)
    pose = dict(POSE, width=w, height=h, cx=w / 2, cy=h / 2, fx=1.2 * w, fy=1.2 * w)
    return p, _camera(pose, device), RasterConfig(primitive="surfel", pair_capacity=1 << 18,
                                                  pair_block=128)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the surfel kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_projection_kernels_match_the_plain_form_cuda():
    """surfel_project_fwd / _bwd against the plain form on the card: the
    rows' integer columns alike but on a few boundary rows, the float
    columns within 1e-6 of the plain form's in relative norm, the gradients
    within 1e-5 of float64's; two launches give the same bits."""
    cuda_device = _cuda()
    p, cam, rc = _kernel_case(cuda_device)
    fields = sproj.Fields(p.means.detach(), p.log_scales.detach(), p.quats.detach(),
                          p.raw_opacities.detach(), p.alive)
    color = torch.rand((p.capacity, 3), device=cuda_device)
    rows, depth = sproj.project_fwd(fields, color, None, cam, rc)
    again, _ = sproj.project_fwd(fields, color, None, cam, rc)
    assert torch.equal(rows, again)
    plain, _, _ = sproj.rows_plain(fields, cam, rc, color)
    same = (rows[:, 1:6] == plain[:, 1:6]).all(-1)
    assert int((~same).sum()) <= max(3, p.capacity // 500)
    assert _rel(rows[same, 6:], plain[same, 6:]) < 1e-6
    g = torch.randn(rows.shape, device=cuda_device)
    grads = sproj.project_bwd(g, fields, color, cam, rc)
    f64 = sproj.Fields(*(x.double() for x in fields[:4]), fields.alive)
    want = sproj.project_bwd_plain(g.double(), f64, color.double(), cam, rc)
    for got, w in zip(grads, want):
        assert _rel(got, w) < 1e-5


@pytest.mark.cuda
def test_blend_and_compose_kernels_match_the_plain_forms_cuda():
    """surfel_blend_fwd / _bwd and surfel_compose_fwd / _bwd against their
    plain forms on the card's own windows: the sums within 1e-5 of the
    plain form's scale, the columns within a relative norm of 1e-5, the
    maps within 1e-6; each backward launched twice for the same bits."""
    cuda_device = _cuda()
    p, cam, rc = _kernel_case(cuda_device)
    with torch.no_grad():
        plan = trast._plan_surfel(p, cam, rc)
        win = trast._windows(plan.data, plan.ints, plan.pcfg, 0)
        args = (win.table, win.block_src, win.block_valid, win.tile, 0, rc.pair_block,
                plan.bconsts)
        out, gid = sblend.surfel_blend_fwd(*args)
        pout, pgid = sblend.surfel_blend_fwd_plain(*args)
        assert torch.equal(gid, pgid)
        assert float((out - pout).abs().max()) < 1e-5 * max(float(pout.abs().max()), 1.0)
        g = torch.randn(out.shape, device=cuda_device)
        d = sblend.surfel_blend_bwd(*args[:6], g, out[:, 3].contiguous(), plan.bconsts)
        assert torch.equal(d, sblend.surfel_blend_bwd(*args[:6], g, out[:, 3].contiguous(),
                                                      plan.bconsts))
    dp = sblend.surfel_blend_bwd_plain(*args[:6], g, plan.bconsts)
    for c in range(sblend.COLS):
        assert _rel(d[c], dp[c]) < 1e-5, c
    consts = trast.compose_consts(cam, rc)
    with torch.no_grad():
        img, aux = scompose.surfel_compose_fwd(out, win.block_tile, consts)
        pimg, paux = scompose.surfel_compose_fwd_plain(out, win.block_tile, consts)
        assert float((img - pimg).abs().max()) < 1e-6 and float((aux - paux).abs().max()) < 1e-6
        gi, ga = torch.randn_like(img), torch.randn_like(aux)
        dk = scompose.surfel_compose_bwd(gi, ga, out, win.block_tile, consts)
        dpl = scompose.surfel_compose_bwd_plain(gi, ga, out, win.block_tile, consts)
        live = win.block_valid > 0
        assert _rel(dk[live], dpl[live]) < 1e-6


@pytest.mark.cuda
def test_step_launches_each_surfel_kernel_once_cuda():
    """A captured surfel step records one launch of each surfel kernel and
    one surfel frame a replay."""
    from gaussiansplatting_tpu_torch.train import graph

    cuda_device = _cuda()
    p, cam, rc = _kernel_case(cuda_device)
    graph.clear()
    gt = torch.rand((cam.height, cam.width, 3), device=cuda_device)
    trainer.train_steps(tstate.create(p), [cam] * 2, [gt] * 2,
                        Config(raster=rc, loss=LCFG), 30_000)
    launches = graph.live()[-1].launches
    graph.clear()
    for k in ("surfel_project_fwd", "surfel_project_bwd", "surfel_blend_fwd", "surfel_blend_bwd",
              "surfel_compose_fwd", "surfel_compose_bwd", "primitive.surfel"):
        assert launches.get(k) == 1, (k, launches)
