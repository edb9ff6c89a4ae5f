"""SH of degree 2 and 3 on the port (Kerbl et al. 2023's colour) against the
float64 plain reference of tests/reference_sh.py: ``sh_eval`` and its
gradients, a frame and its five leaves' gradients, a training step with the
rest bands' learning rate, clone and split of 16-coefficient rows, the
training loop's degree ramp, the stage marks and the frames-by-degree
counter, and degrees 0-1 as they were.  The card's test captures a degree-3
step and sees ``sh`` and ``sh_bwd`` once per replay, in order.

No JAX here: on the machine with the card this file runs alone,
``python -m pytest --noconftest tests/test_torch_sh.py``.
"""

import numpy as np
import pytest
import torch

import reference_sh as ref
from gaussiansplatting_tpu_torch.config import Config, DensityConfig, OptimConfig, RasterConfig
from gaussiansplatting_tpu_torch.core import gaussians as TG
from gaussiansplatting_tpu_torch.core import transforms as T
from gaussiansplatting_tpu_torch.core.camera import make_camera
from gaussiansplatting_tpu_torch.density import control as tdensity
from gaussiansplatting_tpu_torch.io import init as tinit
from gaussiansplatting_tpu_torch.ops import projection as tproj
from gaussiansplatting_tpu_torch.ops import rasterize as trast
from gaussiansplatting_tpu_torch.train import optimizer as topt
from gaussiansplatting_tpu_torch.train import schedule, trainer
from gaussiansplatting_tpu_torch.train import state as tstate
from gaussiansplatting_tpu_torch.utils import synthetic, tracing

torch.set_num_threads(2)

FIELDS = ref.FIELDS
W, H = 64, 48
# a pose turned off the scene's axis, so the view directions span a cone
POSE = dict(quat=[0.9930, 0.0830, -0.0700, 0.0290], t=[0.25, -0.3, 0.6], fx=76.8, fy=76.8,
            cx=32.0, cy=24.0, width=W, height=H)


def _coeffs(n, seed):
    g = torch.Generator().manual_seed(seed)
    sh = torch.randn((n, 16, 3), generator=g, dtype=torch.float64) * 0.3
    dirs = torch.randn((n, 3), generator=g, dtype=torch.float64)
    return sh, dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_eval_matches_the_reference(degree):
    """Values, and gradients in the coefficients and the directions, within
    float32 of the float64 reference; at degree d the reference with the
    bands above d zeroed gives the same."""
    sh64, dirs64 = _coeffs(4000, 7 + degree)
    sh = sh64.float().requires_grad_(True)
    dirs = dirs64.float().requires_grad_(True)
    got = T.sh_eval(sh, dirs, degree)
    w = torch.rand(got.shape, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    g_sh, g_dirs = torch.autograd.grad((got * w.float()).sum(), [sh, dirs], allow_unused=True,
                                       materialize_grads=True)

    sh_r = sh64.clone().requires_grad_(True)
    dirs_r = dirs64.clone().requires_grad_(True)
    want = ref.sh_color(sh_r, dirs_r, degree)
    r_sh, r_dirs = torch.autograd.grad((want * w).sum(), [sh_r, dirs_r], materialize_grads=True)
    assert (got.double() - want).abs().max() < 2e-6
    assert (g_sh.double() - r_sh).abs().max() < 2e-6
    assert (g_dirs.double() - r_dirs).abs().max() < 2e-5 * max(1.0, float(r_dirs.abs().max()))
    zeroed = sh64.clone()
    zeroed[:, (degree + 1) ** 2:] = 0.0
    assert (ref.sh_color(zeroed, dirs64, 3) - want).abs().max() < 1e-12
    # the bands past the degree are not read: no gradient reaches them
    assert not g_sh[:, (degree + 1) ** 2:].any()


def test_sh_colour_gradient_reaches_the_means():
    """projection.sh_color: the direction from the camera's centre to each
    mean carries the gradient to the means, as the reference's does."""
    p = synthetic.make_scene(500, seed=5, spread=0.8, sh_degree=3)
    with torch.no_grad():
        p.sh[:, 1:] = 0.3 * torch.randn(p.sh[:, 1:].shape, generator=torch.Generator().manual_seed(1))
    cam = make_camera(POSE["quat"], POSE["t"], POSE["fx"], POSE["fy"], POSE["cx"], POSE["cy"], W, H)
    w = torch.rand((500, 3), generator=torch.Generator().manual_seed(2))
    got = tproj.sh_color(p, cam, RasterConfig(sh_degree=3))
    (g_means,) = torch.autograd.grad((got * w).sum(), [p.means])
    means = p.means.detach().double().requires_grad_(True)
    eye = ref.camera(POSE)[2]
    rel = means - eye
    want = ref.sh_color(p.sh.detach().double(), rel / torch.linalg.vector_norm(
        rel, dim=-1, keepdim=True), 3)
    (r_means,) = torch.autograd.grad((want * w.double()).sum(), [means])
    assert (got.double() - want).abs().max() < 2e-6
    rel_err = torch.linalg.vector_norm(g_means.double() - r_means) / torch.linalg.vector_norm(r_means)
    assert 0 < float(torch.linalg.vector_norm(r_means)) and rel_err < 1e-4


def test_sh_eval_raises_outside_degrees_0_to_3():
    sh, dirs = _coeffs(8, 1)
    with pytest.raises(ValueError, match="degree 4"):
        T.sh_eval(sh.float(), dirs.float(), 4)
    with pytest.raises(ValueError, match="needs 16 coefficients"):
        T.sh_eval(sh[:, :4].float(), dirs.float(), 3)
    with pytest.raises(ValueError, match="not supported"):
        T.sh_coeffs(4)
    assert [T.sh_coeffs(d) for d in range(4)] == [4, 4, 9, 16]


def _scene(n=2000, seed=11):
    """Port params of SH degree 3 in front of POSE, the rest bands N(0,
    0.3^2) so the colour turns with the view, and the reference's dict."""
    p = synthetic.make_scene(n, seed=seed, spread=0.9, sh_degree=3)
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed)
        p.sh[:, 1:] = 0.3 * torch.randn(p.sh[:, 1:].shape, generator=g)
    d = {f: getattr(p, f).detach().double() for f in FIELDS}
    d["alive"] = p.alive.clone()
    return p, d


def _camera():
    return make_camera(POSE["quat"], POSE["t"], POSE["fx"], POSE["fy"], POSE["cx"], POSE["cy"],
                       W, H)


RCFG = RasterConfig(pair_capacity=1 << 16, pair_block=16, sh_degree=3)


def _rel(a, b):
    return float(torch.linalg.vector_norm(a.double() - b) / torch.linalg.vector_norm(b))


def test_frame_degree_3_matches_the_reference():
    """A 2,000-Gaussian 64 x 48 frame at degree 3: the image, and the
    gradients of all five leaves of a weighted sum of it."""
    p, d = _scene()
    img, aux = trast.render(p, _camera(), RCFG)
    assert not bool(aux.overflow)
    want = ref.render(d, POSE, 3)
    assert (img.double() - want).abs().max() < 2e-5
    w = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    grads = torch.autograd.grad((img * w.float()).sum(), [getattr(p, f) for f in FIELDS])

    class Weighted:
        def __init__(self, im):
            self.grad_loss = (im * w).sum()

    _, _, r = ref.render_grad(d, POSE, 3, Weighted)
    for f, g in zip(FIELDS, grads):
        assert _rel(g, r[f]) < 5e-5, (f, _rel(g, r[f]))
    # the higher bands are trained: their gradient is not zero
    assert float(r["sh"][:, 9:].abs().max()) > 0 and float(grads[4][:, 9:].abs().max()) > 0


def test_train_step_degree_3_matches_the_reference():
    """One train_steps step at degree 3 (the step's Adam timestep 15,000, so
    the position LR is the schedule's there): the loss, the gradient as Adam
    took it, and the parameters after Adam with the rest bands' learning
    rate, 3DGS's sh_lr / 20."""
    p, d = _scene(seed=12)
    oc = OptimConfig(sh_rest_lr=0.0025 / 20)
    cfg = Config(raster=RCFG, optim=oc)
    gt = torch.rand((H, W, 3), generator=torch.Generator().manual_seed(5))
    st = tstate.create(p)
    st.opt.t = 15_000
    s1, m = trainer.train_steps(st, [_camera()], [gt], cfg, 30_000)
    rs = ref.init_state(d, t=15_000)
    out = ref.step(rs, POSE, gt.double(), 3, 30_000)
    assert abs(float(m.loss[0]) - out.loss) / out.loss < 1e-6
    for f in FIELDS:
        g_prog = s1.opt.m[f] / (1.0 - oc.beta1)
        g_ref = out.grads[f].clamp(-0.5, 0.5)
        assert _rel(g_prog, g_ref) < 5e-5, (f, _rel(g_prog, g_ref))
        change = getattr(s1.params, f).detach().double() - d[f]
        want = out.state.params[f] - d[f]
        # Adam's first step moves a coefficient by about its rate whatever
        # its gradient's size: a gradient near 0 that float32 rounds to the
        # other sign moves it the other way (the means read 6e-4)
        assert _rel(change, want) < 3e-3, (f, _rel(change, want))
    # the DC steps at sh_lr, the rest bands at sh_rest_lr: from zero moments
    # at t = 15,000 (bias corrections ~1) Adam moves a coefficient of nonzero
    # gradient by its rate x (1 - beta1) / sqrt(1 - beta2)
    dsh = (s1.params.sh.detach() - p.sh.detach()).abs()
    k = (1 - oc.beta1) / (1 - oc.beta2) ** 0.5
    assert abs(float(dsh[:, 0].max()) / (0.0025 * k) - 1) < 1e-3
    assert abs(float(dsh[:, 1:].max()) / (0.000125 * k) - 1) < 1e-3


def test_sh_rest_lr_defaults_to_sh_lr():
    """Left None, the rest bands step at sh_lr, the path of degrees 0-1 op
    for op; set equal to sh_lr, bit for bit the same."""
    assert OptimConfig().sh_rest_lr is None
    assert "sh_rest_lr" not in Config().to_json()
    assert Config.from_json(Config(optim=OptimConfig(sh_rest_lr=1e-4)).to_json()).optim.sh_rest_lr == 1e-4
    p, _ = _scene(200, seed=3)
    g = {f: torch.randn_like(getattr(p, f)) for f in topt.TRAINABLE}
    a = topt.step(p, g, topt.init_state(p), schedule.learning_rates(OptimConfig(), 0, 100),
                  OptimConfig())[0]
    oc = OptimConfig(sh_rest_lr=OptimConfig().sh_lr)
    b = topt.step(p, g, topt.init_state(p), schedule.learning_rates(oc, 0, 100), oc)[0]
    assert torch.equal(a.sh, b.sh)


def _density_case(k):
    """Eight Gaussians (two pruned, clone and split candidates) in 32 slots
    with SH rows of ``k`` coefficients; every coefficient and its moments
    encode its row: (row + 1) * 10 * (c + 1) + ch."""
    n, cap = 8, 32
    p = TG.zeros(cap, sh_coeffs=k)
    rng = np.random.default_rng(9)
    row = torch.arange(cap, dtype=torch.float32)[:, None, None]
    code = (row + 1) * 10 * (torch.arange(k)[None, :, None] + 1) + torch.arange(3)[None, None, :]
    with torch.no_grad():
        p.means[:n] = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
        p.log_scales[:n] = torch.tensor([-4.0] * 4 + [0.0] * 4)[:, None]
        p.raw_opacities[:n] = 2.0
        p.raw_opacities[2] = -6.0
        p.sh[:n] = code[:n]
        p.alive[:n] = True
    opt = topt.init_state(p)
    opt.m["sh"] = torch.where(p.alive[:, None, None], code, 0.0)
    opt.v["sh"] = 2.0 * opt.m["sh"]
    ga = torch.zeros(cap)
    gc = torch.zeros(cap, dtype=torch.int32)
    ga[[1, 3, 5, 6]], gc[[1, 3, 5, 6]] = 1.0, 1
    acc = tdensity.DensityAccum(ga, gc, torch.zeros((cap, 3)))
    r = torch.rand((cap, 3), generator=torch.Generator().manual_seed(2)) * 2 - 1
    return tdensity.apply(p, opt, acc, 1000, r, 5.0, torch.tensor(100.0), 10.0, DensityConfig())


def test_clone_and_split_carry_16_coefficient_rows():
    """A density event on [C, 16, 3] rows: every field but the SH and its
    moments as on [C, 4, 3] rows, bit for bit, the first four coefficients
    as there, and every row's 16 coefficients and moments moved whole (the
    code of its source row), the split children's moments zero."""
    p4, o4, a4, s4 = _density_case(4)
    p16, o16, a16, s16 = _density_case(16)
    assert int(s16.cloned) > 0 and int(s16.split) > 0 and int(s16.pruned) > 0
    assert [int(x) for x in s16] == [int(x) for x in s4]
    for f in ("means", "log_scales", "quats", "raw_opacities", "alive"):
        assert torch.equal(getattr(p16, f), getattr(p4, f)), f
    assert torch.equal(p16.sh[:, :4], p4.sh)
    for mom in ("m", "v"):
        for f in topt.TRAINABLE:
            got, want = getattr(o16, mom)[f], getattr(o4, mom)[f]
            assert torch.equal(got[:, :4] if f == "sh" else got, want), (mom, f)
    alive = p16.alive
    cplus = (torch.arange(16) + 1)[None, :, None]
    ch = torch.arange(3)[None, None, :]
    sh = p16.sh[alive]
    assert torch.equal(sh, sh[:, :1, :1] * cplus + ch)
    for mom, scale in (("m", 1.0), ("v", 2.0)):
        x = getattr(o16, mom)["sh"][alive]
        zero = (x == 0).flatten(1).all(1)
        assert zero.any() and not zero.all()
        x = x[~zero]
        assert torch.equal(x, x[:, :1, :1] * cplus + scale * ch)


def test_ramp_degree_at():
    """3DGS's ramp: one degree more every 1,000 iterations up to the
    configured one; degrees 0 and 1 have none."""
    assert [schedule.sh_degree_at(3, t) for t in (0, 999, 1000, 2000, 2999, 3000, 20_000)] == \
        [0, 0, 1, 2, 2, 3, 3]
    assert [schedule.sh_degree_at(2, t) for t in (999, 1000, 2000, 3000)] == [0, 1, 2, 2]
    assert [schedule.sh_degree_at(d, 0) for d in (0, 1)] == [0, 1]


def test_the_training_loop_ramps_the_degree(monkeypatch):
    """train_loop at degree 3 (the interval cut to 3 iterations): each step
    renders at the ramp's degree for its iteration, no chunk of scan steps
    spans a change, and a degree-1 loop stays at 1."""
    monkeypatch.setattr(schedule, "SH_DEGREE_INTERVAL", 3)
    seen = []
    real_steps, real_step = trainer.train_steps, trainer.train_step

    def steps(st, cams, gts, cfg, total):
        seen.extend((st.opt.t + i, cfg.raster.sh_degree) for i in range(len(cams)))
        return real_steps(st, cams, gts, cfg, total)

    def step(st, cam, gt, cfg, total):
        seen.append((st.opt.t, cfg.raster.sh_degree))
        return real_step(st, cam, gt, cfg, total)

    monkeypatch.setattr(trainer, "train_steps", steps)
    monkeypatch.setattr(trainer, "train_step", step)
    cam = synthetic.make_canonical_camera(32, 24)
    gt = torch.full((24, 32, 3), 0.5)
    for degree, want in ((3, [min(3, t // 3) for t in range(14)]), (1, [1] * 14)):
        seen.clear()
        p = synthetic.make_scene(40, seed=2, spread=0.5, sh_degree=degree)
        cfg = Config(raster=RasterConfig(pair_capacity=1 << 12, pair_block=16, sh_degree=degree),
                     density=DensityConfig(densify_from_iter=100))
        logs = []
        trainer.train_loop(tstate.create(p), [cam] * 7, [gt] * 7, cfg, 1.0, num_epochs=2,
                           scan_steps=2, log_fn=logs.append)
        assert [d for _, d in sorted(seen)] == want, seen
        assert [t for t, _ in sorted(seen)] == list(range(14))
        assert sum("SH degree" in line for line in logs) == (3 if degree == 3 else 0)


def _marks(monkeypatch):
    got = []
    real = tracing.mark

    def mark(stage, where):
        got.append(stage)
        real(stage, where)
    monkeypatch.setattr(tracing, "mark", mark)
    return got


@pytest.mark.parametrize("degree", [0, 1])
def test_degrees_0_and_1_keep_their_row_marks_and_counts(degree, monkeypatch):
    """Degrees 0 and 1 build the [C, 4, 3] row everywhere, render with the
    marks of before (no ``sh``) and count no frame by degree."""
    p = synthetic.make_scene(60, seed=1, spread=0.5, sh_degree=degree)
    assert p.sh.shape == (60, 4, 3) and TG.zeros(5).sh.shape == (5, 4, 3)
    cloud = tinit.gaussians_from_points(np.random.default_rng(0).normal(size=(30, 3)),
                                        np.full((30, 3), 0.5), 2.0, sh_degree=degree)
    assert cloud.sh.shape == (30, 4, 3)
    marks = _marks(monkeypatch)
    before = tracing.launch_counts()
    trast.render(p, synthetic.make_canonical_camera(32, 24),
                 RasterConfig(pair_capacity=1 << 12, pair_block=16, sh_degree=degree))
    assert marks == list(tracing.FRAME_STAGES)
    assert tracing.launch_counts() == before


def test_degree_3_marks_and_counts_its_frames(monkeypatch):
    """A frame of a [C, 16, 3] row: ``sh`` before ``projection`` at degrees
    1-3 (none at 0), and one frame counted under its degree."""
    p = synthetic.make_scene(60, seed=1, spread=0.5, sh_degree=3)
    assert p.sh.shape == (60, 16, 3)
    cam = synthetic.make_canonical_camera(32, 24)
    for degree in (0, 1, 3):
        marks = _marks(monkeypatch)
        before = tracing.launch_counts()
        trast.render(p, cam, RasterConfig(pair_capacity=1 << 12, pair_block=16, sh_degree=degree))
        want = list(tracing.FRAME_STAGES)
        assert marks == (["sh"] + want if degree else want)
        after = tracing.launch_counts()
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == \
            {f"sh.degree_{degree}": 1}
        monkeypatch.undo()


def test_trace_tool_prints_the_frames_by_degree(tmp_path, capsys):
    """tools/trace.py at --sh-degree 3 prints the traced steps' frames by
    SH degree (the counter ``sh.degree_counts``), and none at degree 0."""
    from gaussiansplatting_tpu_torch.tools import trace

    args = ["--steps", "2", "--n", "40", "--width", "32", "--height", "32", "--pair-capacity",
            "1024", "--top", "4", "--device", "cpu"]
    assert trace.main(args + ["--out", str(tmp_path / "d3"), "--sh-degree", "3"]) == 0
    assert "sh.degree_counts {'sh.degree_3': 2}" in capsys.readouterr().out
    assert trace.sh_degree_counts(str(tmp_path / "d3")) == {"sh.degree_3": 2}
    assert trace.main(args + ["--out", str(tmp_path / "d0")]) == 0
    assert "sh.degree_counts {}" in capsys.readouterr().out


@pytest.mark.cuda
def test_degree_3_step_marks_in_order_cuda():
    """On the card: a captured degree-3 step replayed twice under a
    CUDA-only profiler shows ``sh`` first and ``sh_bwd`` after
    ``projection_bwd``, once per replay, and each replay counts one frame
    at degree 3."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the step is captured on the card")
    from gaussiansplatting_tpu_torch.train import graph as tgraph

    p = synthetic.make_scene(300, seed=4, device="cuda", sh_degree=3)
    cam = synthetic.make_canonical_camera(64, 48, device="cuda")
    cfg = Config(raster=RasterConfig(pair_capacity=1 << 14, pair_block=16, sh_degree=3))
    st = tstate.create(p)
    gt = torch.zeros(48, 64, 3, device="cuda")
    trainer.train_steps(st, [cam], [gt], cfg, 100)
    torch.cuda.synchronize()
    before = tgraph.launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        trainer.train_steps(st, [cam, cam], [gt, gt], cfg, 100)
        torch.cuda.synchronize()
    assert tgraph.launch_counts()["sh.degree_3"] - before["sh.degree_3"] == 2
    events = sorted((int(e.start_ns()), e.name()) for e in prof.profiler.kineto_results.events()
                    if not str(e.device_type()).endswith("CPU"))
    marks = [n[len(tracing.MARK_PREFIX):] for _, n in events if n.startswith(tracing.MARK_PREFIX)]
    step = (["sh"] + list(tracing.STEP_STAGES[:-1]) + ["sh_bwd", "adam", "end"])
    assert marks == step * 2, marks
    tgraph.clear()
