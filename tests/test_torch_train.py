"""The port's training slice against the JAX package on the CPU: D-SSIM,
photometric loss, PSNR, the Adam step with the reference clip set, the LR
schedule, the density statistics, the TrainState carry-over, one and three
full train steps from one carried-over state, and tools.bench_train.

The step comparison follows one rule.  After a step, Adam moves an element
by about lr * m_hat / sqrt(v_hat), which is about lr * sign(g) while the
moments are young, so an element whose gradient is rounding noise can move
the other way in the other package.  m and v (which hold the clipped
gradients) are compared tightly everywhere; parameters tightly where |m| is
above NOISE_REL of the field's largest |m|, and elsewhere only to the
largest move Adam can make in that many steps."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussiansplatting_tpu.config import Config as JConfig
from gaussiansplatting_tpu.config import DensityConfig as JDensityConfig
from gaussiansplatting_tpu.config import LossConfig as JLossConfig
from gaussiansplatting_tpu.config import OptimConfig as JOptimConfig
from gaussiansplatting_tpu.core import gaussians as JG
from gaussiansplatting_tpu.density import control as jdensity
from gaussiansplatting_tpu.ops import losses as jlosses
from gaussiansplatting_tpu.ops import ssim as jssim
from gaussiansplatting_tpu.train import optimizer as jopt
from gaussiansplatting_tpu.train import schedule as jsched
from gaussiansplatting_tpu.train import state as jstate
from gaussiansplatting_tpu.train import trainer as jtrainer
from gaussiansplatting_tpu.train.checkpoint import _leaf_key

from gaussiansplatting_tpu_torch.config import Config, DensityConfig, LossConfig, OptimConfig
from gaussiansplatting_tpu_torch.core import gaussians as TG
from gaussiansplatting_tpu_torch.density import control as tdensity
from gaussiansplatting_tpu_torch.ops import losses as tlosses
from gaussiansplatting_tpu_torch.ops import ssim as tssim
from gaussiansplatting_tpu_torch.train import optimizer as topt
from gaussiansplatting_tpu_torch.train import schedule as tsched
from gaussiansplatting_tpu_torch.train import state as tstate
from gaussiansplatting_tpu_torch.train import trainer as ttrainer

from torch_parity import cameras, configs, scene_params, t2n

torch.set_num_threads(1)

TRAINABLE = topt.TRAINABLE
NOISE_REL = 1e-3


def _images(seed, h=40, w=56):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("seed", [1, 2])
def test_dssim_map_matches_jax(seed):
    a, b = _images(seed)
    want = np.asarray(jssim.dssim_map(jnp.asarray(a), jnp.asarray(b)))
    got = t2n(tssim.dssim_map(torch.from_numpy(a), torch.from_numpy(b)))
    assert got.shape == (40, 56) and (got > 0).any()
    # float32 band-matrix blurs on both sides, summed in other orders; the
    # variances E[x^2] - mu^2 cancel and are divided by var + C2 >= 9e-4,
    # which amplifies their rounding (measured <= 2.9e-6 on maps ~0.05)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("dssim_in_grad", [True, False])
def test_photometric_loss_and_image_gradient_match_jax(dssim_in_grad):
    a, b = _images(3)
    jcfg = JLossConfig(dssim_in_grad=dssim_in_grad)
    tcfg = LossConfig(dssim_in_grad=dssim_in_grad)
    want = jlosses.photometric_loss(jnp.asarray(a), jnp.asarray(b), jcfg)
    want_g = np.asarray(jax.grad(
        lambda r: jlosses.photometric_loss(r, jnp.asarray(b), jcfg).grad_loss)(jnp.asarray(a)))
    r = torch.from_numpy(a).requires_grad_(True)
    got = tlosses.photometric_loss(r, torch.from_numpy(b), tcfg)
    (got_g,) = torch.autograd.grad(got.grad_loss, r)
    for name in got._fields:
        np.testing.assert_allclose(float(getattr(got, name).detach()), float(getattr(want, name)),
                                   rtol=1e-5, err_msg=name)
    # the gradient of a SUM over pixels: (1-l)/3 sign(diff) per channel plus
    # the D-SSIM term, or sign(diff)/3 alone
    np.testing.assert_allclose(t2n(got_g), want_g, atol=1e-5)
    if not dssim_in_grad:
        np.testing.assert_allclose(np.abs(t2n(got_g)), 1.0 / 3.0, rtol=1e-6)


def test_psnr_matches_jax():
    a, b = _images(4)
    np.testing.assert_allclose(
        float(tlosses.psnr(torch.from_numpy(a), torch.from_numpy(b))),
        float(jlosses.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


def _optimizer_case(seed=5, c=40):
    """Seeded params and two steps' gradients with every special case:
    dead slots, NaN/Inf gradients, a NaN and an out-of-range position, a
    degenerate quaternion, values at the clamps."""
    rng = np.random.default_rng(seed)
    p = {
        "means": rng.normal(0, 1, (c, 3)).astype(np.float32),
        "log_scales": rng.uniform(-4, 4, (c, 3)).astype(np.float32),
        "quats": rng.normal(size=(c, 4)).astype(np.float32),
        "raw_opacities": rng.uniform(-8, 8, (c,)).astype(np.float32),
        "sh": rng.uniform(-2, 2, (c, 4, 3)).astype(np.float32),
        "alive": np.arange(c) < c - 5,
    }
    p["means"][6] = np.nan
    p["means"][7, 1] = 2e6
    p["quats"][8] = [1e-4, 0.0, 0.0, 0.0]
    grads = []
    for k in range(2):
        g = {f: (rng.normal(0, 0.4, p[f].shape) * rng.choice([0.01, 1, 10], p[f].shape)
                 ).astype(np.float32) for f in TRAINABLE}
        g["means"][3, 0] = np.nan
        g["raw_opacities"][4] = np.inf
        g["sh"][5, 1, 2] = np.nan
        g["quats"][8] = [0.0, 0.0, 0.0, 0.0]
        grads.append(g)
    return p, grads


def test_optimizer_step_matches_jax():
    p, grads = _optimizer_case()
    lrs = (0.2, 0.5, 1e-3, 0.3, 0.25)   # position large enough to hit the norm clip
    cfg_j, cfg_t = JOptimConfig(), OptimConfig()
    jp = JG.GaussianParams(**{f: jnp.asarray(v) for f, v in p.items()})
    js = jopt.init_state(jp)
    tp = TG.params_from_numpy(p)
    ts = topt.init_state(tp)
    for g in grads:
        jp, js = jopt.step(jp, {f: jnp.asarray(v) for f, v in g.items()}, js,
                           jopt.LearningRates(*(jnp.float32(x) for x in lrs)), cfg_j)
        tp, ts = topt.step(tp, {f: torch.from_numpy(v) for f, v in g.items()}, ts,
                           topt.LearningRates(*lrs), cfg_t)
    assert ts.t == int(js.t) == 2
    for f in TRAINABLE:
        for name, got, want in (("param", getattr(tp, f), getattr(jp, f)),
                                ("m", ts.m[f], js.m[f]), ("v", ts.v[f], js.v[f])):
            np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=1e-6,
                                       atol=1e-7, equal_nan=True, err_msg=f"{name} {f}")
    got = {f: t2n(getattr(tp, f)) for f in TRAINABLE}
    # skipped Gaussians (NaN/Inf grads, corrupt positions) and dead slots keep
    # their values and zero moments; the degenerate quaternion falls back to
    # identity; the position step is norm-clipped
    for i in (3, 4, 5, 6, 7, 35, 39):
        for f in TRAINABLE:
            np.testing.assert_array_equal(got[f][i], p[f][i])
            assert (t2n(ts.m[f][i]) == 0).all() and (t2n(ts.v[f][i]) == 0).all()
    np.testing.assert_array_equal(got["quats"][8], [1, 0, 0, 0])
    assert np.linalg.norm(got["means"][0] - p["means"][0]) <= 2 * 0.1 + 1e-6


def test_reset_momentum():
    tp = TG.params_from_numpy(_optimizer_case()[0])
    st = topt.init_state(tp)
    st = topt.AdamState(m={f: x + 1 for f, x in st.m.items()},
                        v={f: x + 2 for f, x in st.v.items()}, t=7)
    out = topt.reset_opacity_and_scale_momentum(st)
    for f in TRAINABLE:
        zeroed = f in ("raw_opacities", "log_scales")
        assert bool((out.m[f] == (0 if zeroed else 1)).all())
        assert bool((out.v[f] == (0 if zeroed else 2)).all())
    assert out.t == 7


def test_schedule_matches_jax():
    jcfg, tcfg = JOptimConfig(), OptimConfig()
    for it in (0, 1, 17, 500, 29_999, 30_000, 40_000):
        want = jsched.learning_rates(jcfg, jnp.int32(it), 30_000)
        got = tsched.learning_rates(tcfg, it, 30_000)
        for name in got._fields:
            np.testing.assert_allclose(getattr(got, name), float(getattr(want, name)),
                                       rtol=2e-7, err_msg=f"{name} at {it}")
    assert tsched.exponential_lr_decay(1e-2, 1e-4, 0, 0) == pytest.approx(1e-4)


def test_density_accumulate_matches_jax():
    rng = np.random.default_rng(6)
    c = 30
    start = (rng.uniform(0, 2, c).astype(np.float32), rng.integers(0, 5, c).astype(np.int32),
             rng.normal(size=(c, 3)).astype(np.float32))
    vs = rng.normal(0, 0.5, (c, 2)).astype(np.float32)
    vs[0] = 0.0
    vs[1, 0] = np.nan
    vs[2] = 40.0                       # clipped to viewspace_grad_clip
    pos = rng.normal(size=(c, 3)).astype(np.float32)
    want = jdensity.accumulate(jdensity.DensityAccum(*(jnp.asarray(x) for x in start)),
                               jnp.asarray(vs), jnp.asarray(pos), JDensityConfig())
    got = tdensity.accumulate(tdensity.DensityAccum(*(torch.from_numpy(x) for x in start)),
                              torch.from_numpy(vs), torch.from_numpy(pos), DensityConfig())
    np.testing.assert_allclose(t2n(got.grad_accum), np.asarray(want.grad_accum), rtol=1e-6)
    np.testing.assert_array_equal(t2n(got.grad_count), np.asarray(want.grad_count))
    np.testing.assert_allclose(t2n(got.pos_grad_accum), np.asarray(want.pos_grad_accum),
                               rtol=1e-6)
    assert t2n(got.grad_count)[:2].tolist() == start[1][:2].tolist()
    assert t2n(got.grad_accum)[2] == pytest.approx(start[0][2] + 1.0)


def _jax_state_arrays(js):
    return {_leaf_key(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(js)[0]}


def test_state_carries_over_from_jax():
    jp, _ = scene_params(22, n=20)
    d = _jax_state_arrays(jstate.create(jp))
    ts = tstate.state_from_numpy(d)
    back = tstate.state_to_numpy(ts)
    assert sorted(back) == sorted(k for k in d if k != "key")
    for k, v in back.items():
        assert v.dtype == d[k].dtype, k
        np.testing.assert_array_equal(v, d[k], err_msg=k)
    assert ts.iteration == 0 and isinstance(ts.generator, torch.Generator)


def _compare_states(got, want, steps, lrs):
    for k, w in want.items():
        if k == "key":
            continue
        g = got[k]
        field = k.split("/")[-1]
        if k.startswith("opt/m/") or k.startswith("opt/v/") or k in (
                "accum/grad_accum", "accum/pos_grad_accum"):
            err = np.abs(g - w).max()
            assert err <= 5e-4 * np.abs(w).max(), f"{k}: {err} of {np.abs(w).max()}"
        elif k.startswith("params/") and field in TRAINABLE:
            m = np.abs(want[f"opt/m/{field}"])
            signal = m > NOISE_REL * m.max()
            diff = np.abs(g - w)
            assert diff[signal].max(initial=0.0) <= 1e-5, k
            assert diff.max() <= 3 * steps * lrs[field] + 1e-6, k
        else:                                  # alive, t, grad_count
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax(steps):
    """One and three full train steps (render, D-SSIM loss, gradient, Adam,
    density statistics) from one carried-over TrainState."""
    jp, _ = scene_params(21, n=48)
    jc, tc = cameras()
    jr, tr = configs()
    jcfg, tcfg = JConfig(raster=jr), Config(raster=tr)
    gts = np.random.default_rng(5).uniform(0, 1, (steps, 48, 64, 3)).astype(np.float32)
    js = jstate.create(jp)
    ts = tstate.state_from_numpy(_jax_state_arrays(js))
    jlosses_, jlr = [], []
    for k in range(steps):
        js, jm = jtrainer.train_step(js, jc, jnp.asarray(gts[k]), jcfg, 100)
        jlosses_.append(float(jm.loss))
        jlr.append(float(jm.position_lr))
    if steps == 1:
        ts, tm = ttrainer.train_step(ts, tc, torch.from_numpy(gts[0]), tcfg, 100)
        tm = ttrainer.StepMetrics(*(torch.as_tensor(x).reshape(1) for x in tm))
    else:
        ts, tm = ttrainer.train_steps(ts, [tc] * steps,
                                      [torch.from_numpy(g) for g in gts], tcfg, 100)
    assert tm.loss.shape == (steps,) and ts.opt.t == steps
    np.testing.assert_allclose(t2n(tm.loss), jlosses_, rtol=1e-5)
    np.testing.assert_allclose(t2n(tm.position_lr), jlr, rtol=1e-7)
    assert not bool(tm.overflow.any()) and bool((tm.num_pairs > 0).all())
    lr0 = tsched.learning_rates(tcfg.optim, 0, 100)
    _compare_states(tstate.state_to_numpy(ts), _jax_state_arrays(js), steps,
                    dict(zip(TRAINABLE, lr0)))


def test_bench_train_cpu_matches_jax_tool(capsys):
    """The port's bench_train on the CPU at a tiny size: PSNR rises, no
    kernel launches (plain blends), and the JSON line agrees with the JAX
    tool's on the same arguments."""
    from gaussiansplatting_tpu.tools import bench_train as jbench
    from gaussiansplatting_tpu_torch.tools import bench_train as tbench

    args = ["--n", "300", "--views", "2", "--iters", "4", "--width", "64",
            "--height", "48", "--pair-capacity", "8192"]
    assert tbench.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["detail"]
    assert jbench.main(args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["detail"]
    assert got["psnr_end"] > got["psnr_start"]
    assert got["overflow_steps"] == 0 and got["device"] == "cpu"
    assert got["blend_fwd_launches"] == got["blend_bwd_launches"] == 0
    for k in ("psnr_start", "psnr_end"):
        assert abs(got[k] - want[k]) <= 0.02, k


def test_bench_train_refuses_missing_cuda(monkeypatch):
    from gaussiansplatting_tpu_torch.tools import bench_train as tbench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tbench.main(["--n", "10", "--iters", "2"])
