"""The compiled dispatch of the port's train step and batched train step
(train/graph.py, the counterpart of jax.jit, of the lax.scan program of
train_steps and of jax.jit(train_step_batched)) and what it rests on, on
the CPU: the per-step scalars as a table and as device tensors, the
graphs' keys, Camera.copy_, the naming of a failed capture's op, the launch
counters a replay adds to, train_steps against JAX's scanned train_steps,
train_loop's chunks across a density event, and the batched step with its
scalars as a device tensor.  On the CPU the eager bodies run (the caller
asked for the CPU); the capture and the replays run on the card (the
cuda-marked tests here, and chip_smoke.py phases 12 and 13 at full size).

Tolerances: the scalar table and the tensor-scalar steps (single and
batched) equal the float forms bit for bit (the CPU divides a float32
tensor by a 0-d tensor and by a Python float alike); train_steps and
consecutive batched steps against JAX at tests/test_torch_train.py's bars
(tests/test_torch_batched.py's for the batched metrics: rtol 1e-5);
chunked against single steps bit for bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussiansplatting_tpu.config import Config as JConfig
from gaussiansplatting_tpu.train import state as jstate
from gaussiansplatting_tpu.train import trainer as jtrainer

from gaussiansplatting_tpu_torch.config import Config, OptimConfig
from gaussiansplatting_tpu_torch.core import camera as tcam
from gaussiansplatting_tpu_torch.density import control as tdensity
from gaussiansplatting_tpu_torch.ops import rasterize as traster
from gaussiansplatting_tpu_torch.ops.losses import photometric_loss
from gaussiansplatting_tpu_torch.train import graph as tgraph
from gaussiansplatting_tpu_torch.train import optimizer as topt
from gaussiansplatting_tpu_torch.train import schedule as tsched
from gaussiansplatting_tpu_torch.train import state as tstate
from gaussiansplatting_tpu_torch.train import trainer as ttrainer
from gaussiansplatting_tpu_torch.utils import tracing

from test_torch_train import TRAINABLE, _compare_states, _jax_state_arrays
from test_torch_train_loop import OPTIM, _configs, _setup
from torch_parity import cameras, configs, scene_params, t2n

torch.set_num_threads(1)


def _bits(x):
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


@pytest.mark.parametrize("total_iters", [7, 100])
def test_step_scalars_match_the_float_forms(total_iters):
    """Each row of step_scalars is the position LR of learning_rates and
    _bc's bias corrections at the next timestep, bit for bit, before, at
    and past total_iters; a table of k rows is k tables of one."""
    cfg = OptimConfig(**OPTIM)
    span = 3 * total_iters + 1
    table = tsched.step_scalars(cfg, 0, span, total_iters)
    assert table.shape == (span, 3) and table.dtype == np.float32
    for t in range(span):
        want = np.array([tsched.learning_rates(cfg, t, total_iters).position,
                         topt._bc(cfg.beta1, t + 1), topt._bc(cfg.beta2, t + 1)], np.float32)
        np.testing.assert_array_equal(_bits(table[t]), _bits(want), err_msg=f"t {t}")
        np.testing.assert_array_equal(
            _bits(tsched.step_scalars(cfg, t, 1, total_iters)[0]), _bits(want))
    assert table[total_iters, 0] == table[-1, 0] == np.float32(cfg.position_lr_final)


def _float_scalar_step(state, cam, gt, cfg, total_iters):
    """The step with its changing scalars as Python floats (learning_rates
    and _bc), the form before they became device tensors."""
    params = state.params
    trainable = [getattr(params, f) for f in TRAINABLE]
    vs_zero = torch.zeros((params.capacity, 2), requires_grad=True)
    with torch.enable_grad():
        img, aux = traster.render(params, cam, cfg.raster, vs_dummy=vs_zero)
        rep = photometric_loss(img, gt, cfg.loss)
        *grads, vs_grad = torch.autograd.grad(rep.grad_loss, trainable + [vs_zero])
    grad = dict(zip(TRAINABLE, grads))
    lrs = tsched.learning_rates(cfg.optim, state.opt.t, total_iters)
    new_params, new_opt = topt.step(params, grad, state.opt, lrs, cfg.optim)
    accum = tdensity.accumulate(state.accum, vs_grad, grad["means"], cfg.density)
    return (tstate.TrainState(new_params, new_opt, accum, state.generator),
            rep.combined_mean.detach(), lrs.position)


def test_tensor_scalar_steps_equal_float_scalar_steps():
    """Five CPU steps with a decaying position LR: train_steps (scalars as
    0-d tensors) against the float-scalar step, every state array, loss and
    LR bit for bit; no graph is captured on the CPU."""
    _, tp = scene_params(21, n=48)
    _, tc = cameras()
    _, tr = configs()
    cfg = Config(raster=tr, optim=OptimConfig(**OPTIM))
    gts = [torch.from_numpy(g) for g in np.random.default_rng(5).uniform(
        0, 1, (5, 48, 64, 3)).astype(np.float32)]
    captures = tgraph.counts["captures"]
    got, gm = ttrainer.train_steps(tstate.create(tp), [tc] * 5, gts, cfg, 5)
    want = tstate.create(tp)
    losses, lrs = [], []
    for gt in gts:
        want, loss, lr = _float_scalar_step(want, tc, gt, cfg, 5)
        losses.append(float(loss))
        lrs.append(lr)
    assert got.opt.t == want.opt.t == 5
    a, b = tstate.state_to_numpy(got), tstate.state_to_numpy(want)
    for key in b:
        np.testing.assert_array_equal(_bits(a[key]), _bits(b[key]), err_msg=key)
    np.testing.assert_array_equal(_bits(t2n(gm.loss)), _bits(np.float32(losses)))
    np.testing.assert_array_equal(_bits(t2n(gm.position_lr)), _bits(np.float32(lrs)))
    assert len(set(lrs)) == 5
    assert tgraph.counts["captures"] == captures and not tgraph.live()


def _moved(cam, dx):
    return tcam.make_camera(np.array([1.0, 0.0, 0.0, 0.0], np.float32),
                            np.array([dx, 0.0, 0.0], np.float32), float(cam.fx),
                            float(cam.fy), cam.width / 2.0, cam.height / 2.0,
                            cam.width, cam.height)


@pytest.mark.parametrize("change", ["capacity", "pair_capacity", "resolution", "config",
                                    "sh_width", "inputs"])
def test_step_key(change):
    """The key changes with the capacity, the pair capacity, W/H, the
    Config and the SH width, not with the pose, the ground truth, t or
    total_iters (none of which it reads)."""
    _, tp = scene_params(21, n=48)
    _, tc = cameras()
    cfg = Config(raster=configs()[1])
    st = tstate.create(tp)
    key = tgraph.step_key(st, tc, cfg)
    if change == "capacity":
        other = tgraph.step_key(tstate.grow(st, 64), tc, cfg)
    elif change == "pair_capacity":
        other = tgraph.step_key(st, tc, cfg.replace(raster=cfg.raster.replace(
            pair_capacity=2 * cfg.raster.pair_capacity)))
    elif change == "resolution":
        other = tgraph.step_key(st, cameras(64, 32)[1], cfg)
    elif change == "config":
        other = tgraph.step_key(st, tc, cfg.replace(optim=OptimConfig(**OPTIM)))
    elif change == "sh_width":
        other = tgraph.step_key(tstate.create(_sh0(tp)), tc, cfg)
    else:
        stepped, _ = ttrainer.train_step(st, tc, torch.rand(48, 64, 3), cfg, 100)
        assert stepped.opt.t == 1
        other = tgraph.step_key(stepped, _moved(tc, 0.05), cfg)
    assert (other == key) == (change == "inputs")


def _sh0(params):
    """``params`` with only the SH DC band: another SH width at the same
    capacity."""
    from gaussiansplatting_tpu_torch.core.gaussians import GaussianParams

    return GaussianParams(params.means.detach(), params.log_scales.detach(),
                          params.quats.detach(), params.raw_opacities.detach(),
                          params.sh.detach()[:, :1].clone(), params.alive)


def test_camera_copy_round_trips():
    """copy_ writes another view into a camera's own tensors (a clone's,
    here) and back; another resolution is refused."""
    _, a = cameras()
    b = _moved(a, 0.3)
    c = a.clone()
    assert c.copy_(b) is c
    for f in tcam.TENSOR_FIELDS:
        assert torch.equal(getattr(c, f), getattr(b, f)), f
        assert getattr(c, f).data_ptr() != getattr(b, f).data_ptr()
        assert not torch.equal(getattr(a, f), getattr(b, f)) or f in ("proj", "fx", "fy")
    c.copy_(a)
    for f in tcam.TENSOR_FIELDS:
        assert torch.equal(getattr(c, f), getattr(a, f)), f
    with pytest.raises(ValueError, match="64x32 into 64x48"):
        c.copy_(cameras(64, 32)[1])


def test_capture_failure_names_the_op():
    """A capture that fails names the innermost line of the port it failed
    at (StepGraph re-raises with it)."""
    _, tc = cameras()
    try:
        traster.render(None, tc, configs()[1], tile_rows=(-1, 1))
    except ValueError as e:
        where = tgraph._where(e)
    assert "ops/rasterize.py" in where and "raise ValueError" in where


def test_add_launches_round_trips():
    """The launch counters a replay adds to, by name (utils/tracing.py's
    registry, which graph.launch_counts reads)."""
    before = tracing.launch_counts()
    assert {n for n in before if n.startswith("windowed_blend_")} == {
        f"windowed_blend_{d}{m}" for d in ("fwd", "bwd") for m in ("", "_tf", "_packed")}
    tracing.add_launches({"windowed_blend_fwd": 3, "windowed_blend_bwd_packed": 2})
    after = tracing.launch_counts()
    assert after["windowed_blend_fwd"] == before["windowed_blend_fwd"] + 3
    assert after["windowed_blend_bwd_packed"] == before["windowed_blend_bwd_packed"] + 2
    tracing.add_launches({k: before[k] - after[k] for k in before})
    assert tracing.launch_counts() == before


def test_train_steps_match_jax_scan():
    """train_steps of three views on the CPU against JAX's train_steps, the
    lax.scan program, at tests/test_torch_train.py's bars."""
    jp, tp = scene_params(21, n=48)
    jc, tc = cameras()
    jr, tr = configs()
    steps = 3
    gts = np.random.default_rng(6).uniform(0, 1, (steps, 48, 64, 3)).astype(np.float32)
    js = jstate.create(jp)
    ts = tstate.state_from_numpy(_jax_state_arrays(js))
    jcams = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *([jc] * steps))
    js, jm = jtrainer.train_steps(js, jcams, jnp.asarray(gts), JConfig(raster=jr), 100)
    ts, tm = ttrainer.train_steps(ts, [tc] * steps, [torch.from_numpy(g) for g in gts],
                                  Config(raster=tr), 100)
    assert ts.opt.t == int(js.opt.t) == steps
    np.testing.assert_allclose(t2n(tm.loss), np.asarray(jm.loss), rtol=1e-5)
    np.testing.assert_allclose(t2n(tm.position_lr), np.asarray(jm.position_lr), rtol=1e-7)
    np.testing.assert_array_equal(t2n(tm.num_pairs), np.asarray(jm.num_pairs))
    lr0 = tsched.learning_rates(Config().optim, 0, 100)
    _compare_states(tstate.state_to_numpy(ts), _jax_state_arrays(js), steps,
                    dict(zip(TRAINABLE, lr0)))


def test_scan_steps_4_equal_single_steps_across_densify():
    """train_loop with chunks of 4 (5 views, densify every 5: each chunk
    starts from the state a density event made) against single steps: the
    same bits, metrics and event lines."""
    _, tc, gt, start = _setup()
    _, tcfg = _configs()
    runs = []
    for k in (4, 1):
        logs, metrics = [], []
        st = ttrainer.train_loop(
            tstate.state_from_numpy(_jax_state_arrays(jstate.create(start))),
            [tc] * 5, [torch.from_numpy(gt.copy())] * 5, tcfg, scene_extent=5.0,
            num_epochs=3, log_fn=logs.append,
            metrics_fn=lambda it, m: metrics.append(
                (it, *(_bits(t2n(x)).tobytes() for x in m))),
            scan_steps=k)
        runs.append((tstate.state_to_numpy(st), [s for s in logs if s.startswith("iter ")],
                     metrics))
    (a, ea, ma), (b, eb, mb) = runs
    assert ea == eb and sum("densify" in s for s in ea) == 3
    assert ma == mb and [m[0] for m in ma] == list(range(1, 16))
    for key in a:
        np.testing.assert_array_equal(_bits(a[key]), _bits(b[key]), err_msg=key)


def _cuda_case(n=300, size=(64, 48), k=3):
    from gaussiansplatting_tpu_torch.utils import synthetic

    params = synthetic.make_scene(n, seed=4, device="cuda")
    cams = [_moved(synthetic.make_canonical_camera(*size), 0.01 * i).to("cuda")
            for i in range(k)]
    gts = [torch.rand(size[1], size[0], 3, device="cuda") for _ in range(k)]
    cfg = Config(raster=configs(pair_capacity=1 << 14)[1])
    return tstate.create(params), cams, gts, cfg


@pytest.mark.cuda
def test_graph_replays_equal_eager_steps_cuda():
    """On the card: K replays of the captured step and train_step (K = 1)
    against the eager steps from one state, bit for bit; the kernels'
    launches counted once per replay; a new key captures anew."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the step graph is captured on the card")
    st0, cams, gts, cfg = _cuda_case()
    captures = tgraph.counts["captures"]
    before = tracing.launch_counts()
    got, gm = ttrainer.train_steps(st0, cams, gts, cfg, 100)
    torch.cuda.synchronize()
    counts = tracing.launch_counts()
    assert tgraph.counts["captures"] == captures + 1
    warm = tgraph.WARMUP_STEPS
    assert counts["windowed_blend_fwd"] - before["windowed_blend_fwd"] == len(cams) + warm
    want, ms = st0, []
    for cam, gt in zip(cams, gts):
        want, m = ttrainer.train_step_eager(want, cam, gt, cfg, 100)
        ms.append(m)
    a, b = tstate.state_to_numpy(got), tstate.state_to_numpy(want)
    for key in b:
        np.testing.assert_array_equal(_bits(a[key]), _bits(b[key]), err_msg=key)
    for f, x in zip(gm._fields, gm):
        assert torch.equal(x, torch.stack([getattr(m, f) for m in ms])), f
    one, m1 = ttrainer.train_step(st0, cams[0], gts[0], cfg, 100)
    ref, r1 = ttrainer.train_step_eager(st0, cams[0], gts[0], cfg, 100)
    assert all(torch.equal(x, y) for x, y in zip(tgraph.state_tensors(one),
                                                 tgraph.state_tensors(ref)))
    assert tgraph.counts["captures"] == captures + 1
    ttrainer.train_step(tstate.grow(st0, 512), cams[0], gts[0], cfg, 100)
    assert tgraph.counts["captures"] == captures + 2
    assert len(tgraph.live()) <= tgraph.MAX_GRAPHS
    tgraph.clear()


@pytest.mark.cuda
def test_graph_capture_failure_raises_cuda(monkeypatch):
    """A host sync in the step fails its capture: the error names the op,
    and nothing falls back to eager steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the step graph is captured on the card")
    st0, cams, gts, cfg = _cuda_case(k=1)
    real = ttrainer.step_body

    def syncing(state, camera, gt, c, scalars):
        float(scalars[0])                       # reads the card back to the host
        return real(state, camera, gt, c, scalars)

    monkeypatch.setattr(ttrainer, "step_body", syncing)
    with pytest.raises(RuntimeError, match="capturing the train step failed at"):
        ttrainer.train_steps(st0, cams, gts, cfg, 100)
    tgraph.clear()


# ------------------------------------------------------------ batched step


def _float_scalar_batched_step(state, cams, gts, cfg, total_iters):
    """train_step_batched with its changing scalars as Python floats
    (learning_rates and _bc), the form before they became a device tensor
    read by the body."""
    k = len(cams)
    grad, vs_grad, pos_grad, reps, _, _ = ttrainer.batched_view_grads(
        state.params, cams, gts, cfg)
    lrs = tsched.learning_rates(cfg.optim, state.opt.t, total_iters)
    new_params, new_opt = topt.step(state.params, grad, state.opt, lrs, cfg.optim)
    accum = state.accum
    for v in range(k):
        accum = tdensity.accumulate(accum, vs_grad[v] * k, pos_grad[v] * k, cfg.density)
    loss = torch.stack([r.combined_mean for r in reps]).detach().mean()
    return tstate.TrainState(new_params, new_opt, accum, state.generator), loss, lrs.position


@pytest.mark.parametrize("k", [1, 2])
def test_batched_tensor_scalar_steps_equal_float_scalar_steps(k):
    """Three CPU batched steps of K views with a decaying position LR:
    train_step_batched (batched_update given device_scalars' row as 0-d
    tensors) against the float-scalar form, every state array, loss and LR
    bit for bit; no graph is captured on the CPU."""
    _, tp = scene_params(21, n=48)
    cams = [_moved(cameras()[1], 0.02 * v) for v in range(k)]
    cfg = Config(raster=configs()[1], optim=OptimConfig(**OPTIM))
    gts = torch.from_numpy(np.random.default_rng(7).uniform(
        0, 1, (3, k, 48, 64, 3)).astype(np.float32))
    captures = tgraph.counts["captures"]
    got, want = tstate.create(tp), tstate.create(tp)
    lrs = []
    for gt in gts:
        got, gm = ttrainer.train_step_batched(got, cams, gt, cfg, 3)
        want, loss, lr = _float_scalar_batched_step(want, cams, gt, cfg, 3)
        np.testing.assert_array_equal(_bits(t2n(gm.loss)), _bits(t2n(loss)))
        np.testing.assert_array_equal(_bits(t2n(gm.position_lr)), _bits(np.float32(lr)))
        lrs.append(lr)
    assert got.opt.t == want.opt.t == 3 and len(set(lrs)) == 3
    a, b = tstate.state_to_numpy(got), tstate.state_to_numpy(want)
    for key in b:
        np.testing.assert_array_equal(_bits(a[key]), _bits(b[key]), err_msg=key)
    assert tgraph.counts["captures"] == captures and not tgraph.live()


def test_consecutive_batched_steps_match_jax():
    """Two batched steps of two views on the CPU (the second reads the
    scalars at t = 1) against JAX's jitted train_step_batched, at
    tests/test_torch_batched.py's bars."""
    from gaussiansplatting_tpu.config import OptimConfig as JOptimConfig
    from test_torch_batched import _two_views

    jp, _ = scene_params(21, n=48)
    jcs, tcs, gts = _two_views()
    jr, tr = configs()
    jcfg = JConfig(raster=jr, optim=JOptimConfig(**OPTIM))
    tcfg = Config(raster=tr, optim=OptimConfig(**OPTIM))
    js = jstate.create(jp)
    ts = tstate.state_from_numpy(_jax_state_arrays(js))
    jcams = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jcs)
    for step in range(2):
        g = gts[::-1] if step else gts
        js, jm = jtrainer.train_step_batched(js, jcams, jnp.asarray(g), jcfg, 4)
        ts, tm = ttrainer.train_step_batched(ts, tcs, torch.from_numpy(g.copy()), tcfg, 4)
        for f in ("loss", "l1", "dssim", "psnr", "position_lr"):
            np.testing.assert_allclose(float(getattr(tm, f)), float(getattr(jm, f)),
                                       rtol=1e-5, err_msg=f"step {step} {f}")
        assert int(tm.num_pairs) == int(jm.num_pairs) > 0 and not bool(tm.overflow)
    assert ts.opt.t == int(js.opt.t) == 2
    lr0 = tsched.learning_rates(tcfg.optim, 0, 4)
    _compare_states(tstate.state_to_numpy(ts), _jax_state_arrays(js), 2,
                    dict(zip(TRAINABLE, lr0)))


@pytest.mark.parametrize("change", ["views", "body", "capacity", "resolution", "config",
                                    "inputs"])
def test_batched_key(change):
    """The batched step's cache key changes with K, the body (the
    single-view step at K = 1 is another graph), the capacity, W/H and the
    Config, not with the poses, ground truths, t or total_iters."""
    _, tp = scene_params(21, n=48)
    _, tc = cameras()
    cfg = Config(raster=configs()[1])
    st = tstate.create(tp)
    body = ttrainer.batched_body
    key = tgraph.graph_key(body, 2, st, tc, cfg)
    if change == "views":
        others = [tgraph.graph_key(body, k, st, tc, cfg) for k in (1, 4)]
    elif change == "body":
        others = [tgraph.graph_key(ttrainer.step_body, None, st, tc, cfg),
                  tgraph.graph_key(ttrainer.step_body, 2, st, tc, cfg)]
        assert tgraph.graph_key(body, 1, st, tc, cfg) != others[0]
    elif change == "capacity":
        others = [tgraph.graph_key(body, 2, tstate.grow(st, 64), tc, cfg)]
    elif change == "resolution":
        others = [tgraph.graph_key(body, 2, st, cameras(64, 32)[1], cfg)]
    elif change == "config":
        others = [tgraph.graph_key(body, 2, st, tc, cfg.replace(optim=OptimConfig(**OPTIM))),
                  tgraph.graph_key(body, 2, st, tc, cfg.replace(
                      raster=cfg.raster.replace(pair_capacity=4096)))]
    else:
        stepped, _ = ttrainer.train_step_batched(st, [tc, tc], torch.rand(2, 48, 64, 3),
                                                 cfg, 100)
        assert stepped.opt.t == 1
        others = [tgraph.graph_key(body, 2, stepped, _moved(tc, 0.05), cfg)]
    assert all((other == key) == (change == "inputs") for other in others)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2])
def test_batched_replays_equal_eager_steps_cuda(k):
    """On the card: two replays of the captured batched step (K views
    each) against two eager batched steps from one state, bit for bit,
    each kernel launched K times per replay; at K = 1 the replay equals a
    train_step replay too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the batched step graph is captured on the card")
    st0, cams, gts, cfg = _cuda_case(k=k)
    captures = tgraph.counts["captures"]
    got, want = st0, st0
    for _ in range(2):
        before = tracing.launch_counts()
        got, gm = ttrainer.train_step_batched(got, cams, gts, cfg, 100)
        torch.cuda.synchronize()
        after = tracing.launch_counts()
        want, wm = ttrainer.train_step_batched_eager(want, cams, gts, cfg, 100)
        assert all(torch.equal(x, y) for x, y in zip(gm, wm))
    assert tgraph.counts["captures"] == captures + 1
    assert after["windowed_blend_fwd"] - before["windowed_blend_fwd"] == k
    assert after["windowed_blend_bwd"] - before["windowed_blend_bwd"] == k
    assert all(torch.equal(x, y) for x, y in zip(tgraph.state_tensors(got),
                                                 tgraph.state_tensors(want)))
    if k == 1:
        one, _ = ttrainer.train_step(st0, cams[0], gts[0], cfg, 100)
        batched, _ = ttrainer.train_step_batched(st0, cams, gts, cfg, 100)
        assert all(torch.equal(x, y) for x, y in zip(tgraph.state_tensors(one),
                                                     tgraph.state_tensors(batched)))
    tgraph.clear()
