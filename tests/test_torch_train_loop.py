"""The port's training loop against the JAX package on the CPU: the tiny
densify / reset schedule of tests/test_train_smoke.py (n=16, 32x32,
capacity 64, intervals shrunk, grad_threshold=1e-9 so every event acts),
with the port's split offsets drawn on JAX's key chain; the chunked
dispatch (``scan_steps``) against single steps; the adaptive pair and
Gaussian capacities.

Tolerances: log lines (density counts, rebuckets, the epoch lines with
their rounded loss and PSNR) equal; the final state at the bars of
tests/test_torch_train.py (integers exact, m/v within 5e-4 of the field's
largest, parameters three learning rates per step where the gradient is
noise), except parameters where the gradient is above noise: 1e-5 there is
a bar for one to three steps, and Adam's m/sqrt(v) passes the gradient's
rounding (relative ~1e-6) on at every step, so the 15-step loop is held to
LOOP_SIGNAL_ATOL (measured worst 2.7e-5 after 6 steps, 1.1e-5 after 15);
chunked vs single steps bit for bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussiansplatting_tpu.config import Config as JConfig
from gaussiansplatting_tpu.config import DensityConfig as JDensityConfig
from gaussiansplatting_tpu.config import OptimConfig as JOptimConfig
from gaussiansplatting_tpu.core import gaussians as JG
from gaussiansplatting_tpu.ops.rasterize import render as jrender
from gaussiansplatting_tpu.train import state as jstate
from gaussiansplatting_tpu.train import trainer as jtrainer

from gaussiansplatting_tpu_torch.config import Config, DensityConfig, OptimConfig
from gaussiansplatting_tpu_torch.density import control as tdensity
from gaussiansplatting_tpu_torch.train import schedule as tsched
from gaussiansplatting_tpu_torch.train import state as tstate
from gaussiansplatting_tpu_torch.train import trainer as ttrainer

from conftest import make_scene
from test_torch_train import NOISE_REL, TRAINABLE, _jax_state_arrays
from torch_parity import cameras, configs, to_torch_params

torch.set_num_threads(1)

LOOP_SIGNAL_ATOL = 5e-5

# tests/test_train_smoke.py::_cfg's optimizer
OPTIM = dict(position_lr_init=2e-3, position_lr_final=2e-4, scale_lr=5e-3,
             rotation_lr=1e-3, opacity_lr=0.05, sh_lr=0.01)
# tests/test_train_smoke.py::test_train_loop_with_densify_and_reset's schedule
SCHEDULE = dict(densify_from_iter=2, densify_until_iter=100, densify_interval=5,
                opacity_reset_interval=12, grad_threshold=1e-9)


def _configs(pair_capacity=2048, **density):
    jr, tr = configs(pair_capacity=pair_capacity)
    d = {**SCHEDULE, **density}
    return (JConfig(raster=jr, optim=JOptimConfig(**OPTIM), density=JDensityConfig(**d)),
            Config(raster=tr, optim=OptimConfig(**OPTIM), density=DensityConfig(**d)))


def _scene_params(rng, n=16, perturb=0.0, capacity=None):
    """tests/test_train_smoke.py::_scene_params."""
    means, log_scales, quats, raw_op, sh_dc = make_scene(rng, n=n, spread=0.6)
    if perturb:
        r2 = np.random.default_rng(7)
        sh_dc = sh_dc + r2.normal(0, perturb, sh_dc.shape).astype(np.float32)
        raw_op = raw_op + r2.normal(0, perturb, raw_op.shape).astype(np.float32)
        means = means + r2.normal(0, perturb * 0.05, means.shape).astype(np.float32)
    sh = np.zeros((n, 4, 3), np.float32)
    sh[:, 0, :] = sh_dc
    return JG.from_arrays(means, log_scales, quats, raw_op, sh, capacity=capacity)


def _compare_loop_states(got, want, steps, lrs):
    """tests/test_torch_train.py::_compare_states with LOOP_SIGNAL_ATOL for
    parameters whose gradient is above noise."""
    for k, w in want.items():
        if k == "key":
            continue
        g = got[k]
        field = k.split("/")[-1]
        if k.startswith("opt/") and field in TRAINABLE or k in (
                "accum/grad_accum", "accum/pos_grad_accum"):
            err = np.abs(g - w).max()
            assert err <= 5e-4 * np.abs(w).max(), f"{k}: {err} of {np.abs(w).max()}"
        elif k.startswith("params/") and field in TRAINABLE:
            m = np.abs(want[f"opt/m/{field}"])
            signal = m > NOISE_REL * m.max()
            diff = np.abs(g - w)
            assert diff[signal].max(initial=0.0) <= LOOP_SIGNAL_ATOL, k
            assert diff.max() <= 3 * steps * lrs[field] + 1e-6, k
        else:                                  # alive, t, grad_count
            np.testing.assert_array_equal(g, w, err_msg=k)


def _jax_key_chain(monkeypatch, seed=0):
    """Make the port draw its split offsets as JAX's densify_step does:
    key, sub = split(key); uniform(sub, (C, 3), -1, 1)."""
    key = [jax.random.PRNGKey(seed)]

    def draw(generator, capacity, device):
        key[0], sub = jax.random.split(key[0])
        r = jax.random.uniform(sub, (capacity, 3), jnp.float32, -1.0, 1.0)
        return torch.from_numpy(np.array(r)).to(device)

    monkeypatch.setattr(tdensity, "draw_split_offsets", draw)


def _setup(width=32, height=32, n=16, capacity=64, views=1):
    jc, tc = cameras(width, height)
    rng = np.random.default_rng(1234)
    jcfg, tcfg = _configs()
    gt = np.asarray(jax.jit(jrender, static_argnums=2)(_scene_params(rng, n=n), jc, jcfg.raster)[0])
    start = _scene_params(rng, n=n, perturb=0.5, capacity=capacity)
    return jc, tc, gt, start


def test_train_loop_matches_jax(monkeypatch):
    _jax_key_chain(monkeypatch)
    jc, tc, gt, start = _setup()
    jcfg, tcfg = _configs()
    js = jstate.create(start)
    ts = tstate.state_from_numpy(_jax_state_arrays(js))
    jlogs, tlogs = [], []
    js = jtrainer.train_loop(js, [jc], [jnp.asarray(gt)], jcfg, scene_extent=5.0,
                             num_epochs=15, log_fn=jlogs.append)
    ts = ttrainer.train_loop(ts, [tc], [torch.from_numpy(gt.copy())], tcfg, scene_extent=5.0,
                             num_epochs=15, log_fn=tlogs.append)
    assert tlogs == jlogs
    dens = [s for s in tlogs if "densify" in s]
    assert len(dens) == 3 and any("opacity reset" in s for s in tlogs)
    assert any(" cloned=0 " not in s or " split=0 " not in s for s in dens)
    assert ts.opt.t == int(js.opt.t) == 15
    alive = ts.params.alive.numpy()
    n = int(alive.sum())
    assert alive[:n].all() and not alive[n:].any()
    lr0 = tsched.learning_rates(tcfg.optim, 0, 15)
    _compare_loop_states(tstate.state_to_numpy(ts), _jax_state_arrays(js), 15,
                         dict(zip(TRAINABLE, lr0)))


def test_scan_steps_equal_single_steps():
    """Chunks of 5 steps between events (densify every 5, reset at 12,
    checkpoints every 10) give the same bits, callbacks and event log lines
    as 1 step at a time (the epoch lines follow the chunks, as in JAX)."""
    jc, tc, gt, start = _setup()
    _, tcfg = _configs()
    cams = [tc] * 5
    gts = [torch.from_numpy(gt.copy())] * 5
    runs = []
    for k in (5, 1):
        logs, metrics, ckpts = [], [], []
        st = ttrainer.train_loop(
            tstate.state_from_numpy(_jax_state_arrays(jstate.create(start))),
            cams, gts, tcfg, scene_extent=5.0, num_epochs=4, log_fn=logs.append,
            metrics_fn=lambda it, m: metrics.append((it, float(m.loss), int(m.num_pairs))),
            checkpoint_fn=lambda it, s: ckpts.append(it), checkpoint_interval=10,
            scan_steps=k,
        )
        runs.append((tstate.state_to_numpy(st), logs, metrics, ckpts,
                     st.generator.get_state()))
    (a, la, ma, ca, ga), (b, lb, mb, cb, gb) = runs
    events = [[s for s in logs if s.startswith("iter ")] for logs in (la, lb)]
    assert events[0] == events[1] and len(events[0]) == 5
    assert ma == mb and ca == cb == [10, 20]
    assert [it for it, _, _ in ma] == list(range(1, 21))
    assert torch.equal(ga, gb)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_adaptive_capacity_and_pairs_match_jax(monkeypatch):
    """Adaptive pair capacity (every 2 iters, from 256 up to 4096) and
    adaptive Gaussian capacity (64 -> 128, then held at max_capacity, where
    the clamp drops every request) log the same rebuckets and density
    counts as JAX."""
    _jax_key_chain(monkeypatch)
    jc, tc, gt, start = _setup(width=48, height=32, n=32, capacity=64)
    jcfg, tcfg = _configs(pair_capacity=1 << 12, densify_from_iter=1,
                          densify_until_iter=40, densify_interval=4,
                          opacity_reset_interval=10)
    kw = dict(scene_extent=1.0, num_epochs=3, adaptive_pairs=True, adapt_interval=2,
              min_pair_capacity=256, adaptive_capacity=True, max_capacity=128)
    jlogs, tlogs = [], []
    js = jtrainer.train_loop(jstate.create(start), [jc] * 4, [jnp.asarray(gt)] * 4, jcfg,
                             log_fn=jlogs.append, **kw)
    ts = ttrainer.train_loop(tstate.state_from_numpy(_jax_state_arrays(jstate.create(start))),
                             [tc] * 4, [torch.from_numpy(gt.copy())] * 4, tcfg,
                             log_fn=tlogs.append, **kw)
    assert tlogs == jlogs
    assert any("pair capacity" in s for s in tlogs), tlogs
    assert any(": capacity 64 -> 128" in s for s in tlogs), tlogs
    assert ts.params.capacity == js.params.capacity == 128 and ts.opt.t == 12
