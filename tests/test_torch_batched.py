"""The port's tile strips and multi-view batched steps against the JAX
package on the CPU (JAX on its windowed Pallas path, interpret mode):
``render(tile_rows=...)`` in the default and the T-floor mode, the strips
stacked against the full render, ``train_step_batched``, and
``train_loop(batch_views=2)``.

Tolerances: strips against JAX within 2e-5 (the render tests' image bar),
integer pair counts exact, stacked strips against the port's full render
within 2e-5 (measured 0: a strip's tiles get the same blocks as in the full
frame); the batched step at the bars of tests/test_torch_train.py, its
density accumulators included; batched K = 1 is train_step bit for bit.
Batched K = 2 of one view takes its two halves of the loss cotangent
(1/2 each, exact) through one backward and sums them: the parameters come
out bit for bit as train_step's; the Adam moments of the quaternions differ
in their last bits where autograd sums the two views' paths through the
normalization in another order (25 of 192 m entries by <= 3.7e-9, 29 v
entries by <= 2.9e-11, seed 21), held within 1e-6 of the field's max."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussiansplatting_tpu.config import Config as JConfig
from gaussiansplatting_tpu.ops.rasterize import render as jrender
from gaussiansplatting_tpu.train import state as jstate
from gaussiansplatting_tpu.train import trainer as jtrainer

from gaussiansplatting_tpu_torch.config import Config
from gaussiansplatting_tpu_torch.ops.rasterize import render
from gaussiansplatting_tpu_torch.train import schedule as tsched
from gaussiansplatting_tpu_torch.train import state as tstate
from gaussiansplatting_tpu_torch.train import trainer as ttrainer

from conftest import make_camera_for_scene
from test_torch_train import TRAINABLE, _compare_states, _jax_state_arrays
from test_torch_train_loop import _compare_loop_states, _configs, _jax_key_chain, _scene_params
from torch_parity import cameras, configs, scene_params, t2n, to_torch_camera

torch.set_num_threads(1)

IMAGE_ATOL = 2e-5


@pytest.mark.parametrize("t_floor_exact", [False, True], ids=["default", "tfloor"])
def test_strips_match_jax_and_full_render(t_floor_exact):
    """64x64 (4 tile rows) in 2-row strips: each strip against JAX's
    render(tile_rows) with its pair count, the strips stacked against the
    port's full render, and their pair counts summing to the full count."""
    jp, tp = scene_params(31, n=48)
    jc, tc = cameras(64, 64)
    jr, tr = configs(t_floor_exact=t_floor_exact)
    with torch.no_grad():
        full, aux = render(tp, tc, tr)
    strips, total = [], 0
    for row0 in (0, 2):
        want, jaux = jrender(jp, jc, jr, tile_rows=(jnp.int32(row0), 2))
        with torch.no_grad():
            got, taux = render(tp, tc, tr, tile_rows=(row0, 2))
        assert got.shape == (32, 64, 3)
        np.testing.assert_allclose(t2n(got), np.asarray(want), atol=IMAGE_ATOL)
        assert int(taux.num_pairs) == int(jaux.num_pairs) > 0
        assert not bool(taux.overflow)
        strips.append(t2n(got))
        total += int(taux.num_pairs)
    np.testing.assert_allclose(np.concatenate(strips), t2n(full), atol=IMAGE_ATOL)
    assert total == int(aux.num_pairs)


def test_strip_past_the_image_keeps_its_padded_rows():
    """48 px = 3 tile rows in strips of 2: the second strip covers one row
    of padding, background only, with no pairs of its own there."""
    jp, tp = scene_params(32, n=48)
    jc, tc = cameras(64, 48)
    jr, tr = configs()
    with torch.no_grad():
        full, aux = render(tp, tc, tr)
        top, a0 = render(tp, tc, tr, tile_rows=(0, 2))
        bottom, a1 = render(tp, tc, tr, tile_rows=(2, 2))
    want, _ = jrender(jp, jc, jr, tile_rows=(jnp.int32(2), 2))
    np.testing.assert_allclose(t2n(bottom), np.asarray(want), atol=IMAGE_ATOL)
    bg = 1.0 if tr.white_background else 0.0
    assert bottom.shape == (32, 64, 3) and bool((bottom[16:] == bg).all())
    np.testing.assert_allclose(t2n(torch.cat([top, bottom]))[:48], t2n(full), atol=IMAGE_ATOL)
    assert int(a0.num_pairs) + int(a1.num_pairs) == int(aux.num_pairs)


def _two_views():
    """Two 64x48 cameras of one resolution (fov 1.2 and 1.0) and two
    seeded ground truths."""
    jcs = [make_camera_for_scene(64, 48, fov_scale=s) for s in (1.2, 1.0)]
    gts = np.random.default_rng(6).uniform(0, 1, (2, 48, 64, 3)).astype(np.float32)
    return jcs, [to_torch_camera(c) for c in jcs], gts


def test_train_step_batched_matches_jax():
    jp, _ = scene_params(21, n=48)
    jcs, tcs, gts = _two_views()
    jr, tr = configs()
    jcfg, tcfg = JConfig(raster=jr), Config(raster=tr)
    js = jstate.create(jp)
    ts = tstate.state_from_numpy(_jax_state_arrays(js))
    jcams = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jcs)
    js, jm = jtrainer.train_step_batched(js, jcams, jnp.asarray(gts), jcfg, 100)
    ts, tm = ttrainer.train_step_batched(ts, tcs, torch.from_numpy(gts), tcfg, 100)
    assert ts.opt.t == int(js.opt.t) == 1
    for f in ("loss", "l1", "dssim", "psnr"):
        np.testing.assert_allclose(float(getattr(tm, f)), float(getattr(jm, f)), rtol=1e-5,
                                   err_msg=f)
    assert int(tm.num_pairs) == int(jm.num_pairs) > 0 and not bool(tm.overflow)
    # the max over views, not the sum
    with torch.no_grad():
        per_view = [int(render(ts.params, c, tr)[1].num_pairs) for c in tcs]
    assert int(tm.num_pairs) <= 2 * max(per_view)
    lr0 = tsched.learning_rates(tcfg.optim, 0, 100)
    _compare_states(tstate.state_to_numpy(ts), _jax_state_arrays(js), 1,
                    dict(zip(TRAINABLE, lr0)))


def test_batched_one_view_is_train_step():
    """K = 1: every state array bit for bit.  K = 2 of one view: the
    parameters bit for bit, the moments within rounding (module docstring),
    the accumulators counting the view twice."""
    from gaussiansplatting_tpu_torch.config import RasterConfig
    from gaussiansplatting_tpu_torch.utils import synthetic

    cfg = Config(raster=RasterConfig(pair_capacity=2048, pair_block=16))
    p = synthetic.make_scene(48, seed=21, spread=0.6)
    cam = synthetic.make_canonical_camera(64, 48)
    gt = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (48, 64, 3)).astype(np.float32))
    ref, rm = ttrainer.train_step(tstate.create(p), cam, gt, cfg, 100)
    one, om = ttrainer.train_step_batched(tstate.create(p), [cam], [gt], cfg, 100)
    two, wm = ttrainer.train_step_batched(tstate.create(p), [cam, cam], [gt, gt], cfg, 100)
    r, a, b = (tstate.state_to_numpy(s) for s in (ref, one, two))
    for k in r:
        np.testing.assert_array_equal(a[k], r[k], err_msg=f"K=1 {k}")
    for f in ("loss", "l1", "dssim", "psnr", "num_pairs", "mean_opacity"):
        assert float(getattr(om, f)) == float(getattr(rm, f)), f
    for f in ("loss", "l1", "dssim", "num_pairs", "mean_opacity"):
        assert float(getattr(wm, f)) == float(getattr(rm, f)), f
    # the PSNR of the two views' pooled MSE: a mean over twice the pixels
    assert float(wm.psnr) == pytest.approx(float(rm.psnr), rel=1e-6)
    for f in TRAINABLE:
        np.testing.assert_array_equal(b[f"params/{f}"], r[f"params/{f}"], err_msg=f"K=2 {f}")
        for mom in ("m", "v"):
            key = f"opt/{mom}/{f}"
            diff = np.abs(b[key].astype(np.float64) - r[key])
            assert diff.max() <= 1e-6 * np.abs(r[key]).max(), (
                f"{key}: {int((diff > 0).sum())} entries differ, by up to {diff.max():.3e}")
    np.testing.assert_array_equal(b["accum/grad_count"], 2 * r["accum/grad_count"])


def test_train_loop_batched_matches_jax(monkeypatch):
    """batch_views=2 over 3 views (the second group wraps to view 0): the
    same log lines (density counts, the reset, the epoch lines), iteration
    count (2 steps per epoch), `alive` a prefix, and the final state at the
    loop bars of tests/test_torch_train_loop.py."""
    _jax_key_chain(monkeypatch)
    jcs = [make_camera_for_scene(32, 32, fov_scale=s) for s in (1.2, 1.1, 1.0)]
    tcs = [to_torch_camera(c) for c in jcs]
    rng = np.random.default_rng(1234)
    jcfg, tcfg = _configs()
    target = _scene_params(rng, n=16)
    gts = [np.asarray(jax.jit(jrender, static_argnums=2)(target, c, jcfg.raster)[0]) for c in jcs]
    start = _scene_params(rng, n=16, perturb=0.5, capacity=64)
    js = jstate.create(start)
    ts = tstate.state_from_numpy(_jax_state_arrays(js))
    jlogs, tlogs = [], []
    js = jtrainer.train_loop(js, jcs, [jnp.asarray(g) for g in gts], jcfg, scene_extent=5.0,
                             num_epochs=8, log_fn=jlogs.append, batch_views=2)
    ts = ttrainer.train_loop(ts, tcs, [torch.from_numpy(g.copy()) for g in gts], tcfg,
                             scene_extent=5.0, num_epochs=8, log_fn=tlogs.append, batch_views=2)
    assert tlogs == jlogs
    assert sum("densify" in s for s in tlogs) == 3 and any("opacity reset" in s for s in tlogs)
    assert ts.opt.t == int(js.opt.t) == 16
    alive = ts.params.alive.numpy()
    n = int(alive.sum())
    assert alive[:n].all() and not alive[n:].any() and n > 16
    lr0 = tsched.learning_rates(tcfg.optim, 0, 16)
    _compare_loop_states(tstate.state_to_numpy(ts), _jax_state_arrays(js), 16,
                         dict(zip(TRAINABLE, lr0)))


def test_train_loop_batched_requires_one_resolution():
    _, tc = cameras(64, 48)
    _, tc2 = cameras(32, 32)
    _, tcfg = _configs()
    p = tstate.create(scene_params(3, n=16)[1])
    with pytest.raises(ValueError, match="batch_views requires one resolution"):
        ttrainer.train_loop(p, [tc, tc2], [torch.zeros(48, 64, 3), torch.zeros(32, 32, 3)],
                            tcfg, scene_extent=1.0, num_epochs=1, batch_views=2)
