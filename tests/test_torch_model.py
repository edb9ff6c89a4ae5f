"""The port's GaussianModel facade (gaussiansplatting_tpu_torch.models)
against the JAX package's (gaussiansplatting_tpu.models) on the CPU: the
port of tests/test_model.py on the same seeded scenes in both packages.

Tolerances: a render within 2e-5 of the JAX facade's (its Pallas-vs-XLA
bar); ``train`` for 6 epochs at the bars of tests/test_torch_train_loop.py
(integers exact, moments within 5e-4 of the field's largest, parameters
within LOOP_SIGNAL_ATOL where the gradient is above noise and three
learning rates per step elsewhere); a PLY round trip within 1e-3 (as
tests/test_model.py); checkpoints and COLMAP initialisation exact."""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaussiansplatting_tpu.config import Config as JConfig
from gaussiansplatting_tpu.models import GaussianModel as JModel
from gaussiansplatting_tpu.train import state as jstate

from gaussiansplatting_tpu_torch.config import Config
from gaussiansplatting_tpu_torch.models import GaussianModel
from gaussiansplatting_tpu_torch.train import schedule as tsched
from gaussiansplatting_tpu_torch.train import state as tstate

from test_torch_train import TRAINABLE, _jax_state_arrays
from test_torch_train_cli import scene_dir, scipy_knn  # noqa: F401  (fixtures)
from test_torch_train_loop import _compare_loop_states
from torch_parity import cameras, configs, scene_params, t2n

torch.set_num_threads(1)


def _models(seed, **kw):
    jr, tr = configs()
    jp, tp = scene_params(seed, n=48, **kw)
    return (JModel.from_params(jp, JConfig(raster=jr)),
            GaussianModel.from_params(tp, Config(raster=tr), device="cpu"))


def test_render_matches_jax():
    jm, tm = _models(21)
    jc, tc = cameras()
    want, got = jm.render(jc), tm.render(tc)
    assert got.shape == (48, 64, 3) and got.dtype == np.float32
    assert tm.device == torch.device("cpu") and tm.num_gaussians == jm.num_gaussians == 48
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_train_matches_jax():
    jc, tc = cameras()
    gt_j, _ = _models(22)
    gt = gt_j.render(jc)
    jm, tm = _models(23)
    # the same start state in both packages
    tm.state = tstate.state_from_numpy(_jax_state_arrays(jstate.create(jm.params)))
    jlogs, tlogs = [], []
    jm.train([jc], [jnp.asarray(gt)], epochs=6, log_fn=jlogs.append)
    before = float(np.abs(tm.render(tc) - gt).mean())
    assert tm.train([tc], [gt.copy()], epochs=6, log_fn=tlogs.append) is tm
    assert tlogs == jlogs and tm.state.opt.t == int(jm.state.opt.t) == 6
    assert float(np.abs(tm.render(tc) - gt).mean()) < before
    lr0 = tsched.learning_rates(tm.config.optim, 0, 6)
    _compare_loop_states(tstate.state_to_numpy(tm.state), _jax_state_arrays(jm.state), 6,
                         dict(zip(TRAINABLE, lr0)))


def test_train_refuses_devices():
    """devices > 1 shards over a torch.distributed process group; without
    one the facade raises, it does not train on one device instead."""
    _, tm = _models(24)
    jc, tc = cameras()
    with pytest.raises(RuntimeError, match="process group"):
        tm.train([tc], [np.zeros((48, 64, 3), np.float32)], epochs=1, devices=2)
    assert tm.state.opt.t == 0


def test_ply_and_checkpoint_round_trips(tmp_path):
    jm, tm = _models(25)
    _, tc = cameras()
    ply = str(tmp_path / "m.ply")
    assert tm.save_ply(ply) == 48
    reloaded = GaussianModel.from_ply(ply, tm.config, device="cpu")
    np.testing.assert_allclose(reloaded.render(tc), tm.render(tc), atol=1e-3)
    # a checkpoint the JAX facade saved loads here with the same means
    ck = str(tmp_path / "j.npz")
    jm.save_checkpoint(ck)
    resumed = GaussianModel.from_checkpoint(ck, device="cpu")
    np.testing.assert_array_equal(t2n(resumed.params.means), np.asarray(jm.params.means))
    assert resumed.config.raster.pair_capacity == 2048
    # and the port's own
    tck = str(tmp_path / "t.npz")
    tm.save_checkpoint(tck)
    again = GaussianModel.from_checkpoint(tck, device="cpu")
    np.testing.assert_array_equal(t2n(again.params.means), t2n(tm.params.means))
    assert again.state.opt.t == tm.state.opt.t


def test_from_colmap_matches_jax(scene_dir, scipy_knn):  # noqa: F811
    sparse, images = str(scene_dir / "sparse"), str(scene_dir / "images")
    jm = JModel.from_colmap(sparse, capacity=64)
    tm = GaussianModel.from_colmap(sparse, capacity=64, device="cpu")
    assert tm.scene_extent == jm.scene_extent and tm.params.capacity == 64
    for f in ("means", "log_scales", "quats", "raw_opacities", "sh", "alive"):
        np.testing.assert_array_equal(t2n(getattr(tm.params, f)),
                                      np.asarray(getattr(jm.params, f)), err_msg=f)
    model, cams, gts = GaussianModel.from_colmap_scene(sparse, images, capacity=64,
                                                       device="cpu")
    assert model.scene_extent == jm.scene_extent and len(cams) == len(gts) == 3
    np.testing.assert_array_equal(t2n(model.params.means), t2n(tm.params.means))
    assert cams[0].view.device.type == "cpu" and gts[0].shape == (64, 64, 3)


def test_from_params_moves_to_the_device():
    _, tp = scene_params(26, n=8)
    m = GaussianModel.from_params(tp, device="cpu")
    assert m.params is tp           # already there: taken as it is
    # every constructor puts the model on the card unless asked otherwise
    for ctor in (GaussianModel.from_params, GaussianModel.from_ply, GaussianModel.from_colmap,
                 GaussianModel.from_checkpoint, GaussianModel.from_colmap_scene):
        assert inspect.signature(ctor).parameters["device"].default == "cuda", ctor
