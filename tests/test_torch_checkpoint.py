"""The port's checkpoints against the JAX package's file format on the CPU:
a port checkpoint loads in JAX (every leaf equal, and JAX steps from it), a
JAX checkpoint loads in the port (every leaf equal), a port resume is bit
exact across a density event, and a newer format is refused.  All
comparisons are exact."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussiansplatting_tpu.config import Config as JConfig
from gaussiansplatting_tpu.train import checkpoint as jckpt
from gaussiansplatting_tpu.train import state as jstate
from gaussiansplatting_tpu.train import trainer as jtrainer

from gaussiansplatting_tpu_torch.config import Config, DensityConfig, TrainConfig
from gaussiansplatting_tpu_torch.train import checkpoint as tckpt
from gaussiansplatting_tpu_torch.train import state as tstate
from gaussiansplatting_tpu_torch.train import trainer as ttrainer

from test_torch_train import _jax_state_arrays
from torch_parity import cameras, configs, scene_params

torch.set_num_threads(1)

SEED = 5
# densify from the first iteration, with every Gaussian that saw a gradient
# over the threshold, so one event clones and splits
DENSITY = DensityConfig(densify_from_iter=0, grad_threshold=1e-9)


def _port_state(steps=2):
    """A port TrainState after ``steps`` steps on the seed-24 scene (n=48,
    capacity 96, 64x48), and what it ran with."""
    jp, _ = scene_params(24, n=48)
    arrays = _jax_state_arrays(jstate.create(jp))
    arrays = {k: np.concatenate([v, np.zeros((48,) + v.shape[1:], v.dtype)])
              if v.ndim and v.shape[0] == 48 else v for k, v in arrays.items()}
    arrays["params/quats"][48:, 0] = 1.0
    _, tc = cameras()
    _, tr = configs()
    cfg = Config(raster=tr, density=DENSITY, train=TrainConfig(seed=SEED))
    gts = [torch.from_numpy(np.random.default_rng(k).uniform(0, 1, (48, 64, 3))
                            .astype(np.float32)) for k in range(4)]
    st = tstate.state_from_numpy(arrays, seed=SEED)
    for k in range(steps):
        st, _ = ttrainer.train_step(st, tc, gts[k], cfg, 100)
    return st, tc, gts, cfg


def test_port_checkpoint_loads_in_jax(tmp_path):
    st, _, gts, cfg = _port_state()
    path = str(tmp_path / "port.npz")
    tckpt.save(path, st, cfg)
    js, jcfg = jckpt.load(path)
    assert jcfg.to_json() == cfg.to_json()
    want = tstate.state_to_numpy(st)
    got = _jax_state_arrays(js)
    assert sorted(got) == sorted(list(want) + ["key"])
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    np.testing.assert_array_equal(got["key"], np.asarray(jax.random.PRNGKey(SEED)))
    # JAX takes a step from the loaded state
    jc, _ = cameras()
    jr, _ = configs()
    js2, m = jtrainer.train_step(js, jc, jnp.asarray(gts[2].numpy()), JConfig(raster=jr), 100)
    assert int(js2.opt.t) == 3 and np.isfinite(float(m.loss))


def test_jax_checkpoint_loads_in_port(tmp_path):
    jp, _ = scene_params(25, n=40)
    jc, _ = cameras()
    jr, _ = configs()
    jcfg = JConfig(raster=jr).replace(train=JConfig().train.replace(seed=9))
    js, _ = jtrainer.train_step(jstate.create(jp, seed=9), jc,
                                jnp.asarray(np.random.default_rng(1).uniform(
                                    0, 1, (48, 64, 3)).astype(np.float32)), jcfg, 100)
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, js, jcfg)
    st, cfg = tckpt.load(path, "cpu")
    assert cfg.to_json() == jcfg.to_json()
    want = {k: v for k, v in _jax_state_arrays(js).items() if k != "key"}
    got = tstate.state_to_numpy(st)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # no generator leaf in a JAX file: the port seeds from the saved config
    assert torch.equal(st.generator.get_state(), tstate.make_generator(9).get_state())


def _run_across_event(st, tc, gts, cfg):
    """2 steps, a density event, 1 step."""
    for k in (2, 3):
        st, _ = ttrainer.train_step(st, tc, gts[k], cfg, 100)
    st, stats = ttrainer.densify_step(st, 10.0, tc.fx, cfg)
    st, _ = ttrainer.train_step(st, tc, gts[0], cfg, 100)
    return st, stats


def test_port_resume_is_bit_exact_across_a_density_event(tmp_path):
    st, tc, gts, cfg = _port_state()
    path = str(tmp_path / "resume.npz")
    tckpt.save(path, st, cfg)
    loaded, saved_cfg = tckpt.load(path, "cpu")
    assert saved_cfg == cfg and loaded.opt.t == st.opt.t == 2
    assert torch.equal(loaded.generator.get_state(), st.generator.get_state())
    a, sa = _run_across_event(st, tc, gts, cfg)
    b, sb = _run_across_event(loaded, tc, gts, cfg)
    assert int(sa.cloned) > 0 and int(sa.split) > 0
    assert tuple(map(int, sa)) == tuple(map(int, sb))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    da, db = tstate.state_to_numpy(a), tstate.state_to_numpy(b)
    for k in da:
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)


def test_newer_format_is_refused(tmp_path):
    st, _, _, cfg = _port_state(steps=0)
    path = str(tmp_path / "new.npz")
    tckpt.save(path, st, cfg)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["__meta__"]).decode())
    meta["format_version"] = tckpt.FORMAT_VERSION + 1
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="newer than supported"):
        tckpt.load(path, "cpu")
    with pytest.raises(ValueError, match="newer than supported"):
        jckpt.load(path)
