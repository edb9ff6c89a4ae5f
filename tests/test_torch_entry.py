"""The port's graft entry (gaussiansplatting_tpu_torch.graft_entry.entry)
against the JAX package's (__graft_entry__.entry) on the CPU: 1,024
Gaussians at 256x256, pair_capacity 2^15, pair_block 64.  Image within
2e-5, the JAX package's own Pallas-vs-XLA image bar."""

import numpy as np
import torch

import jax

import __graft_entry__ as jentry

from gaussiansplatting_tpu_torch.graft_entry import entry

torch.set_num_threads(1)


def test_entry_matches_jax():
    jfwd, jargs = jentry.entry()
    want = np.asarray(jax.jit(jfwd)(*jargs))
    fwd, (params, camera) = entry(device="cpu")
    assert params.means.device.type == "cpu" and int(params.alive.sum()) == 1024
    with torch.no_grad():
        got = fwd(params, camera).numpy()
    assert got.shape == want.shape == (256, 256, 3)
    assert float(got.max() - got.min()) > 0.1
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_dryrun_bf16_step_matches_jax(monkeypatch):
    """The single-card side of the dry run's last block
    (__graft_entry__.py:112-130, graft_entry.dryrun_multichip): one train
    step in the bf16 payload mode with packed positions on the dry run's
    configuration (pair_capacity 2048, B = 16, 64x32, zero ground truth),
    port against JAX on the same scene: pair counts exact, loss within the
    dry run's 1e-4, parameters within two learning rates (one Adam step)."""
    import jax.numpy as jnp

    from gaussiansplatting_tpu.config import Config as JConfig
    from gaussiansplatting_tpu.train import state as jstate
    from gaussiansplatting_tpu.train import trainer as jtrainer

    from gaussiansplatting_tpu_torch.config import Config
    from gaussiansplatting_tpu_torch.train import schedule as tsched
    from gaussiansplatting_tpu_torch.train import state as tstate
    from gaussiansplatting_tpu_torch.train import trainer as ttrainer

    from test_torch_train import _jax_state_arrays
    from torch_parity import cameras, configs, scene_params, t2n

    monkeypatch.setenv("GS_BLEND_POWER", "vpu")
    jp, _ = scene_params(3, n=48)
    jc, tc = cameras(64, 32)
    jr, tr = configs(payload_dtype="bf16", pack_positions=True)
    jcfg, tcfg = JConfig(raster=jr), Config(raster=tr)
    js = jstate.create(jp)
    ts = tstate.state_from_numpy(_jax_state_arrays(js))
    js, jm = jtrainer.train_step(js, jc, jnp.zeros((32, 64, 3)), jcfg, 100)
    ts, tm = ttrainer.train_step(ts, tc, torch.zeros((32, 64, 3)), tcfg, 100)
    assert int(tm.num_pairs) == int(jm.num_pairs) > 0
    assert abs(float(tm.loss) - float(jm.loss)) < 1e-4
    lrs = dict(zip(("means", "log_scales", "quats", "raw_opacities", "sh"),
                   tsched.learning_rates(tcfg.optim, 0, 100)))
    for f, lr in lrs.items():
        got, want = t2n(getattr(ts.params, f)), np.asarray(getattr(js.params, f))
        assert np.abs(got - want).max() <= 2 * lr + 1e-6, f
