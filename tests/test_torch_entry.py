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
