"""Gradients of the port's render (ops.rasterize.render under autograd)
against jax.grad of the JAX windowed render (blend_impl="pallas", interpret
mode on the CPU), against directional finite differences, and one check for
each of the three pieces that make the forward differentiable like the JAX
one: the colour dead zone, the vs_dummy input and the permutation VJP."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussiansplatting_tpu.ops.rasterize import render as jrender

from gaussiansplatting_tpu_torch.core import gaussians as TG
from gaussiansplatting_tpu_torch.ops import rasterize as trast
from gaussiansplatting_tpu_torch.ops.rasterize import render

from torch_parity import cameras, configs, scene_params, t2n, to_torch_params

torch.set_num_threads(1)

FIELDS = ("means", "log_scales", "quats", "raw_opacities", "sh")
# port vs JAX: relative norm of the gradient difference per group (the
# reference's own on-device bar is 3.4e-4, BASELINE.md; measured <= 6.5e-6
# here) and the largest element error over the group's largest element
# (measured <= 3.3e-6)
REL_NORM, REL_ELEM = 1e-4, 5e-5


def _weights(seed, h=48, w=64):
    return np.random.default_rng(seed).uniform(0.5, 1.0, (h, w, 3)).astype(np.float32)


def _jax_loss(tr, vs, w, jp, jc, jcfg):
    img, _ = jrender(jp.replace(**tr), jc, jcfg, vs_dummy=vs)
    return jnp.sum(img * w)


# one compile for every test of the same shapes
_jax_grad = jax.jit(jax.grad(_jax_loss, argnums=(0, 1)), static_argnums=5)


def _jax_grads(jp, jc, jcfg, w, vs):
    grads, vs_grad = _jax_grad({f: getattr(jp, f) for f in FIELDS},
                               jnp.asarray(vs), jnp.asarray(w), jp, jc, jcfg)
    return {**{f: np.asarray(grads[f]) for f in FIELDS}, "vs": np.asarray(vs_grad)}


def _port_grads(tp, tc, tcfg, w, vs):
    vs_t = torch.from_numpy(vs).requires_grad_(True)
    img, _ = render(tp, tc, tcfg, vs_dummy=vs_t)
    gs = torch.autograd.grad((img * torch.from_numpy(w)).sum(),
                             [getattr(tp, f) for f in FIELDS] + [vs_t])
    return dict(zip(FIELDS + ("vs",), (t2n(g) for g in gs)))


@pytest.mark.parametrize("seed", [11, 12])
def test_render_grads_match_jax(seed):
    """All five parameter groups and vs_dummy, sum(img * w) loss."""
    jp, tp = scene_params(seed, n=48)
    jc, tc = cameras()
    jcfg, tcfg = configs()
    w = _weights(seed)
    vs = np.zeros((48, 2), np.float32)
    want = _jax_grads(jp, jc, jcfg, w, vs)
    got = _port_grads(tp, tc, tcfg, w, vs)
    for k in FIELDS + ("vs",):
        a, b = got[k], want[k]
        assert np.isfinite(a).all() and np.abs(b).max() > 0, k
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel < REL_NORM, f"{k}: relative norm {rel}"
        assert np.abs(a - b).max() < REL_ELEM * np.abs(b).max(), k
    # DC only: the higher SH coefficients get exactly zero
    assert (got["sh"][:, 1:, :] == 0).all()


def test_render_grad_matches_finite_differences(rng):
    """Directional central differences along random sh and raw-opacity
    directions, the JAX package's own check and bars
    (tests/test_render_backward.py:71-107): those fields are smooth up to
    the alpha floor, the geometry ones jump with tile coverage."""
    _, tp = scene_params(17, n=24)
    _, tc = cameras(48, 32)
    _, tcfg = configs()
    w = torch.from_numpy(rng.uniform(0.5, 1.0, (32, 48, 3)).astype(np.float32))

    def loss(p):
        img, _ = render(p, tc, tcfg)
        return (img * w).sum()

    grads = torch.autograd.grad(loss(tp), [getattr(tp, f) for f in FIELDS])
    grads = dict(zip(FIELDS, grads))
    host = {f: t2n(getattr(tp, f)) for f in TG.FIELDS}
    for field, rtol, atol in (("sh", 0.05, 0.05), ("raw_opacities", 0.08, 0.2)):
        v = rng.normal(size=host[field].shape).astype(np.float32)
        v /= np.linalg.norm(v)
        dir_grad = float((t2n(grads[field]) * v).sum())
        eps = 1e-2
        with torch.no_grad():
            up = TG.params_from_numpy({**host, field: host[field] + eps * v})
            dn = TG.params_from_numpy({**host, field: host[field] - eps * v})
            fd = (float(loss(up)) - float(loss(dn))) / (2 * eps)
        assert abs(dir_grad - fd) < rtol * abs(fd) + atol, (field, dir_grad, fd)


def test_saturated_colour_gets_no_gradient():
    """The dead zone: a colour channel clamped into (0.99, 1] or [0, 0.01)
    passes no gradient (tiled_shaders.metal:505-507), as in JAX; channels
    inside the zone do."""
    jp, _ = scene_params(18, n=48)
    sh = np.array(jp.sh)
    sh[:16, 0, 0] = 1.76       # colour 0.5 + 0.2821 * 1.76 = 0.9965
    sh[16:32, 0, 1] = -1.76    # colour 0.0035
    jp = jp.replace(sh=jnp.asarray(sh))
    tp = to_torch_params(jp)
    jc, tc = cameras()
    jcfg, tcfg = configs()
    w = _weights(18)
    vs = np.zeros((48, 2), np.float32)
    got = _port_grads(tp, tc, tcfg, w, vs)["sh"]
    want = _jax_grads(jp, jc, jcfg, w, vs)["sh"]
    assert (got[:16, 0, 0] == 0).all() and (got[16:32, 0, 1] == 0).all()
    assert (got[:16, 0, 1:] != 0).any() and (got[32:, 0, :] != 0).any()
    np.testing.assert_allclose(got, want, atol=REL_ELEM * np.abs(want).max())


def test_vs_dummy_shifts_screen_positions():
    """vs_dummy is added to the projected screen positions: a nonzero
    offset renders the image JAX renders with it."""
    jp, tp = scene_params(19, n=48)
    jc, tc = cameras()
    jcfg, tcfg = configs()
    vs = np.random.default_rng(19).uniform(-1.5, 1.5, (48, 2)).astype(np.float32)
    img_j, _ = jax.jit(jrender, static_argnums=2)(jp, jc, jcfg, jnp.asarray(vs))
    with torch.no_grad():
        img_t, _ = render(tp, tc, tcfg, vs_dummy=torch.from_numpy(vs))
        img_0, _ = render(tp, tc, tcfg)
    np.testing.assert_allclose(t2n(img_t), np.asarray(img_j), atol=2e-5)
    assert np.abs(t2n(img_t) - t2n(img_0)).max() > 1e-2


def test_permute_rows_backward_gathers_by_inverse():
    """The presort's row permutation: forward x[order], backward the
    cotangent gathered by the inverse permutation (no scatter-add)."""
    gen = torch.Generator().manual_seed(20)
    n = 37
    x = torch.randn((n, 15), generator=gen, requires_grad=True)
    order = torch.randperm(n, generator=gen)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n)
    y = trast._PermuteRows.apply(x, order, inv)
    assert type(y.grad_fn).__name__ == "_PermuteRowsBackward"
    assert torch.equal(y, x.detach()[order])
    w = torch.randn((n, 15), generator=gen)
    (g,) = torch.autograd.grad((y * w).sum(), x)
    assert torch.equal(g, w[inv])
