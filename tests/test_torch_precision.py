"""The port's two prefix-sum differences against float64 on the CPU, at the
size of the full 800x608 frame, where the JAX package's float32 forms lose
digits: compose's incoming log T (ops.rasterize.incoming_log_t, its forward
and backward) and the backward's per-Gaussian sums
(ops.pairs.reduce_aligned_cotangents); and compose against the JAX
package's _compose_tiles at the render tests' bars.

Each fault is shown on the same input: JAX's float32 form misses the bar
that the port's float64 form meets."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussiansplatting_tpu.config import RasterConfig as JRasterConfig
from gaussiansplatting_tpu.ops import rasterize as jrast

from gaussiansplatting_tpu_torch.config import RasterConfig
from gaussiansplatting_tpu_torch.ops import pairs as tpairs
from gaussiansplatting_tpu_torch.ops import rasterize as trast

torch.set_num_threads(1)

# the canonical 800x608 frame of the 100k-Gaussian scene at 2^21 pairs:
# 18,284 blocks of P2 = 256 pixels over 50 x 38 = 1,900 tiles
NB_FULL, NT_FULL, P2 = 18_284, 1_900, 256
# image and gradient bars of the port-vs-JAX render tests
# (tests/test_torch_render.py, tests/test_torch_render_grad.py)
IMG_ATOL, REL_NORM = 2e-5, 1e-4
# per-Gaussian sums: relative norm of each column's error against float64
COL_REL_NORM = 1e-6


def _frame_blocks(seed, nb=NB_FULL, num_tiles=NT_FULL, pad=600):
    """Per-block S_b ~ U(-8, 0) [nb, P2] f32 and tile ids [nb] int32: sorted
    tile runs of random length, then ``pad`` padding blocks (num_tiles)."""
    rng = np.random.default_rng(seed)
    s_b = rng.uniform(-8.0, 0.0, (nb, P2)).astype(np.float32)
    seg = np.sort(rng.integers(0, num_tiles, nb - pad))
    seg = np.concatenate([seg, np.full(pad, num_tiles)]).astype(np.int32)
    return s_b, seg


def _runs(seg):
    """(start, end) of each run of equal tile ids."""
    starts = np.flatnonzero(np.r_[True, seg[1:] != seg[:-1]])
    return zip(starts, np.r_[starts[1:], seg.size])


def _per_tile_f64(s_b, seg):
    """Each block's exclusive prefix of S_b over its own tile's run, tile by
    tile in float64."""
    x = s_b.astype(np.float64)
    out = np.zeros_like(x)
    for a, b in _runs(seg):
        out[a + 1:b] = np.cumsum(x[a:b - 1], axis=0)
    return out


def _jax_global_f32(s_b, seg):
    """JAX's form (rasterize.py:509-518) in NumPy float32: a cumsum over all
    blocks minus its value at the tile's first block."""
    cum_excl = np.cumsum(s_b, axis=0, dtype=np.float32) - s_b
    return cum_excl - cum_excl[np.searchsorted(seg, seg, side="left")]


def _ulps_off(got, ref):
    """|got - ref| in float32 ulps of max(|ref|, 1)."""
    unit = np.spacing(np.maximum(np.abs(ref), 1.0).astype(np.float32)).astype(np.float64)
    return np.abs(got.astype(np.float64) - ref) / unit


def test_incoming_log_t_within_one_ulp_of_float64():
    s_b, seg = _frame_blocks(0)
    ref = _per_tile_f64(s_b, seg)
    with torch.no_grad():
        got = trast.incoming_log_t(torch.from_numpy(s_b), torch.from_numpy(seg), NT_FULL)
    assert got.dtype == torch.float32 and got.shape == (NB_FULL, P2)
    assert _ulps_off(got.numpy(), ref).max() <= 1.0
    # the fault: JAX's float32 global form on the same input
    assert np.abs(_jax_global_f32(s_b, seg) - ref).max() > 1e-3


def _per_tile_f64_torch(s_b, seg, num_tiles):
    """A float64 per-tile prefix with autograd (the global form, exact
    enough in float64): the backward's reference."""
    x = s_b.double()
    cum_excl = torch.cumsum(x, 0) - x
    bounds = torch.searchsorted(seg, torch.arange(num_tiles + 1, dtype=seg.dtype))
    return cum_excl - cum_excl[bounds[seg.long()]]


def test_incoming_log_t_backward_matches_float64_autograd():
    s_b, seg = _frame_blocks(1, nb=4_000, num_tiles=300, pad=100)
    g = np.random.default_rng(2).normal(size=s_b.shape).astype(np.float32)
    x = torch.from_numpy(s_b).requires_grad_(True)
    ref = torch.autograd.grad(
        (_per_tile_f64_torch(x, torch.from_numpy(seg), 300) * torch.from_numpy(g).double()).sum(),
        x)[0]
    got, again = (torch.autograd.grad(
        trast.incoming_log_t(x, torch.from_numpy(seg), 300), x, torch.from_numpy(g))[0]
        for _ in range(2))
    assert got.dtype == torch.float32 and torch.equal(got, again)
    # the reference's cotangent is rounded to float32 as the port rounds it
    assert _ulps_off(got.numpy(), ref.numpy()).max() <= 1.0


def test_incoming_log_t_gives_zero_gradient_behind_a_zero_tail():
    """A block whose tile gets zero cotangent after it (every later pixel
    of the tile past the T-floor) gets exactly zero gradient; JAX's global
    form leaves the other tiles' cancellation residue there."""
    s_b, seg = _frame_blocks(3, nb=4_000, num_tiles=300, pad=100)
    g = np.random.default_rng(4).normal(size=s_b.shape).astype(np.float32)
    tail = np.zeros(seg.size, bool)     # each third tile's blocks but its first
    for a, b in list(_runs(seg))[::3]:
        tail[a + 1:b] = True
    g[tail] = 0.0
    x = torch.from_numpy(s_b).requires_grad_(True)
    got = torch.autograd.grad(trast.incoming_log_t(x, torch.from_numpy(seg), 300), x,
                              torch.from_numpy(g))[0].numpy()
    assert tail.sum() > 500 and (got[tail] == 0).all()
    cum_excl = torch.cumsum(x, 0) - x                                 # the JAX form
    bounds = torch.searchsorted(torch.from_numpy(seg), torch.arange(301, dtype=torch.int32))
    jform = cum_excl - cum_excl[bounds[torch.from_numpy(seg).long()]]
    residue = torch.autograd.grad(jform, x, torch.from_numpy(g))[0].numpy()
    assert (residue[tail] != 0).any()


@pytest.mark.parametrize("white", [True, False])
def test_compose_matches_jax(white):
    """Compose of random per-block summaries over 6 x 4 tiles (padding
    blocks included) against JAX's _compose_tiles: the image within 2e-5,
    the gradients of sum(img * w) in C_b and S_b within 1e-4 relative
    norm.  The frame is small, so JAX's global float32 prefix stays well
    inside those bars."""
    rng = np.random.default_rng(5)
    ts, tx, ty, nb = 16, 6, 4, 150
    width, height = tx * ts - 5, ty * ts - 3
    nt = tx * ty
    s_b = rng.uniform(-0.5, 0.0, (nb, ts * ts)).astype(np.float32)
    c_b = ((1.0 - np.exp(s_b))[:, None, :]
           * rng.uniform(0.0, 1.0, (nb, 3, ts * ts))).astype(np.float32)
    seg = np.concatenate([np.sort(rng.integers(0, nt, nb - 20)),
                          np.full(20, nt)]).astype(np.int32)
    w = rng.uniform(0.5, 1.0, (height, width, 3)).astype(np.float32)
    jcfg = JRasterConfig(white_background=white)

    def jloss(c, s):
        img, _ = jrast._compose_tiles(c, s, jnp.asarray(seg), None, nb, nt, tx, ty, ts,
                                      ts * ts, width, height, jcfg, None, None)
        return jnp.sum(img * w), img

    (_, want), (jc, js) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(c_b), jnp.asarray(s_b))
    c = torch.from_numpy(c_b).requires_grad_(True)
    s = torch.from_numpy(s_b).requires_grad_(True)
    img = trast._compose_tiles(c, s, torch.from_numpy(seg), nt, tx, ty, ts, width, height,
                               RasterConfig(white_background=white))
    got_c, got_s = torch.autograd.grad((img * torch.from_numpy(w)).sum(), [c, s])
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(want), atol=IMG_ATOL)
    for a, b in ((got_c, jc), (got_s, js)):
        b = np.asarray(b)
        assert np.linalg.norm(a.numpy() - b) / np.linalg.norm(b) < REL_NORM


def _aligned_cotangents(seed, signed, n=1 << 16, mean_pairs=16, pad_share=0.05):
    """A frame's backward at >= 2^20 aligned lanes: n Gaussians with
    Poisson(mean_pairs) pairs each, in random (tile-sorted) lane order with
    padding lanes (gid -1) among them, and nine columns of cotangents,
    same-sign or signed."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(mean_pairs, n).astype(np.int32)
    gid = np.repeat(np.arange(n, dtype=np.int32), counts)
    gid = np.concatenate([gid, np.full(int(pad_share * gid.size), -1, np.int32)])
    gid = gid[rng.permutation(gid.size)]
    shape = (9, gid.size)
    d_rows = (rng.normal(size=shape) if signed else rng.uniform(0.0, 1.0, shape))
    return d_rows.astype(np.float32), gid, counts


def _bincount64(d_rows, gid, n):
    live = gid >= 0
    return np.stack([np.bincount(gid[live], weights=r[live].astype(np.float64), minlength=n)
                     for r in d_rows], axis=1)                       # [N, 9]


def _col_rel_norm(got, ref):
    return np.linalg.norm(got - ref, axis=0) / np.linalg.norm(ref, axis=0)


@pytest.mark.parametrize("signed", [False, True])
def test_reduce_aligned_cotangents_within_float64(signed):
    d_rows, gid, counts = _aligned_cotangents(6, signed)
    n = counts.size
    assert gid.size >= 1 << 20
    ref = _bincount64(d_rows, gid, n)
    got = tpairs.reduce_aligned_cotangents(
        torch.from_numpy(d_rows), torch.from_numpy(gid), torch.from_numpy(counts), n)
    assert got.dtype == torch.float32 and got.shape == (n, 9)
    assert _col_rel_norm(got.numpy().astype(np.float64), ref).max() <= COL_REL_NORM
    if not signed:
        # the fault: the same sort-prefix difference in float32 (JAX's form)
        _, perm = torch.sort(torch.from_numpy(np.where(gid >= 0, gid, n)), stable=True)
        csum = np.pad(tpairs._prefix_sum(torch.from_numpy(d_rows)[:, perm]).numpy(),
                      ((0, 0), (1, 0)))
        ends = np.cumsum(counts)
        f32 = (csum[:, ends] - csum[:, ends - counts]).T
        assert _col_rel_norm(f32.astype(np.float64), ref).max() > 1e-4


def test_reduce_aligned_cotangents_zero_runs_are_exactly_zero():
    """A Gaussian whose cotangents are all zero (behind every pixel's
    T-floor) gets exactly 0, wherever its run lies against the prefix
    sum's chunks."""
    d_rows, gid, counts = _aligned_cotangents(7, True)
    n = counts.size
    quiet = np.random.default_rng(8).random(n) < 0.1
    d_rows[:, (gid >= 0) & quiet[np.maximum(gid, 0)]] = 0.0
    got = tpairs.reduce_aligned_cotangents(
        torch.from_numpy(d_rows), torch.from_numpy(gid), torch.from_numpy(counts), n).numpy()
    assert (got[quiet] == 0).all() and (got[~quiet & (counts > 0)] != 0).all()


@pytest.mark.parametrize("fn", ["reduce_aligned_cotangents", "incoming_log_t"])
def test_zero_runs_stay_exact_under_a_position_dependent_scan(fn, monkeypatch):
    """The exact zeros do not rest on the CPU's sequential cumsum: with a
    prefix sum whose rounding depends on the position (as a CUDA block
    scan's tree does; here a relative 2^-50 at every third position), a run
    of zero cotangents still gives exactly 0, and the other sums stay
    within the float64 bars."""
    orig = tpairs._prefix_sum

    def scan(x):
        p = orig(x)
        if not p.is_floating_point():       # the nonzero counts stay exact
            return p
        return p + p * (torch.arange(p.shape[1]) % 3 == 1) * 2.0 ** -50

    rng = np.random.default_rng(9)
    if fn == "reduce_aligned_cotangents":
        d_rows, gid, counts = _aligned_cotangents(10, False, n=1 << 12)
        n = counts.size
        quiet = rng.random(n) < 0.2
        d_rows[:, (gid >= 0) & quiet[np.maximum(gid, 0)]] = 0.0
        _, perm = torch.sort(torch.from_numpy(np.where(gid >= 0, gid, n)), stable=True)
        ends = np.cumsum(counts)
        prefix = np.pad(scan(torch.from_numpy(d_rows)[:, perm].double()).numpy(),
                        ((0, 0), (1, 0)))
        raw = (prefix[:, ends] - prefix[:, ends - counts]).T  # the difference alone
        monkeypatch.setattr(tpairs, "_prefix_sum", scan)
        got = tpairs.reduce_aligned_cotangents(
            torch.from_numpy(d_rows), torch.from_numpy(gid), torch.from_numpy(counts),
            n).numpy()
        assert (raw[quiet] != 0).any() and (got[quiet] == 0).all()
        assert _col_rel_norm(got.astype(np.float64), _bincount64(d_rows, gid, n)).max() \
            <= COL_REL_NORM
    else:
        s_b, seg = _frame_blocks(11, nb=2_000, num_tiles=150, pad=50)
        g = rng.normal(size=s_b.shape).astype(np.float32)
        tail = np.zeros(s_b.shape, bool)    # each (tile, pixel) from a random block on
        for a, b in _runs(seg):
            cut = rng.integers(a, b + 1, P2)
            tail[a:b] = np.arange(a, b)[:, None] >= cut[None, :]
        g[tail] = 0.0
        behind = tail | np.roll(tail, -1, axis=0) & (np.roll(seg, -1) == seg)[:, None]
        monkeypatch.setattr(tpairs, "_prefix_sum", scan)
        x = torch.from_numpy(s_b).requires_grad_(True)
        got = torch.autograd.grad(trast.incoming_log_t(x, torch.from_numpy(seg), 150), x,
                                  torch.from_numpy(g))[0].numpy()
        ref = torch.autograd.grad(
            (_per_tile_f64_torch(x, torch.from_numpy(seg), 150)
             * torch.from_numpy(g).double()).sum(), x)[0].numpy()
        assert behind.sum() > 10_000 and (got[behind] == 0).all()
        assert _ulps_off(got, ref).max() <= 1.0
