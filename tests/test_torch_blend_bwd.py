"""The port's windowed blend backward (ops.blend.windowed_blend_bwd) and
per-Gaussian cotangent reduction (ops.pairs.reduce_aligned_cotangents)
against the JAX package's Pallas backward (pallas_blend.windowed_blend_bwd,
interpret mode on the CPU) and pairs.reduce_aligned_cotangents, and the CUDA
kernel against its plain version where a GPU is present.

The backward takes the forward's S_b (out[:, 3]); here it comes from the
plain forward on the same windows.

As in tests/test_torch_blend.py the JAX kernel runs with GS_BLEND_POWER=vpu,
its direct evaluation of the quadratic form and the sublane-reduction
backward, which is the form the port's kernel and plain version use."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaussiansplatting_tpu.ops import pairs as jpairs
from gaussiansplatting_tpu.ops import pallas_blend

from gaussiansplatting_tpu_torch.ops import blend as tblend
from gaussiansplatting_tpu_torch.ops import pairs as tpairs
from gaussiansplatting_tpu_torch.utils import tracing

from chip_smoke import edge_windows
from torch_parity import cameras, configs, jax_windows, scene_params, t2n

torch.set_num_threads(1)

TS, TILES_X, TILES_Y = 16, 4, 3
CONSTS = (TS, -4.5, 0.99, 1.0 / 255.0, TILES_X)
JCONSTS = CONSTS + (0, 0)       # JAX adds the (packed, pack_pos) flags
NB = 10
# per column, max |port - JAX| over the column's largest magnitude: the two
# take the same masks but sum the suffix, the transmittance and the 256
# pixels in other orders, and dl / (1 - alpha) scales the suffix's rounding
# by up to 100; measured <= 5e-7 on these windows
COL_REL = 1e-5


@pytest.fixture(autouse=True)
def _direct_power_form(monkeypatch):
    monkeypatch.setenv("GS_BLEND_POWER", "vpu")


def _windows_and_g(seed, block, row0):
    table, src, valid, tile = edge_windows(block, seed, row0, nb=NB, ts=TS,
                                           tiles_x=TILES_X, tiles_y=TILES_Y)
    g = np.random.default_rng(seed + 1).normal(size=(NB, 4, TS * TS)).astype(np.float32)
    return table, src, valid, tile, g


def _plain_s_b(args, row0, block):
    """The plain forward's S_b (out[:, 3]) of the windows ``args``."""
    with torch.no_grad():
        out, _ = tblend.windowed_blend_fwd_plain(*args, row0, block, CONSTS)
    return out[:, 3].contiguous()


def _port_bwd(table, src, valid, tile, row0, block, g, device="cpu"):
    args = [torch.from_numpy(x).to(device) for x in (table, src, valid, tile)]
    s_b = _plain_s_b(args, row0, block)
    out = tblend.windowed_blend_bwd(*args, row0, block,
                                    torch.from_numpy(g).to(device), s_b, CONSTS)
    return [t2n(c) for c in out]


def _assert_columns_close(got, want, rel=COL_REL):
    names = ("mx", "my", "a", "b", "c", "op", "r", "g", "b")
    for name, a, b in zip(names, got, want):
        scale = np.abs(b).max()
        err = np.abs(a - b).max()
        assert err <= rel * scale, f"d{name}: max|err| {err} vs max {scale}"


@pytest.mark.parametrize("block,row0", [(16, 0), (16, 1), (32, 0), (32, 1)])
def test_bwd_plain_matches_jax_kernel(block, row0):
    table, src, valid, tile, g = _windows_and_g(60 + block + row0, block, row0)
    want = [np.asarray(c) for c in pallas_blend.windowed_blend_bwd(
        jnp.asarray(table), jnp.asarray(src), jnp.asarray(valid),
        jnp.asarray(tile), row0, block, jnp.asarray(g), JCONSTS,
    )]
    got = _port_bwd(table, src, valid, tile, row0, block, g)
    assert len(got) == 9 and all(c.shape == (NB, block) for c in got)
    _assert_columns_close(got, want)
    # dead block 0 and lanes past block_valid: exact zeros; live lanes of a
    # full block carry gradient
    for c in got:
        assert (c[0] == 0).all()
        for b in range(NB):
            assert (c[b, valid[b]:] == 0).all()
    assert all(np.abs(c[1]).max() > 0 for c in got)


def test_bwd_plain_chunking_is_invisible():
    table, src, valid, tile, g = (torch.from_numpy(x) for x in _windows_and_g(70, 16, 0))
    s_b = _plain_s_b((table, src, valid, tile), 0, 16)
    ref = tblend.windowed_blend_bwd_plain(table, src, valid, tile, 0, 16, g, s_b, CONSTS)
    for chunk in (1, 3):
        got = tblend.windowed_blend_bwd_plain(table, src, valid, tile, 0, 16, g,
                                              s_b, CONSTS, chunk_blocks=chunk)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("seed", [31, 32])
def test_reduce_aligned_cotangents_matches_jax(seed):
    """The per-Gaussian sums of seeded aligned-order cotangents over the
    windows a real render builds (gid layout, padding lanes, dead blocks)."""
    jp, _ = scene_params(seed, n=48)
    jc, _ = cameras()
    jcfg, _ = configs()
    plan, windows, _ = jax_windows(jp, jc, jcfg)
    counts = np.array(plan[0])
    table, src, valid, bt, _ = (np.array(x) for x in windows)
    tile = np.minimum(bt, TILES_X * TILES_Y - 1).astype(np.int32)
    with torch.no_grad():
        _, gid = tblend.windowed_blend_fwd(
            *(torch.from_numpy(x) for x in (table, src, valid, tile)), 0,
            jcfg.pair_block, CONSTS)
    gid_aligned = t2n(gid).reshape(-1).astype(np.int32)
    n = counts.shape[0]
    assert (gid_aligned < 0).any() and counts.sum() == (gid_aligned >= 0).sum()
    d_rows = np.random.default_rng(seed).normal(size=(9, gid_aligned.size)).astype(np.float32)
    want = np.asarray(jpairs.reduce_aligned_cotangents(
        jnp.asarray(d_rows), jnp.asarray(gid_aligned), jnp.asarray(counts), n))
    got = t2n(tpairs.reduce_aligned_cotangents(
        torch.from_numpy(d_rows), torch.from_numpy(gid_aligned),
        torch.from_numpy(counts), n))
    assert got.shape == (n, 9)
    # both are differences of float32 prefix sums over the same sorted order
    np.testing.assert_allclose(got, want, atol=1e-5)
    # against the plain per-Gaussian sum in float64
    direct = np.zeros((n, 9))
    np.add.at(direct, gid_aligned[gid_aligned >= 0], d_rows[:, gid_aligned >= 0].T)
    np.testing.assert_allclose(got, direct, atol=1e-4)


def test_prefix_sum_spans_chunks(monkeypatch):
    """The two-level prefix sum equals a float64 cumsum across chunk
    boundaries."""
    monkeypatch.setattr(tpairs, "_SCAN_CHUNK", 8)
    x = np.random.default_rng(3).normal(size=(3, 37)).astype(np.float32)
    got = t2n(tpairs._prefix_sum(torch.from_numpy(x)))
    np.testing.assert_allclose(got, np.cumsum(x.astype(np.float64), axis=1), atol=1e-5)


def test_reduce_scatter_is_not_ported():
    """The scatter form is ported: it sums what the sort-prefix form sums
    (to float32 rounding, 1e-5 at these magnitudes), "autodiff" reduces as
    "sortprefix" (JAX's windowed path, pairs.py:553), and a form neither
    package has is refused (tests/test_torch_packing.py holds the scatter
    against JAX's)."""
    rng = np.random.default_rng(5)
    gid = torch.from_numpy(rng.integers(-1, 6, 64).astype(np.int32))
    rows = torch.from_numpy(rng.normal(size=(9, 64)).astype(np.float32))
    rows[:, gid < 0] = 0.0
    counts = torch.bincount(gid[gid >= 0].long(), minlength=6).to(torch.int32)
    ref = tpairs.reduce_aligned_cotangents(rows, gid, counts, 6)
    torch.testing.assert_close(tpairs.reduce_aligned_cotangents(rows, gid, counts, 6, "scatter"),
                               ref, rtol=0, atol=1e-5)
    assert torch.equal(tpairs.reduce_aligned_cotangents(rows, gid, counts, 6, "autodiff"), ref)
    with pytest.raises(ValueError, match="grad_reduce"):
        tpairs.reduce_aligned_cotangents(rows, gid, counts, 6, "atomic")


@pytest.mark.parametrize("shape", [(NB, TS * TS + 1), (NB - 1, TS * TS),
                                   (NB, 4, TS * TS), (NB * TS * TS,)])
def test_bwd_refuses_wrong_shaped_s_b(shape):
    table, src, valid, tile, g = (torch.from_numpy(x) for x in _windows_and_g(72, 16, 0))
    with pytest.raises(ValueError, match="s_b must be"):
        tblend.windowed_blend_bwd(table, src, valid, tile, 0, 16, g,
                                  torch.zeros(shape), CONSTS)


def test_bwd_refuses_float64_s_b():
    table, src, valid, tile, g = (torch.from_numpy(x) for x in _windows_and_g(73, 16, 0))
    s_b = _plain_s_b((table, src, valid, tile), 0, 16).double()
    with pytest.raises(ValueError, match="s_b must be"):
        tblend.windowed_blend_bwd_plain(table, src, valid, tile, 0, 16, g, s_b, CONSTS)


def test_blend_windows_backward_hands_the_kernel_the_forward_s_b(monkeypatch):
    """_BlendWindows.backward passes windowed_blend_bwd exactly the S_b
    (out[:, 3]) its own forward produced, on the default and on the
    t_floor_exact path (whose first pass is this Function too)."""
    from gaussiansplatting_tpu_torch.ops import rasterize

    _, tp = scene_params(33, n=48)
    _, tc = cameras()
    _, tcfg = configs()
    fwd, bwd = tblend.windowed_blend_fwd, tblend.windowed_blend_bwd
    for cfg in (tcfg, tcfg.replace(t_floor_exact=True)):
        seen = {}

        def fwd_stub(*a, **k):
            seen["out"], gid = fwd(*a, **k)
            return seen["out"], gid

        def bwd_stub(*a, **k):
            seen["s_b"] = a[7]
            return bwd(*a, **k)

        monkeypatch.setattr(tblend, "windowed_blend_fwd", fwd_stub)
        monkeypatch.setattr(tblend, "windowed_blend_bwd", bwd_stub)
        img, _ = rasterize.render(tp, tc, cfg)
        img.sum().backward()
        monkeypatch.undo()
        assert seen["s_b"].shape == seen["out"][:, 3].shape
        assert torch.equal(seen["s_b"], seen["out"][:, 3])
        assert (seen["s_b"] < 0).any()


@pytest.mark.parametrize("block,smem", [(16, 3_072), (128, 24_576), (1024, 196_608)])
def test_bwd_launch_geometry(block, smem):
    """The Hopper backward at ts = 16: 2 pixels per thread, so 128 threads
    (4 warps); 48 bytes per staged lane plus 9 floats per (warp, lane) of
    partials.  The forward, 4 pixels per thread, stages the lanes alone.
    The T-floor instances take 2 pixels per thread in both directions, and
    the backward's keeps a static per-warp stop array."""
    assert tblend.launch_geometry(16, block, True) == (128, smem)
    assert tblend.launch_geometry(16, block, False) == (64, block * 48)
    assert tblend.launch_geometry(16, block, True, tfloor=True) == (128, smem + 128)
    assert tblend.launch_geometry(16, block, False, tfloor=True) == (128, block * 48)


@pytest.mark.parametrize("ts,block", [(32, 1024), (32, 512), (32, 768)])
def test_bwd_launch_geometry_refuses_past_hopper_smem(ts, block):
    """Past the 232,448 bytes a Hopper block can have, the wrapper refuses
    (32 x 32 tiles: 16 warps of 2-pixel strips need 319,488 bytes at
    B = 512)."""
    with pytest.raises(ValueError, match="at most 232448"):
        tblend.launch_geometry(ts, block, True)
    assert tblend.launch_geometry(32, 256, True) == (512, 256 * 48 + 16 * 9 * 256 * 4)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [16, 128])
def test_bwd_kernel_matches_plain_cuda(block):
    """The CUDA backward kernel against its plain version on the card, per
    column within chip_smoke.BWD_REL of the column's largest magnitude, and
    bit-identical on a second launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from chip_smoke import BWD_REL

    table, src, valid, tile, g = _windows_and_g(80 + block, block, 0)
    before = tracing.launch_counts()["windowed_blend_bwd"]
    got = _port_bwd(table, src, valid, tile, 0, block, g, device="cuda")
    again = _port_bwd(table, src, valid, tile, 0, block, g, device="cuda")
    assert tracing.launch_counts()["windowed_blend_bwd"] == before + 2
    dev = [torch.from_numpy(x).cuda() for x in (table, src, valid, tile)]
    want = [t2n(c) for c in tblend.windowed_blend_bwd_plain(
        *dev, 0, block, torch.from_numpy(g).cuda(), _plain_s_b(dev, 0, block), CONSTS)]
    _assert_columns_close(got, want, rel=BWD_REL)
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a, b)
