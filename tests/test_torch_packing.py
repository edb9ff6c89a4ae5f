"""The bf16 payload mode of the port (RasterConfig.payload_dtype="bf16",
with and without pack_positions), the impact overflow drop and the scatter
reduction, against the JAX package on the same seeded inputs.

* ops/packing.py against gaussiansplatting_tpu/ops/packing.py bit for bit.
* The packed table of pair_windows_fwd (both layouts, and a strip with
  row0 > 0) bit for bit.
* The packed blends' plain versions against JAX's windowed_blend_fwd /
  windowed_blend_bwd with packed cfg_consts (interpret mode,
  GS_BLEND_POWER=vpu: the direct quadratic form the port uses).
* Renders and parameter gradients against JAX's: their distance to JAX at
  most a tenth of the port's own f32-vs-bf16 gap on the same scene (a port
  that ignored the mode would sit at the whole gap), and that gap within
  JAX's bars (tests/test_packing.py: image max < 0.06, mean < 5e-3,
  gradients < 5e-2 of the field's largest).
* pack_positions strips stacking to the full frame; the T-floor path
  ignoring both flags; the impact drop and the scatter reduction.

The JAX configurations use pair_capacity 4096 (the port's too), so no
jitted JAX render traced elsewhere under another GS_BLEND_POWER is reused.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussiansplatting_tpu.ops import packing as jpacking
from gaussiansplatting_tpu.ops import pairs as jpairs
from gaussiansplatting_tpu.ops import pallas_blend
from gaussiansplatting_tpu.ops.rasterize import render as jrender

from gaussiansplatting_tpu_torch.ops import blend as tblend
from gaussiansplatting_tpu_torch.ops import packing
from gaussiansplatting_tpu_torch.ops import pairs as tpairs
from gaussiansplatting_tpu_torch.ops.rasterize import render

from chip_smoke import packed_edge_windows
from torch_parity import (
    cameras, configs, jax_presorted_inputs, jax_windows, scene_params, t2n,
)
from test_torch_pairs import _port_windows, _to_port

torch.set_num_threads(1)

CAP = 4096
FIELDS = ("means", "log_scales", "quats", "raw_opacities", "sh")
MODES = {"bf16": dict(payload_dtype="bf16"),
         "pack_pos": dict(payload_dtype="bf16", pack_positions=True)}
# the port's distance to JAX in the bf16 mode, as a share of its own
# f32-vs-bf16 gap (mean |diff| and the share of entries off by > 1e-4)
GAP_SHARE = 0.1
# JAX's own bf16-vs-f32 bars (tests/test_packing.py:97-202)
IMG_MAX, IMG_MEAN, GRAD_REL = 0.06, 5e-3, 5e-2


@pytest.fixture(autouse=True)
def _direct_power_form(monkeypatch):
    monkeypatch.setenv("GS_BLEND_POWER", "vpu")


def _cfgs(**kw):
    return configs(pair_capacity=CAP, **kw)


# ---------------------------------------------------------------- packing


def _specials():
    return np.array([0.0, -0.0, 1e-40, -1e-40, 1.2e-38, 3.4e38, -3.4e38, np.inf,
                     -np.inf, 1.0, -1.0, 1.00390625, 1.01171875, 65504.0],
                    np.float32)


@pytest.mark.parametrize("scale", [1e-25, 1.0, 1e25])
def test_pack2_matches_jax_bits(scale):
    """pack2 / unpack2 / round_bf16 equal JAX's bits on random values over
    60 binades and on +-0, subnormals, the largest floats and infinities
    (exact: the same integer rounding)."""
    rng = np.random.default_rng(int(np.log10(scale)) + 40)
    x = (rng.normal(size=4096) * scale * np.exp(rng.uniform(-20, 20, 4096))).astype(np.float32)
    y = (rng.normal(size=4096) * np.exp(rng.uniform(-20, 20, 4096))).astype(np.float32)
    x, y = np.r_[x, _specials()], np.r_[y, _specials()[::-1]]
    want = np.asarray(jpacking.pack2(jnp.asarray(x), jnp.asarray(y))).view(np.int32)
    got = t2n(packing.pack2(torch.from_numpy(x), torch.from_numpy(y))).view(np.int32)
    np.testing.assert_array_equal(got, want)
    for a, b in zip(jpacking.unpack2(jnp.asarray(want.view(np.float32))),
                    packing.unpack2(torch.from_numpy(got.view(np.float32)))):
        np.testing.assert_array_equal(t2n(b).view(np.int32), np.asarray(a).view(np.int32))
    finite = np.isfinite(x)
    rounded = t2n(packing.round_bf16(torch.from_numpy(x)))
    np.testing.assert_array_equal(
        rounded[finite].view(np.int32),
        np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)[finite].view(np.int32))


def test_pack_cols_odd_tail_round_trip():
    rng = np.random.default_rng(3)
    cols = [packing.round_bf16(torch.from_numpy(rng.normal(size=64).astype(np.float32)))
            for _ in range(7)]
    packed = packing.pack_cols(cols)
    assert len(packed) == 4
    assert torch.equal(packing.unpack2(packed[3])[1], torch.zeros(64))
    for c, o in zip(cols, packing.unpack_cols(packed, 7)):
        assert torch.equal(c, o)


# ------------------------------------------------------------ packed table


@pytest.mark.parametrize("pack_pos,tile_rows", [(False, None), (True, None), (True, (2, 2)),
                                                (False, (1, 3))])
def test_packed_table_matches_jax_bits(pack_pos, tile_rows):
    """The 8-row packed table, its windows and tiles equal JAX's bit for
    bit, on the full frame and on strips (row0 > 0: the tile-relative
    positions take the absolute tile row)."""
    jp, _ = scene_params(51, n=48)
    jc, _ = cameras(64, 64)
    jcfg, _ = _cfgs()
    _, jwin, _ = jax_windows(jp, jc, jcfg, True, pack_pos, tile_rows)
    _, twin = _port_windows(jp, jc, jcfg, True, pack_pos, tile_rows)
    assert twin[0].shape[0] == 8
    for name, a, b in zip(("table", "src", "valid", "tile", "total"), jwin, twin):
        a, b = np.asarray(a), t2n(b)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(b.view(np.int32) if b.dtype == np.float32 else b,
                                      a.view(np.int32) if a.dtype == np.float32 else a,
                                      err_msg=name)
    assert (np.asarray(jwin[2]) > 0).any()


# ---------------------------------------------------------- packed blends


def _jconsts(pack_pos):
    return (16, -4.5, 0.99, 1.0 / 255.0, 4, 1, int(pack_pos))


def _scene_windows(seed, pack_pos):
    jp, _ = scene_params(seed, n=48)
    jc, _ = cameras()
    jcfg, _ = _cfgs()
    _, windows, _ = jax_windows(jp, jc, jcfg, True, pack_pos)
    table, src, valid, bt, _ = (np.array(x) for x in windows)
    tile = np.minimum(bt, 11).astype(np.int32)
    return table, src, valid, tile


@pytest.mark.parametrize("pack_pos", [False, True])
def test_packed_fwd_plain_matches_jax(pack_pos):
    """windowed_blend_fwd_packed_plain against JAX's packed forward on a
    real render's packed windows: gid exact, out within 2e-5 (the bf16
    prefix in another summation order; the f32 forward's own bar, and
    no bf16 rounding of l flips here, which would move T by ~1%)."""
    table, src, valid, tile = _scene_windows(52, pack_pos)
    out_j, gid_j = (np.asarray(x) for x in pallas_blend.windowed_blend_fwd(
        *(jnp.asarray(x) for x in (table, src, valid, tile)), 0, 16, _jconsts(pack_pos)))
    with torch.no_grad():
        out_t, gid_t, q_b = tblend.windowed_blend_fwd_packed(
            *(torch.from_numpy(x) for x in (table, src, valid, tile)), 0, 16,
            _jconsts(pack_pos))
    np.testing.assert_array_equal(t2n(gid_t), gid_j)
    np.testing.assert_allclose(t2n(out_t), out_j, atol=2e-5)
    assert q_b.shape == (src.shape[0], 256) and bool((q_b < 0).any())
    # q_b is the bf16 prefix's total: S_b rounded term by term
    np.testing.assert_allclose(t2n(q_b), t2n(out_t[:, 3]), atol=0.05)


@pytest.mark.parametrize("pack_pos", [False, True])
def test_packed_bwd_plain_matches_jax(pack_pos):
    """windowed_blend_bwd_packed_plain, unpacked, against JAX's packed
    backward, unpacked: per column within a bf16 ulp of the value (2^-7
    relative: the final RNE may round a last-bit difference either way)
    plus 1e-5 of the column's largest magnitude."""
    table, src, valid, tile = _scene_windows(53, pack_pos)
    g = np.random.default_rng(53).normal(size=(src.shape[0], 4, 256)).astype(np.float32)
    want = pallas_blend.windowed_blend_bwd(
        *(jnp.asarray(x) for x in (table, src, valid, tile)), 0, 16, jnp.asarray(g),
        _jconsts(pack_pos))
    assert len(want) == 5
    want = np.stack([np.asarray(c) for c in jpacking.unpack_cols(list(want), 9)])
    args = [torch.from_numpy(x) for x in (table, src, valid, tile)]
    with torch.no_grad():
        _, _, q_b = tblend.windowed_blend_fwd_packed(*args, 0, 16, _jconsts(pack_pos))
        got = tblend.windowed_blend_bwd_packed(*args, 0, 16, torch.from_numpy(g), q_b,
                                               _jconsts(pack_pos))
    assert len(got) == 5
    got = t2n(torch.stack(packing.unpack_cols(list(got), 9)))
    for c in range(9):
        bar = 2.0 ** -7 * np.abs(want[c]) + 1e-5 * np.abs(want[c]).max()
        assert (np.abs(got[c] - want[c]) <= bar).all(), c
    assert np.abs(want).max() > 0


def test_packed_wrappers_refuse_the_other_constants():
    table, src, valid, tile = (torch.from_numpy(x)
                               for x in packed_edge_windows(16, 3, 0, False, nb=4))
    f32 = (16, -4.5, 0.99, 1.0 / 255.0, 50)
    with pytest.raises(ValueError, match="packed payload"):
        tblend.windowed_blend_fwd_packed(table, src, valid, tile, 0, 16, f32)
    with pytest.raises(ValueError, match="float32 payload"):
        tblend.windowed_blend_fwd(table, src, valid, tile, 0, 16, f32 + (1, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("pack_pos", [False, True])
def test_packed_kernels_match_plain_cuda(pack_pos):
    """The packed CUDA kernels against their plain versions on the card:
    gid exact, out and q_b within 1e-4 + 1e-5 relative, the five backward
    rows unpacked within a bf16 ulp + 1e-4 of the column's largest (the
    suffix's bf16 terms may round a last-bit difference either way;
    chip_smoke.py's PACKED_BWD_REL)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    consts = (16, -4.5, 0.99, 1.0 / 255.0, 50, 1, int(pack_pos))
    args = [torch.from_numpy(x).cuda() for x in packed_edge_windows(128, 9, 0, pack_pos)]
    out, gid, q_b = tblend.windowed_blend_fwd_packed(*args, 0, 128, consts)
    p_out, p_gid, p_q = tblend.windowed_blend_fwd_packed_plain(*args, 0, 128, consts)
    assert torch.equal(gid, p_gid)
    torch.testing.assert_close(out, p_out, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(q_b, p_q, atol=1e-4, rtol=1e-5)
    g = torch.randn((args[1].shape[0], 4, 256), device="cuda")
    got = torch.stack(packing.unpack_cols(list(tblend.windowed_blend_bwd_packed(
        *args, 0, 128, g, q_b, consts)), 9))
    want = torch.stack(packing.unpack_cols(list(tblend.windowed_blend_bwd_packed_plain(
        *args, 0, 128, g, q_b, consts)), 9))
    bar = 2.0 ** -7 * want.abs() + 1e-4 * want.abs().amax((1, 2), keepdim=True)
    assert bool(((got - want).abs() <= bar).all())


# ------------------------------------------- the packed kernels' T carry
#
# The packed kernels (csrc/blend_{fwd,bwd}.cu) take T_k = exp(Q_k - l_k),
# Q_k the float32 sum of the bf16-rounded l_j = log1p(-alpha_j) over j <= k,
# by multiplication: the forward carries E = exp(Q_{k-1}) and takes T_k =
# E exp(-d_k), d = l - bf16(l), then E = T_k (1 - alpha_k); the backward
# starts from the forward's q_b, walks back in log space (T = exp(Q - l),
# Q -= bf16(l)) while Q < -60, and above it takes T_k = E / (1 - alpha_k)
# by a rounded reciprocal, then E = T_k exp(d_k).  exp(+-d) is the cubic
# 1 + d + d^2/2 + d^3/6 (|d| <= 2^-8 |l| <= 0.018).  The model below is
# float32 in the kernels' order of operations (an FMA as one rounding),
# held against float64 exp(Q - l) over the same bf16 terms.

ALPHA_FLOOR, ALPHA_CAP = 1.0 / 255.0, 0.99
LOG_WALK = np.float32(-60.0)    # blend_bwd.cu kLogWalk
# Each kept lane costs the carry a few float32 roundings (the cubic, two
# products, 1 - alpha and l's own rounding, which exp turns into up to
# |l| ulp(1)): a random walk over 128 lanes, measured at most 4e-6 over
# these pixels; 1e-5 is ~170 ulps.  Where float64 T lies below the normal
# range (Q < -87) the float32 carry runs through denormals: each lane may
# add one denormal ulp, 2^-149.
CARRY_REL = 1e-5
# (alpha range, pixels' q_b: all above the log-space walk, all below it)
CARRY_CASES = [((ALPHA_FLOOR, 0.2), "above"), ((ALPHA_FLOOR, ALPHA_CAP), "below"),
               ((0.5, ALPHA_CAP), "below")]


def _bf16_np(x):
    u = x.view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32).view(np.float32)


def _fma_np(a, b, c):
    """fmaf: the float32 product is exact in float64, one rounding after."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _exp_small_np(d):
    f = np.float32
    return _fma_np(d, _fma_np(d, _fma_np(d, f(1.0 / 6.0), f(0.5)), f(1.0)), f(1.0))


def _log1m_np(alpha):
    """blend_common.cuh log1m_bf16: l, bf16(l), d = l - bf16(l) (exact)."""
    l = np.log1p(-alpha)
    lb = _bf16_np(l)
    return l, lb, l - lb


def _carry_fwd_np(alpha):
    """T [N, K] of the packed forward's carry and each pixel's q_b [N]."""
    n, k = alpha.shape
    e, q, t = np.ones(n, np.float32), np.zeros(n, np.float32), np.empty_like(alpha)
    for j in range(k):
        l, lb, d = _log1m_np(alpha[:, j])
        q = q + lb
        t[:, j] = e * _exp_small_np(-d)
        e = t[:, j] * (np.float32(1.0) - alpha[:, j])
    return t, q


def _carry_bwd_np(alpha, q_b):
    """T [N, K] of the packed backward's walk from q_b, back to front."""
    q = q_b.copy()
    e = np.where(q < LOG_WALK, np.float32(0.0), np.exp(q)).astype(np.float32)
    t = np.empty_like(alpha)
    for j in range(alpha.shape[1] - 1, -1, -1):
        l, lb, d = _log1m_np(alpha[:, j])
        inv = np.float32(1.0) / (np.float32(1.0) - alpha[:, j])
        walk = q < LOG_WALK
        t[:, j] = np.where(walk, np.exp(q - l), e * inv)
        q = np.where(walk, q - lb, q)
        e = t[:, j] * _exp_small_np(d)
    return t


def _exp_q_minus_l64(alpha, q_end=None):
    """float64 exp(Q_k - l_k) over the float32 l and its bf16 terms: Q_k
    summed from 0 (the forward) or walked back from q_end (the backward,
    Q_k = q_end - sum_{j > k} bf16(l_j))."""
    l, lb, _ = _log1m_np(alpha)
    lb = lb.astype(np.float64)
    if q_end is None:
        q = np.cumsum(lb, 1)
    else:
        q = q_end.astype(np.float64)[:, None] - (np.cumsum(lb[:, ::-1], 1)[:, ::-1] - lb)
    return np.exp(q - l)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("alphas,q_b_side", CARRY_CASES)
def test_packed_t_carry_within_float64(direction, alphas, q_b_side):
    """The float32 model of the packed kernels' T carry, 2048 pixels of 128
    kept lanes with seeded alpha, within CARRY_REL of float64 exp(Q - l)
    (plus 2^-149 per lane where T is denormal), and within the same bar as
    the first packed design's float32 exp(Q - l); the backward starts from
    the modelled forward's q_b, on both sides of the log-space walk."""
    rng = np.random.default_rng(int(alphas[0] * 1000) + 7)
    alpha = rng.uniform(*alphas, (2048, 128)).astype(np.float32)
    t_fwd, q_b = _carry_fwd_np(alpha)
    assert bool((q_b < LOG_WALK).all() if q_b_side == "below" else (q_b >= LOG_WALK).all())
    if direction == "fwd":
        got, want = t_fwd, _exp_q_minus_l64(alpha)
        l, lb, _ = _log1m_np(alpha)
        first = np.exp(np.cumsum(lb, 1, dtype=np.float32) - l)    # the first packed design
    else:
        got, want = _carry_bwd_np(alpha, q_b), _exp_q_minus_l64(alpha, q_b)
        first = None
    bar = CARRY_REL * want + 2.0 ** -149 * alpha.shape[1]
    assert np.isfinite(got).all() and (got >= 0).all()
    worst = np.abs(got - want) / bar
    assert worst.max() <= 1.0, (worst.max(), np.unravel_index(worst.argmax(), worst.shape))
    if first is not None:
        assert (np.abs(first - want) / bar).max() <= 1.0
    if q_b_side == "below":     # the walk crosses -60: both regimes ran
        assert (np.log(np.maximum(want, 1e-300)) >= LOG_WALK).any()


# ---------------------------------------------------- renders, gradients


def _weights(seed, h=48, w=64):
    return np.random.default_rng(seed).uniform(0.5, 1.0, (h, w, 3)).astype(np.float32)


def _jax_loss(tr, w, jp, jc, jcfg):
    img, _ = jrender(jp.replace(**tr), jc, jcfg)
    return jnp.sum(img * w), img


_jax_grad = jax.jit(jax.grad(_jax_loss, has_aux=True), static_argnums=4)


def _both(seed, **kw):
    """(JAX image, JAX grads, port image, port grads) of one config."""
    jp, tp = scene_params(seed, n=48)
    jc, tc = cameras()
    jcfg, tcfg = _cfgs(**kw)
    w = _weights(seed)
    jg, jimg = _jax_grad({f: getattr(jp, f) for f in FIELDS}, jnp.asarray(w), jp, jc, jcfg)
    img, aux = render(tp, tc, tcfg)
    tg = torch.autograd.grad((img * torch.from_numpy(w)).sum(), [getattr(tp, f) for f in FIELDS])
    assert not bool(aux.overflow)
    return (np.asarray(jimg), {f: np.asarray(jg[f]) for f in FIELDS}, t2n(img),
            dict(zip(FIELDS, (t2n(g) for g in tg))))


def _gap(a, b, bar):
    d = np.abs(a - b)
    return d.mean(), (d > bar).mean()


@pytest.mark.parametrize("mode", list(MODES))
def test_bf16_render_and_grads_match_jax(mode):
    """The bf16 render and its parameter gradients against JAX's, held to
    a tenth of the port's own f32-vs-bf16 gap in mean |diff| and in the
    share of entries off by more than 1e-4 (of the field's largest, for
    gradients); the gap itself within JAX's bars."""
    _, _, img32, g32 = _both(61)
    jimg, jg, img, tg = _both(61, **MODES[mode])
    gap = np.abs(img - img32)
    assert gap.max() < IMG_MAX and gap.mean() < IMG_MEAN
    g_mean, g_share = _gap(img, img32, 1e-4)
    p_mean, p_share = _gap(img, jimg, 1e-4)
    assert g_mean > 0 and g_share > 0
    assert p_mean <= GAP_SHARE * g_mean and p_share <= GAP_SHARE * g_share, (
        p_mean, g_mean, p_share, g_share)
    for f in FIELDS:
        scale = np.abs(g32[f]).max()
        assert np.isfinite(tg[f]).all(), f
        assert np.abs(tg[f] - g32[f]).max() < GRAD_REL * scale, f
        g_mean, g_share = _gap(tg[f], g32[f], 1e-4 * scale)
        p_mean, p_share = _gap(tg[f], jg[f], 1e-4 * scale)
        assert p_mean <= GAP_SHARE * g_mean, (f, p_mean, g_mean)
        assert p_share <= GAP_SHARE * g_share, (f, p_share, g_share)


def test_pack_positions_strips_stack_to_full():
    """pack_positions under tile_rows strips: the tile-relative positions
    use absolute tile rows (a wrong row0 would shift every splat by 16 px
    per strip row), so the strips stack to the full frame (atol 1e-5,
    tests/test_packing.py:205-229)."""
    _, tp = scene_params(62, n=48)
    _, tc = cameras(64, 64)
    _, cfg = _cfgs(**MODES["pack_pos"])
    with torch.no_grad():
        full, _ = render(tp, tc, cfg)
        strips = [render(tp, tc, cfg, tile_rows=(r, 2))[0] for r in (0, 2)]
    np.testing.assert_allclose(t2n(torch.cat(strips))[:64], t2n(full), atol=1e-5)


@pytest.mark.parametrize("mode", list(MODES))
def test_bf16_tfloor_render_equals_f32_tfloor(mode, monkeypatch):
    """The T-floor path ignores both flags, as JAX's does (rasterize.py:304):
    the bf16 T-floor render equals the f32 one bit for bit, and no packed
    wrapper runs."""
    _, tp = scene_params(63, n=48)
    _, tc = cameras()
    _, cfg = _cfgs(t_floor_exact=True)

    def refuse(*a, **k):
        raise AssertionError("the T-floor path ran a packed blend")

    monkeypatch.setattr(tblend, "windowed_blend_fwd_packed", refuse)
    with torch.no_grad():
        want, _ = render(tp, tc, cfg)
        got, _ = render(tp, tc, cfg.replace(**MODES[mode]))
    assert torch.equal(got, want)


def test_pack_positions_alone_is_ignored():
    """pack_positions without the bf16 payload changes nothing (JAX:
    rasterize.py:365)."""
    _, tp = scene_params(64, n=48)
    _, tc = cameras()
    _, cfg = _cfgs()
    with torch.no_grad():
        assert torch.equal(render(tp, tc, cfg)[0],
                           render(tp, tc, cfg.replace(pack_positions=True))[0])


# ----------------------------------------------- impact drop and scatter


@pytest.mark.parametrize("seed", [71, 72])
def test_impact_drop_matches_jax_under_overflow(seed):
    """overflow_drop="impact" under a forced overflow: counts, chunk
    offsets, total and overflow integer-exact against JAX's capacity_plan
    (tests/test_pairs.py:159-190); the survivors the maximal descending
    opacity x tiles prefix that fits; without overflow the plan equals the
    "index" plan."""
    jp, _ = scene_params(seed, n=64, spread=0.7)
    jc, _ = cameras()
    jcfg, _ = _cfgs()
    proj_p, _ = jax_presorted_inputs(jp, jc, jcfg)
    tp = _to_port(proj_p)
    full = jpairs.capacity_plan(proj_p, 4, 3, 1 << 20, jnp.int32(0))
    cap = int(full[5]) // 3
    for c in (cap, 1 << 20):
        want = jpairs.capacity_plan(proj_p, 4, 3, c, jnp.int32(0), "impact")
        got = tpairs.capacity_plan(tp, 4, 3, c, 0, "impact")
        for name, a, b in zip(("counts", "ccounts", "coffsets", "ty_lo", "span_x", "total",
                               "overflow"), want, got):
            np.testing.assert_array_equal(t2n(b), np.asarray(a), err_msg=name)
    got = tpairs.capacity_plan(tp, 4, 3, cap, 0, "impact")
    index = tpairs.capacity_plan(tp, 4, 3, cap, 0, "index")
    assert bool(got[6]) and int(got[5]) <= cap
    assert not torch.equal(got[0], index[0])       # another set survives
    unforced = tpairs.capacity_plan(tp, 4, 3, 1 << 20, 0, "impact")
    for a, b in zip(unforced, tpairs.capacity_plan(tp, 4, 3, 1 << 20, 0, "index")):
        assert torch.equal(a, b)


def test_impact_drop_render_and_grads_match_jax():
    """The impact drop composes with the render and its gradients: against
    JAX at the f32 render's bars (image 2e-5; gradients 1e-4 of the
    field's largest), overflowing on both."""
    jp, tp = scene_params(73, n=64, spread=0.7)
    jc, tc = cameras()
    jcfg, tcfg = configs(pair_capacity=64, overflow_drop="impact")
    w = _weights(73)
    jg, jimg = _jax_grad({f: getattr(jp, f) for f in FIELDS}, jnp.asarray(w), jp, jc, jcfg)
    img, aux = render(tp, tc, tcfg)
    assert bool(aux.overflow)
    tg = torch.autograd.grad((img * torch.from_numpy(w)).sum(), [getattr(tp, f) for f in FIELDS])
    np.testing.assert_allclose(t2n(img), np.asarray(jimg), atol=2e-5)
    for f, g in zip(FIELDS, tg):
        want = np.asarray(jg[f])
        assert np.abs(t2n(g) - want).max() <= 1e-4 * np.abs(want).max(), f


@pytest.mark.parametrize("packed", [0, 9])
def test_scatter_reduction_matches_jax(packed):
    """grad_reduce="scatter" against JAX's scatter-add, unpacked and with
    bf16-pair packed rows (tests/test_packing.py:64-87): the same f32 sums
    in aligned-lane order, bit for bit on the CPU."""
    rng = np.random.default_rng(80 + packed)
    n, a_cap = 13, 300
    gid = rng.integers(-1, n, a_cap).astype(np.int32)
    rows = rng.normal(size=(9, a_cap)).astype(np.float32)
    rows[:, gid < 0] = 0.0
    counts = np.bincount(gid[gid >= 0], minlength=n).astype(np.int32)
    if packed:
        rows = np.stack([np.asarray(c) for c in jpacking.pack_cols([jnp.asarray(r) for r in rows])])
    want = np.asarray(jpairs.reduce_aligned_cotangents(
        jnp.asarray(rows), jnp.asarray(gid), jnp.asarray(counts), n, "scatter",
        packed_out=packed))
    got = t2n(tpairs.reduce_aligned_cotangents(
        torch.from_numpy(rows.copy()), torch.from_numpy(gid), torch.from_numpy(counts), n,
        "scatter", packed_out=packed))
    assert got.shape == (n, 9)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_render_with_scatter_reaches_the_scatter(mode, monkeypatch):
    """RasterConfig(grad_reduce="scatter") reaches the reduction (it used to
    run the sort-prefix form without a word), and its gradients equal JAX's
    scatter render's at the port-vs-JAX bars (f32: 1e-4 of the field's
    largest; bf16: a tenth of the f32-vs-bf16 gap in mean |diff|)."""
    seen = []
    reduce = tpairs.reduce_aligned_cotangents

    def spy(*a, **k):
        seen.append((a[4], k.get("packed_out", 0)))
        return reduce(*a, **k)

    monkeypatch.setattr(tpairs, "reduce_aligned_cotangents", spy)
    kw = dict(grad_reduce="scatter", **({} if mode == "f32" else MODES["bf16"]))
    jimg, jg, img, tg = _both(81, **kw)
    assert seen == [("scatter", 0 if mode == "f32" else 9)]
    if mode == "f32":
        for f in FIELDS:
            assert np.abs(tg[f] - jg[f]).max() <= 1e-4 * np.abs(jg[f]).max(), f
        return
    _, g32, _, _ = _both(81)
    for f in FIELDS:
        assert np.abs(tg[f] - jg[f]).mean() <= GAP_SHARE * np.abs(tg[f] - g32[f]).mean(), f


def test_unknown_modes_are_refused():
    _, tp = scene_params(15, n=16)
    _, tc = cameras()
    for kw, needle in ((dict(payload_dtype="f16"), "payload_dtype"),
                       (dict(grad_reduce="atomic"), "grad_reduce"),
                       (dict(overflow_drop="depth"), "overflow_drop")):
        _, cfg = _cfgs(**kw)
        with pytest.raises(ValueError, match=needle):
            img, _ = render(tp, tc, cfg)
            img.sum().backward()
