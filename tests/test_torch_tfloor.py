"""The port's exact T-floor path (RasterConfig.t_floor_exact=True) against
the JAX package on the CPU: the plain T-floor blend forward and backward
against the Pallas ``block_blend_cols_tf`` and its VJP (interpret mode), the
JAX aligned blocks against the port's windows, the render, its gradients and
one train step against JAX's XLA T-floor path and the NumPy oracle; and the
CUDA T-floor kernels against their plain versions where a GPU is present.

JAX's aligned kernels evaluate the power with the monomial matmul and the
in-block prefix with a triangular matmul, the port directly and with a
cumsum.  Where a pixel's exclusive log T plus logti lands within rounding of
log(transmittance_floor), the two may terminate it at different lanes (a
flip, which moves that pixel's S_b by up to 4.6).  Every comparison below
asserts that the plain version's termination margin on its inputs is far
above that rounding, so no flip is excused: the seeds were chosen so."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gaussiansplatting_tpu.config import Config as JConfig
from gaussiansplatting_tpu.config import RasterConfig as JRasterConfig
from gaussiansplatting_tpu.core import gaussians as JG
from gaussiansplatting_tpu.ops import pairs as jpairs
from gaussiansplatting_tpu.ops import pallas_blend
from gaussiansplatting_tpu.ops import projection as jproj
from gaussiansplatting_tpu.ops.rasterize import render as jrender
from gaussiansplatting_tpu.train import state as jstate
from gaussiansplatting_tpu.train import trainer as jtrainer

from gaussiansplatting_tpu_torch.config import Config, RasterConfig
from gaussiansplatting_tpu_torch.core import gaussians as TG
from gaussiansplatting_tpu_torch.ops import blend as tblend
from gaussiansplatting_tpu_torch.ops import projection as tproj
from gaussiansplatting_tpu_torch.ops import rasterize as trast
from gaussiansplatting_tpu_torch.ops.rasterize import render
from gaussiansplatting_tpu_torch.train import schedule as tsched
from gaussiansplatting_tpu_torch.train import state as tstate
from gaussiansplatting_tpu_torch.train import trainer as ttrainer
from gaussiansplatting_tpu_torch.utils import tracing

from chip_smoke import edge_logti, edge_windows
from conftest import make_scene
from reference_renderer import render_reference
from test_torch_train import TRAINABLE, _compare_states, _jax_state_arrays
from torch_parity import cameras, scene_params, t2n

torch.set_num_threads(1)

TS, TILES_X, TILES_Y = 16, 4, 3
P2 = TS * TS
CONSTS = (TS, -4.5, 0.99, 1.0 / 255.0, TILES_X)
LOG_THR = math.log(1e-4)
NB, BLOCK = 10, 16
# termination margins at least this far from log(1e-4) on the seeds used:
# far above the ~1e-5 by which the JAX and port prefix sums can differ
NO_FLIP_MARGIN = 1e-4
# plain vs JAX Pallas: out atol (the JAX package's own Pallas-vs-XLA image
# bar) and per column max |err| over the column's max magnitude.  JAX's
# monomial power form rounds up to 2.6e-5 apart in S_b (ROADMAP C), and
# dl / (1 - alpha) scales the suffix's rounding by up to 100 in the
# backward: measured <= 9.8e-6 in out (S_b; <= 1.8e-6 in C) and <= 1.31e-5
# of a column's max on these seeds, so the backward bar is 2e-5, not 5e-6
OUT_ATOL, COL_REL = 2e-5, 2e-5
# the image bar the JAX package holds both T-floor impls to against the
# oracle (tests/test_render_forward.py:112) and port vs JAX (2e-5)
ORACLE_ATOL, IMG_ATOL = 1e-5, 2e-5
# gradients: relative norm of the difference per group, as
# tests/test_torch_render_grad.py holds the non-T-floor render
REL_NORM = 1e-4
FIELDS = ("means", "log_scales", "quats", "raw_opacities", "sh")


def _windows_logti(seed, block=BLOCK, row0=0):
    """Edge-case windows (dead, full, unaligned, partial blocks) and a logti
    that terminates pixels before the block (logti <= log_thr), inside it
    and not at all."""
    table, src, valid, tile = edge_windows(block, seed, row0, nb=NB, ts=TS,
                                           tiles_x=TILES_X, tiles_y=TILES_Y)
    return table, src, valid, tile, edge_logti(NB, seed + 7, P2)


def _aligned_cols(table, src, valid, tile, row0, block):
    """The nine [NB, B] columns JAX's aligned path hands block_blend_cols_tf
    for the same pairs (rasterize.py:399-422): aligned block b = window b."""
    lane = np.arange(block)
    live = lane[None, :] < valid[:, None]
    idx = np.where(live, src[:, None] + lane, 0)
    w = np.where(live[None], table[:10, idx], 0.0).astype(np.float32)
    half = TS / 2.0
    tcx = ((tile % TILES_X) * TS + half).astype(np.float32)
    tcy = ((tile // TILES_X + row0) * TS + half).astype(np.float32)
    mag = np.abs(w[3]) + np.abs(w[4]) + np.abs(w[5])
    op = np.where(live & (mag >= 1e-4), w[6], 0.0).astype(np.float32)
    return (w[1] - tcx[:, None], w[2] - tcy[:, None], w[3], w[4], w[5], op,
            w[7], w[8], w[9])


def _torch(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("seed,row0", [(3, 0), (11, 1)])
def test_tf_plain_forward_matches_jax_kernel(seed, row0):
    table, src, valid, tile, logti = _windows_logti(seed, row0=row0)
    cols = _aligned_cols(table, src, valid, tile, row0, BLOCK)
    want = np.asarray(pallas_blend.block_blend_cols_tf(
        *(jnp.asarray(c) for c in cols), jnp.asarray(logti),
        CONSTS[:4] + (LOG_THR,)))
    with torch.no_grad():
        got, _, margin = tblend.windowed_blend_fwd_tf_plain(
            *_torch(table, src, valid, tile), row0, BLOCK, CONSTS,
            torch.from_numpy(logti), LOG_THR, return_margin=True)
        full, _ = tblend.windowed_blend_fwd_plain(
            *_torch(table, src, valid, tile), row0, BLOCK, CONSTS)
    got, full, margin = t2n(got), t2n(full), t2n(margin)
    assert margin.min() > NO_FLIP_MARGIN, "a termination flip is possible"
    np.testing.assert_allclose(got, want, atol=OUT_ATOL)
    # all three cases occur: terminated before the block (nothing left),
    # inside it (a partial S), never (the unmasked blend, bit for bit)
    kept = full[:, 3] < 0
    before = kept & (logti <= LOG_THR)
    inside = kept & (logti > LOG_THR) & (got[:, 3] > full[:, 3])
    never = kept & (got[:, 3] == full[:, 3])
    assert before.sum() > 100 and inside.sum() > 30 and never.sum() > 500
    assert (got[:, :, :][np.broadcast_to(before[:, None], got.shape)] == 0).all()
    np.testing.assert_array_equal(got[:, :, : P2 // 4], full[:, :, : P2 // 4])
    assert (got[0] == 0).all()                   # dead block


@pytest.mark.parametrize("seed,row0", [(3, 0), (11, 1)])
def test_tf_plain_backward_matches_jax_vjp(seed, row0):
    table, src, valid, tile, logti = _windows_logti(seed, row0=row0)
    g = np.random.default_rng(seed + 1).normal(size=(NB, 4, P2)).astype(np.float32)
    cols = _aligned_cols(table, src, valid, tile, row0, BLOCK)
    consts = CONSTS[:4] + (LOG_THR,)
    _, vjp = jax.vjp(
        lambda *c: pallas_blend.block_blend_cols_tf(*c, consts),
        *(jnp.asarray(c) for c in cols), jnp.asarray(logti))
    *want, want_logti = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    args = _torch(table, src, valid, tile) + [row0, BLOCK]
    with torch.no_grad():
        out, stop = tblend.windowed_blend_fwd_tf_plain(
            *args, CONSTS, torch.from_numpy(logti), LOG_THR)
    got, margin = tblend.windowed_blend_bwd_tf_plain(
        *args, torch.from_numpy(g), out[:, 3].contiguous(), stop, CONSTS,
        torch.from_numpy(logti), LOG_THR, return_margin=True)
    assert t2n(margin).min() > NO_FLIP_MARGIN, "a termination flip is possible"
    assert (want_logti == 0).all()
    names = ("mx", "my", "a", "b", "c", "op", "r", "g", "b")
    for name, a, b in zip(names, (t2n(c) for c in got), want):
        b = np.where(np.arange(BLOCK)[None, :] < valid[:, None], b, 0.0)
        err, scale = np.abs(a - b).max(), np.abs(b).max()
        assert scale > 0 and err <= COL_REL * scale, f"d{name}: {err} of {scale}"
    # g_S reaches surviving lanes only: with logti at the floor everywhere,
    # nothing survives and every cotangent is zero
    floor = torch.full((NB, P2), LOG_THR)
    with torch.no_grad():
        out, stop = tblend.windowed_blend_fwd_tf_plain(*args, CONSTS, floor, LOG_THR)
    assert (stop == 0).all() and (out == 0).all()
    none = tblend.windowed_blend_bwd_tf_plain(
        *args, torch.from_numpy(g), out[:, 3].contiguous(), stop, CONSTS, floor,
        LOG_THR)
    assert all(bool((c == 0).all()) for c in none)


@pytest.mark.parametrize("seed,row0", [(3, 0), (11, 1)])
def test_tf_plain_stop_lanes_end_the_survivors(seed, row0):
    """The plain T-floor forward's stop lane is one past each pixel's last
    surviving lane: against the unmasked replay, every kept lane before it
    arrives above the floor (float64 prefix), every kept lane at or past it
    at or below, lane stop - 1 is kept, and S_b sums exactly the kept lanes
    before it.  All three cases occur: stopped before the block (0), inside
    it, and never."""
    table, src, valid, tile, logti = _windows_logti(seed, row0=row0)
    args = _torch(table, src, valid, tile) + [row0, BLOCK]
    with torch.no_grad():
        out, stop = tblend.windowed_blend_fwd_tf_plain(
            *args, CONSTS, torch.from_numpy(logti), LOG_THR)
        r = tblend._replay(*args, CONSTS, 0, NB)                    # unmasked
    kept = t2n(r.alpha) > 0                                         # [NB, P2, B]
    l = t2n(r.log1m).astype(np.float64)
    arrive = np.cumsum(l, -1) - l + logti[:, :, None]
    stop = t2n(stop)
    assert stop.dtype == np.int32
    before = np.arange(BLOCK)[None, None, :] < stop[:, :, None]
    assert (arrive[kept & before] > LOG_THR).all()
    assert (arrive[kept & ~before] <= LOG_THR).all()
    last = np.take_along_axis(kept, np.maximum(stop - 1, 0)[:, :, None], -1)[..., 0]
    assert last[stop > 0].all()
    np.testing.assert_allclose(t2n(out)[:, 3], np.where(kept & before, l, 0).sum(-1),
                               atol=1e-5)
    ends = kept.any(-1)
    stopped = kept & ~before
    assert (ends & (stop == 0)).sum() > 100
    assert (stopped.any(-1) & (stop > 0)).sum() > 30
    assert (ends & ~stopped.any(-1)).sum() > 500


def test_tf_plain_without_termination_is_the_plain_blend():
    """logti = 0 and a floor no S reaches: the T-floor pass is the plain
    forward and backward, bit for bit; chunking changes no bit either."""
    table, src, valid, tile, _ = _windows_logti(9)
    args = _torch(table, src, valid, tile) + [0, BLOCK]
    g = torch.from_numpy(np.random.default_rng(9).normal(size=(NB, 4, P2)).astype(np.float32))
    zero = torch.zeros((NB, P2))
    before = tracing.launch_counts()
    with torch.no_grad():
        out, _ = tblend.windowed_blend_fwd_plain(*args, CONSTS)
        out_tf, stop = tblend.windowed_blend_fwd_tf(*args, CONSTS, zero, -1e4)
        out_tf3, stop3 = tblend.windowed_blend_fwd_tf_plain(*args, CONSTS, zero, -1e4,
                                                            chunk_blocks=3)
    assert torch.equal(out, out_tf) and torch.equal(out, out_tf3)
    assert torch.equal(stop, stop3) and stop.dtype == torch.int32
    d = tblend.windowed_blend_bwd_plain(*args, g, out[:, 3], CONSTS)
    d_tf = tblend.windowed_blend_bwd_tf(*args, g, out_tf[:, 3].contiguous(), stop,
                                        CONSTS, zero, -1e4)
    assert all(torch.equal(a, b) for a, b in zip(d, d_tf))
    after = tracing.launch_counts()     # the CPU runs plain
    assert after["windowed_blend_fwd_tf"] == before["windowed_blend_fwd_tf"]
    assert after["windowed_blend_bwd_tf"] == before["windowed_blend_bwd_tf"]


@pytest.mark.parametrize("seed", [31, 32])
def test_jax_aligned_blocks_are_the_port_windows(seed):
    """JAX's build_pair_rows (the aligned path's destination sort) and the
    port's windows: the same Gaussian in every lane of every block (the
    port's ids are presorted, mapped back through its depth order) and the
    same block tiles, exactly."""
    jp, tp = scene_params(seed, n=48)
    jc, tc = cameras()
    jcfg = JRasterConfig(pair_capacity=2048, pair_block=16, t_floor_exact=True)
    cfg = RasterConfig(pair_capacity=2048, pair_block=16, t_floor_exact=True)
    proj = jproj.project(jp, jc, jcfg)
    data = jnp.concatenate([proj.screen_pos, proj.conic, proj.opacity[:, None],
                            jnp.clip(proj.color, 0.0, 1.0)], axis=-1)
    tiles_x, tiles_y = jproj.num_tiles(64, 16), jproj.num_tiles(48, 16)
    rows = jpairs.build_pair_rows(proj, data, tiles_x, tiles_y,
                                  jcfg.pair_capacity, jcfg.pair_block)
    want_gid = np.asarray(rows.gaussian_id).reshape(-1, 16)
    want_tile = np.asarray(rows.block_tile)

    with torch.no_grad():
        plan = trast._plan(tp, tc, cfg)
        win = trast._windows(plan.data, plan.ints, plan.pcfg)
        order = torch.argsort(tproj.project(tp, tc, cfg).depth, stable=True)
    lane = torch.arange(16)
    live = lane[None, :] < win.block_valid[:, None]
    idx = torch.where(live, win.block_src[:, None].long() + lane, 0)
    presorted = win.table[0, idx].long()
    got_gid = torch.where(live, order[presorted], -1).numpy()
    got_tile = t2n(win.block_tile)
    assert got_gid.shape == want_gid.shape and (want_gid >= 0).sum() > 100
    np.testing.assert_array_equal(got_tile, want_tile)
    np.testing.assert_array_equal(got_gid, want_gid)


def _dense_scene(seed=1234):
    """The dense near-opaque scene of tests/test_render_forward.py:93-96,
    where transmittance crosses the 1e-4 floor: (jax params, torch params,
    the scene's arrays)."""
    rng = np.random.default_rng(seed)
    means, log_scales, quats, raw_op, sh_dc = make_scene(rng, n=256, spread=0.15)
    raw_op = raw_op + 4.0
    sh = np.zeros((256, 4, 3), np.float32)
    sh[:, 0, :] = sh_dc
    return (JG.from_arrays(means, log_scales, quats, raw_op, sh),
            TG.from_arrays(means, log_scales, quats, raw_op, sh),
            (means, log_scales, quats, raw_op, sh_dc))


def _tf_configs(**kw):
    kw = dict(pair_capacity=4096, pair_block=16, t_floor_exact=True, **kw)
    return JRasterConfig(**kw, blend_impl="xla"), RasterConfig(**kw)


def test_tfloor_render_matches_jax_and_terminates():
    jp, tp, _ = _dense_scene()
    jc, tc = cameras(32, 32)
    jcfg, tcfg = _tf_configs()
    img_j, aux_j = jax.jit(jrender, static_argnums=2)(jp, jc, jcfg)
    with torch.no_grad():
        img, aux = render(tp, tc, tcfg)
        img_off, _ = render(tp, tc, tcfg.replace(t_floor_exact=False))
    img, img_off = t2n(img), t2n(img_off)
    assert int(aux.num_pairs) == int(aux_j.num_pairs) > 0
    np.testing.assert_allclose(img, np.asarray(img_j), atol=IMG_ATOL)
    # termination triggers; the tail it skips sums to at most T_stop per
    # channel, so the image moves by less than 1.5e-4
    assert 1e-5 < np.abs(img - img_off).max() <= 1.5e-4


def test_tfloor_render_matches_numpy_oracle():
    """The oracle terminates each pixel at T <= 1e-4 as the reference does;
    with the T-floor the port reproduces it to float32 noise."""
    _, tp, scene = _dense_scene()
    jc, tc = cameras(32, 32)
    with torch.no_grad():
        img, _ = render(tp, tc, _tf_configs()[1])
    ref = render_reference(
        *scene, np.asarray(jc.view, np.float64), np.asarray(jc.viewproj, np.float64),
        float(jc.fx), float(jc.fy), jc.width, jc.height,
    )
    assert np.abs(t2n(img) - ref).max() < ORACLE_ATOL


def test_tfloor_mode_renders_with_and_without_grad():
    """t_floor_exact is ported: render returns the same image with grad
    enabled (attached through _BlendWindowsTF) and under no_grad."""
    _, tp, _ = _dense_scene(7)
    _, tc = cameras(32, 32)
    img, aux = render(tp, tc, _tf_configs()[1])
    assert img.requires_grad and int(aux.num_pairs) > 0
    with torch.no_grad():
        img_ng, _ = render(tp, tc, _tf_configs()[1])
    assert torch.equal(img.detach(), img_ng)


def test_tfloor_render_grads_match_jax():
    """All five parameter groups and vs_dummy, sum(img * w) loss, against
    jax.grad of the JAX XLA T-floor render (mask held constant in both)."""
    jp, tp, _ = _dense_scene()
    jc, tc = cameras(32, 32)
    jcfg, tcfg = _tf_configs()
    w = np.random.default_rng(4).uniform(0.5, 1.0, (32, 32, 3)).astype(np.float32)
    vs = np.zeros((256, 2), np.float32)

    def jloss(tr, vs_):
        img, _ = jrender(jp.replace(**tr), jc, jcfg, vs_dummy=vs_)
        return jnp.sum(img * w)

    want, want_vs = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        {f: getattr(jp, f) for f in FIELDS}, jnp.asarray(vs))
    want = {**{f: np.asarray(want[f]) for f in FIELDS}, "vs": np.asarray(want_vs)}
    vs_t = torch.from_numpy(vs).requires_grad_(True)
    img, _ = render(tp, tc, tcfg, vs_dummy=vs_t)
    gs = torch.autograd.grad((img * torch.from_numpy(w)).sum(),
                             [getattr(tp, f) for f in FIELDS] + [vs_t])
    for k, g in zip(FIELDS + ("vs",), gs):
        a, b = t2n(g), want[k]
        assert np.isfinite(a).all() and np.abs(b).max() > 0, k
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel < REL_NORM, f"{k}: relative norm {rel}"


# a view-space gradient norm below this fraction of the largest is float
# noise (see test_tfloor_train_step_matches_jax)
VS_NOISE_REL = 1e-7


def test_tfloor_train_step_matches_jax():
    """One full T-floor train step (render, D-SSIM loss, gradient, Adam,
    density statistics) from one carried-over TrainState, at the bars of
    tests/test_torch_train.py, with one stated exception.

    A Gaussian behind every pixel's floor gets, in exact arithmetic, no
    gradient: its pairs are masked in the second pass, and its first-pass
    S_b only reaches the t_in of later blocks of its tile, whose T-floor
    colour is zero.  JAX takes t_in from a global float32 cumsum minus its
    value at the tile's first block, whose transpose cancels the other
    tiles' terms: a residue of ~2e-8 (of a largest view-space gradient ~1)
    survives, so density's grad_count (|grad| > 0) may count such a
    Gaussian in JAX alone.  The port sums each tile's blocks on their own
    (ops.compose), so its gradient there is exactly 0.
    Those entries must be noise in JAX (<= VS_NOISE_REL of the largest) and
    exactly 0 in the port; every other grad_count entry must match
    exactly."""
    jp, _, _ = _dense_scene()
    jc, tc = cameras(32, 32)
    jr, tr = _tf_configs()
    jcfg, tcfg = JConfig(raster=jr), Config(raster=tr)
    gt = np.random.default_rng(6).uniform(0, 1, (32, 32, 3)).astype(np.float32)
    js = jstate.create(jp)
    ts = tstate.state_from_numpy(_jax_state_arrays(js))
    js, jm = jtrainer.train_step(js, jc, jnp.asarray(gt), jcfg, 100)
    ts, tm = ttrainer.train_step(ts, tc, torch.from_numpy(gt), tcfg, 100)
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-5)
    assert int(tm.num_pairs) == int(jm.num_pairs) and not bool(tm.overflow)
    got, want = tstate.state_to_numpy(ts), _jax_state_arrays(js)
    differ = got["accum/grad_count"] != want["accum/grad_count"]
    vs_mag = want["accum/grad_accum"]        # one step from zero: |vs grad|
    assert (vs_mag[differ] <= VS_NOISE_REL * vs_mag.max()).all()
    assert (got["accum/grad_accum"][differ] == 0).all()
    want["accum/grad_count"] = np.where(differ, got["accum/grad_count"],
                                        want["accum/grad_count"])
    lr0 = tsched.learning_rates(tcfg.optim, 0, 100)
    _compare_states(got, want, 1, dict(zip(TRAINABLE, lr0)))


@pytest.mark.cuda
@pytest.mark.parametrize("block", [16, 128])
def test_tf_kernels_match_plain_cuda(block):
    """The CUDA T-floor kernels against their plain versions on the card
    under chip_smoke's flip rule (forward within KERNEL_ATOL/RTOL, backward
    within BWD_REL of each column's max, entries beyond excused only at a
    termination margin below FLIP_MARGIN); the backward bit-identical on
    a second launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from chip_smoke import _compare_tf, _compare_tf_bwd

    table, src, valid, tile, logti = _windows_logti(80 + block, block=block)
    g = np.random.default_rng(block).normal(size=(NB, 4, P2)).astype(np.float32)
    dev = [torch.from_numpy(x).cuda() for x in (table, src, valid, tile, logti, g)]
    args = dev[:4] + [0, block]
    with torch.no_grad():
        want, _, margin = tblend.windowed_blend_fwd_tf_plain(
            *args, CONSTS, dev[4], LOG_THR, return_margin=True)
        before = tracing.launch_counts()["windowed_blend_fwd_tf"]
        got, stop = tblend.windowed_blend_fwd_tf(*args, CONSTS, dev[4], LOG_THR)
    assert tracing.launch_counts()["windowed_blend_fwd_tf"] == before + 1
    _compare_tf(f"B={block}", got, want, margin)
    bargs = args + [dev[5], got[:, 3].contiguous(), stop, CONSTS, dev[4], LOG_THR]
    d_got = tblend.windowed_blend_bwd_tf(*bargs)
    d_again = tblend.windowed_blend_bwd_tf(*bargs)
    d_want = tblend.windowed_blend_bwd_tf_plain(*bargs)
    _compare_tf_bwd(f"B={block}", d_got, d_want, margin)
    for a, b in zip(d_got, d_again):
        assert torch.equal(a, b)
