"""Compose (ops/compose.py, csrc/compose.cu, ops/rasterize._Compose): the
plain forward and the plain per-tile backward against float64 autograd
through the straightforward per-tile math, over both backgrounds, a strip
with padded rows, the T-floor composition, empty tiles, a tile of over
1,000 blocks and padding blocks (which must get zero cotangent); logti
within one float32 ulp of a float64 per-tile prefix; exactly 0 behind a
zero tail.  On the card: the kernels against the plain versions at the
benchmark cells' block counts (18,284 and 67,400 blocks over the 800x608
frame's 1,900 tiles), the T-floor mode, two launches giving the same bits,
and the graphs' launch counts.

No JAX here: on the machine with the card this file runs alone,
``python -m pytest --noconftest tests/test_torch_compose.py``.
"""

import types

import numpy as np
import pytest
import torch

from gaussiansplatting_tpu_torch.ops import compose as tcompose
from gaussiansplatting_tpu_torch.ops import rasterize as traster

torch.set_num_threads(1)

TS, P2 = 16, 256
IMG_ATOL = 1e-5          # plain float32 forward against float64
KERNEL_IMG_ATOL = 2e-6   # kernel against the plain version on the card
REL_NORM = 1e-6          # cotangents against float64


def _blocks(seed, tx, ty, counts, pad):
    """out [NB, 4, P2] float32 of blend-like summaries (S_b scaled so a
    tile's total log T stays near -2, C_b = (1 - e^S_b) x a colour) in
    tiles of ``counts`` blocks each, then ``pad`` padding blocks (tile id
    tx * ty) holding random summaries; seg [NB] int32."""
    rng = np.random.default_rng(seed)
    nt = tx * ty
    seg = np.concatenate([np.repeat(np.arange(nt), counts), np.full(pad, nt)]).astype(np.int32)
    depth = np.maximum(np.r_[counts, 1][np.minimum(seg, nt)], 1)[:, None]
    s_b = -rng.uniform(0.0, 4.0, (seg.size, P2)) / depth
    c_b = (1.0 - np.exp(s_b))[:, None, :] * rng.uniform(0.0, 1.0, (seg.size, 3, P2))
    out = np.concatenate([c_b, s_b[:, None, :]], axis=1).astype(np.float32)
    return torch.from_numpy(out), torch.from_numpy(seg)


def _small_case(seed, tf):
    """6 x 4 tiles: two empty, one of 1,100 blocks, 40 padding blocks; with
    ``tf`` a second pass of its own summaries."""
    counts = np.random.default_rng(seed).integers(1, 12, 24)
    counts[[3, 17]] = 0
    counts[9] = 1_100
    out, seg = _blocks(seed, 6, 4, counts, 40)
    out_tf = _blocks(seed + 1, 6, 4, counts, 40)[0] if tf else None
    return out, out_tf, seg


def _reference(out, out_tf, seg, consts):
    """The image tile by tile in out's dtype: each block's incoming log T
    the cumulative sum of S_b over its tile's earlier blocks, the colour
    sum of exp(that) C_b, bg exp(sum S_b); cropped to [rows, width]."""
    ts, tx, ty, width, rows, bg = consts
    src = out if out_tf is None else out_tf
    bounds = np.searchsorted(seg.numpy(), np.arange(tx * ty + 1))
    tiles = []
    for t in range(tx * ty):
        a, b = int(bounds[t]), int(bounds[t + 1])
        s1 = out[a:b, 3]
        t_in = torch.exp(torch.cumsum(s1, 0) - s1)
        color = (t_in[:, None, :] * src[a:b, :3]).sum(0)
        tiles.append(color + torch.exp(src[a:b, 3].sum(0))[None, :] * bg)
    img = torch.stack(tiles).reshape(ty, tx, 3, ts, ts).permute(0, 3, 1, 4, 2)
    return img.reshape(ty * ts, tx * ts, 3)[:rows, :width]


def _rel_norm(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _ulps_off(got, ref):
    """|got - ref| in float32 ulps of max(|ref|, 1)."""
    ref = ref.double()
    unit = np.spacing(np.maximum(np.abs(ref.cpu().numpy()), 1.0).astype(np.float32))
    return (got.double() - ref).abs().cpu().numpy() / unit.astype(np.float64)


CASES = {  # background, strip (padded rows kept), T-floor composition
    "white": (1.0, False, False),
    "black": (0.0, False, False),
    "strip": (1.0, True, False),
    "tfloor": (1.0, False, True),
    "tfloor_black_strip": (0.0, True, True),
}


def _consts(case):
    bg, strip, _ = CASES[case]
    return (TS, 6, 4, 6 * TS - 5, 4 * TS if strip else 4 * TS - 3, bg)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_compose_matches_float64_autograd(case):
    """The Function's CPU path (plain forward, plain backward) against
    float64 autograd of the per-tile math: the image within IMG_ATOL, each
    pass's cotangent within REL_NORM, padding blocks' cotangents exactly 0,
    and with the T-floor the first pass's colour rows exactly 0."""
    tf = CASES[case][2]
    out, out_tf, seg = _small_case(7, tf)
    consts = _consts(case)
    w = torch.from_numpy(np.random.default_rng(8).uniform(
        -1.0, 1.0, (consts[4], consts[3], 3)).astype(np.float32))
    leaves = [x.clone().requires_grad_(True) for x in (out, out_tf) if x is not None]
    img = traster._Compose.apply(leaves[0], leaves[1] if tf else None, seg, consts)
    got = torch.autograd.grad((img * w).sum(), leaves)
    leaves64 = [x.double().requires_grad_(True) for x in (out, out_tf) if x is not None]
    ref = _reference(leaves64[0], leaves64[1] if tf else None, seg, consts)
    want = torch.autograd.grad((ref * w.double()).sum(), leaves64)
    assert img.shape == (consts[4], consts[3], 3) and img.dtype == torch.float32
    np.testing.assert_allclose(img.detach().numpy(), ref.detach().numpy(), atol=IMG_ATOL)
    pad = seg == 24
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and _rel_norm(a, b) < REL_NORM
        assert (a[pad] == 0).all()
    if tf:
        assert (got[0][:, :3] == 0).all()
    # a tile of over 1,000 blocks, empty tiles showing the background
    assert int((seg == 9).sum()) > 1_000
    tile = img.detach()[0:TS, 3 * TS:4 * TS]
    assert (tile == consts[5]).all()


def test_compose_logti_within_one_ulp_of_float64():
    """compose_logti (on the CPU incoming_log_t) within one float32 ulp of
    max(|ref|, 1) of a float64 per-tile prefix, the 1,100-block tile
    included."""
    out, _, seg = _small_case(9, False)
    got = tcompose.compose_logti(out, seg, _consts("white"))
    s = out[:, 3].double()
    ref = torch.zeros_like(s)
    bounds = np.searchsorted(seg.numpy(), np.arange(26))
    for t in range(25):
        a, b = int(bounds[t]), int(bounds[t + 1])
        ref[a:b] = torch.cumsum(s[a:b], 0) - s[a:b]
    assert got.dtype == torch.float32 and _ulps_off(got, ref).max() <= 1.0
    assert ref[seg == 9].min() < -1.0


def _zero_tail(out, out_tf, seg, seed):
    """Zero C_b of the pass that gives the colour from a random block of
    each (tile, pixel) on; returns the summaries and the mask of the
    (block, pixel) entries whose later blocks in the tile are all zero."""
    src = (out if out_tf is None else out_tf).clone()
    rng = np.random.default_rng(seed)
    s = seg.numpy()
    tail = np.zeros((s.size, P2), bool)
    bounds = np.searchsorted(s, np.arange(26))
    for t in range(24):
        a, b = bounds[t], bounds[t + 1]
        cut = rng.integers(a, b + 1, P2)
        tail[a:b] = np.arange(a, b)[:, None] >= cut[None, :]
    src[:, :3] = torch.where(torch.from_numpy(tail)[:, None, :], 0.0, src[:, :3])
    behind = tail | (np.roll(tail, -1, axis=0) & (np.roll(s, -1) == s)[:, None])
    return (src, out_tf) if out_tf is None else (out, src), torch.from_numpy(behind)


@pytest.mark.parametrize("case", ["black", "tfloor"])
def test_compose_bwd_exactly_zero_behind_a_zero_tail(case):
    """A block whose tile's later blocks all carry zero colour (behind the
    T-floor) gets exactly 0 in the cotangent of its S_b through t_in."""
    tf = CASES[case][2]
    out, out_tf, seg = _small_case(11, tf)
    (out, out_tf), behind = _zero_tail(out, out_tf, seg, 12)
    consts = _consts(case)
    g = torch.from_numpy(np.random.default_rng(13).normal(
        size=(consts[4], consts[3], 3)).astype(np.float32))
    d_out, _ = tcompose.compose_bwd(g, out, out_tf, seg, consts)
    assert behind.sum() > 10_000 and (d_out[:, 3][behind] == 0).all()
    assert (d_out[:, 3][~behind & (seg < 24)[:, None]] != 0).double().mean() > 0.9


def test_compose_counters_round_trip():
    """The plain versions launch nothing; the counters a replay adds to, by
    name, folded into train/graph.py's accounting."""
    from gaussiansplatting_tpu_torch.train import graph as tgraph

    before = tgraph.launch_counts()
    assert {"compose_fwd", "compose_logti", "compose_bwd"} <= set(before)
    out, _, seg = _small_case(3, False)
    tcompose.compose_fwd(out, None, seg, _consts("white"))
    assert tgraph.launch_counts() == before
    tgraph.add_launches({"compose_fwd": 2, "compose_bwd": 1, "windowed_blend_fwd": 1})
    after = tgraph.launch_counts()
    assert after["compose_fwd"] - before["compose_fwd"] == 2
    assert after["compose_bwd"] - before["compose_bwd"] == 1
    assert after["windowed_blend_fwd"] - before["windowed_blend_fwd"] == 1
    tgraph.add_launches({k: before[k] - after[k] for k in before})
    assert tgraph.launch_counts() == before


# -- on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the compose kernels have no CPU mode")
    return torch.device("cuda")


def _frame(nb, seed):
    """The 800x608 frame's 50 x 38 tiles with ``nb`` blocks in all: tile
    counts drawn around a mean of 16 (nb = 67,400: about 30k live blocks,
    one tile of 1,200, the rest padding, as a garden frame at 2^23 pairs;
    nb = 18,284: about 17k live, as the 100k scene at 2^21)."""
    rng = np.random.default_rng(seed)
    live = 30_000 if nb > 20_000 else 17_000
    counts = rng.poisson(live / 1900, 1900)
    counts[rng.integers(0, 1900, 60)] = 0
    if nb > 20_000:
        counts[777] = 1_200
    out, seg = _blocks(seed, 50, 38, counts, nb - int(counts.sum()))
    return out, seg, (TS, 50, 38, 800, 608, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [18_284, 67_400])
@pytest.mark.parametrize("tf", [False, True])
def test_compose_kernels_match_plain_cuda(nb, tf):
    """On the card, at the cells' block counts: the forward kernel's image
    within KERNEL_IMG_ATOL of the plain version; the backward kernel's
    cotangents on the live blocks within REL_NORM of the plain backward in
    float64; with the T-floor, logti (the forward's logti mode) within one
    float32 ulp of a float64 per-tile prefix."""
    dev = _cuda()
    out, seg, consts = _frame(nb, 21)
    out_tf = _blocks(22, 50, 38, np.bincount(seg.numpy(), minlength=1901)[:1900],
                     int((seg == 1900).sum()))[0] if tf else None
    out, seg = out.to(dev), seg.to(dev)
    out_tf = None if out_tf is None else out_tf.to(dev)
    live = seg < 1900
    img = tcompose.compose_fwd(out, out_tf, seg, consts)
    want = tcompose.compose_fwd_plain(out, out_tf, seg, consts)
    torch.cuda.synchronize()
    assert float((img - want).abs().max()) <= KERNEL_IMG_ATOL
    g = torch.randn((608, 800, 3), device=dev, generator=torch.Generator(dev).manual_seed(3))
    got = tcompose.compose_bwd(g, out, out_tf, seg, consts)
    ref = tcompose.compose_bwd_plain(g.double(), out.double(), None if out_tf is None
                                     else out_tf.double(), seg, consts)
    for a, b in zip(got, ref):
        if b is not None:
            assert _rel_norm(a[live], b[live]) < REL_NORM
    if tf:
        assert (got[0][live][:, :3] == 0).all()
        logti = tcompose.compose_logti(out, seg, consts)
        ref64 = tcompose.incoming_log_t(out[:, 3].double(), seg, 1900)
        assert _ulps_off(logti[live], ref64[live]).max() <= 1.0


@pytest.mark.cuda
def test_compose_kernels_repeat_their_bits_cuda():
    """Two launches on the same inputs give the same bits: forward, logti
    and backward, with and without the T-floor pass."""
    dev = _cuda()
    out, seg, consts = _frame(67_400, 5)
    out, seg = out.to(dev), seg.to(dev)
    out_tf = out.flip(0).contiguous()
    live = seg < 1900
    g = torch.randn((608, 800, 3), device=dev, generator=torch.Generator(dev).manual_seed(6))
    for second in (None, out_tf):
        a, b = (tcompose.compose_fwd(out, second, seg, consts) for _ in range(2))
        assert torch.equal(a, b)
        da, db = (tcompose.compose_bwd(g, out, second, seg, consts) for _ in range(2))
        for x, y in zip(da, db):
            assert x is None or torch.equal(x[live], y[live])
    la, lb = (tcompose.compose_logti(out, seg, consts) for _ in range(2))
    assert torch.equal(la[live], lb[live])


@pytest.mark.cuda
@pytest.mark.parametrize("tfloor", [False, True])
def test_compose_graph_launches_cuda(tfloor):
    """A captured render graph records one compose_fwd (and, with the
    T-floor, one compose_logti); a captured step graph one compose_fwd and
    one compose_bwd a step."""
    dev = _cuda()
    from gaussiansplatting_tpu_torch.config import Config, RasterConfig
    from gaussiansplatting_tpu_torch.train import graph as tgraph
    from gaussiansplatting_tpu_torch.train import state as tstate
    from gaussiansplatting_tpu_torch.train import trainer as ttrainer
    from gaussiansplatting_tpu_torch.utils import synthetic

    raster = RasterConfig(pair_capacity=1 << 14, t_floor_exact=tfloor)
    params = synthetic.make_scene(300, seed=4, device=dev)
    cam = synthetic.make_canonical_camera(64, 48, device=dev)
    tgraph.render_frame(params, cam, raster)
    render = tgraph.live_renders()[-1]
    want = {"compose_fwd": 1, **({"compose_logti": 1} if tfloor else {})}
    assert {k: n for k, n in render.launches.items() if k.startswith("compose_")} == want
    gt = torch.zeros((48, 64, 3), device=dev)
    before = tgraph.launch_counts()
    ttrainer.train_steps(tstate.create(params), [cam] * 3, [gt] * 3,
                         Config(raster=raster), 100)
    torch.cuda.synchronize()
    step = tgraph.live()[-1]
    assert step.launches["compose_fwd"] == 1 and step.launches["compose_bwd"] == 1
    assert step.launches.get("compose_logti", 0) == int(tfloor)
    after = tgraph.launch_counts()
    n = 3 + tgraph.WARMUP_STEPS
    assert after["compose_bwd"] - before["compose_bwd"] == n
    tgraph.clear()


class _NaNTorch:
    """``torch`` for ops/compose.py whose ``empty`` and ``empty_like`` hand
    out NaN: what a caching allocator may hold in the rows a kernel leaves
    unwritten, here on every call."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def empty(*args, **kw):
        return torch.empty(*args, **kw).fill_(float("nan"))

    @staticmethod
    def empty_like(*args, **kw):
        return torch.empty_like(*args, **kw).fill_(float("nan"))


GRAD_REL_NORM = 1e-5     # parameter gradients: kernel backward against plain


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "tfloor", "bf16"])
def test_padding_rows_are_never_read_cuda(mode, monkeypatch):
    """The kernels leave the padding blocks' rows of the cotangents (and of
    logti) unwritten.  With NaN in every buffer they return, the
    parameters' gradients stay finite and equal, bit for bit, those of a
    backward whose padding rows are zeros, as the plain backward writes
    them; and within GRAD_REL_NORM of the gradients through the plain
    backward."""
    dev = _cuda()
    from gaussiansplatting_tpu_torch.config import RasterConfig
    from gaussiansplatting_tpu_torch.train.optimizer import TRAINABLE
    from gaussiansplatting_tpu_torch.utils import synthetic

    raster = RasterConfig(pair_capacity=1 << 14, t_floor_exact=mode == "tfloor",
                          payload_dtype="bf16" if mode == "bf16" else "f32")
    params = synthetic.make_scene(300, seed=4, device=dev)
    cam = synthetic.make_canonical_camera(64, 48, device=dev)
    w = torch.rand((48, 64, 3), device=dev, generator=torch.Generator(dev).manual_seed(7))
    kernel_bwd, pads = tcompose.compose_bwd, []

    def zero_padding(g, out, out_tf, seg, consts):
        pad = seg == consts[1] * consts[2]
        pads.append(int(pad.sum()))
        d = kernel_bwd(g, out, out_tf, seg, consts)
        return tuple(None if x is None else x.masked_fill(pad[:, None, None], 0.0) for x in d)

    def grads(bwd):
        # ops.compose as _Compose reaches it, its backward replaced
        monkeypatch.setattr(traster, "compose_mod", types.SimpleNamespace(
            **{**vars(tcompose), "compose_bwd": bwd}))
        img, _ = traster.render(params, cam, raster)
        return torch.autograd.grad((img * w).sum(), [getattr(params, f) for f in TRAINABLE])

    zeroed = grads(zero_padding)
    plain = grads(tcompose.compose_bwd_plain)
    monkeypatch.setattr(tcompose, "torch", _NaNTorch())
    poisoned = grads(kernel_bwd)
    assert pads[0] > 100
    for f, a, b, c in zip(TRAINABLE, poisoned, zeroed, plain):
        assert bool(torch.isfinite(a).all()), f
        assert torch.equal(a, b), f
        assert _rel_norm(a, c) < GRAD_REL_NORM, (f, _rel_norm(a, c))
