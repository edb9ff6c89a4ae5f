"""Differentiable tiled rasterizer: project, presort, pair windows, blend,
compose.

Counterpart of gaussiansplatting_tpu/ops/rasterize.py: ``render`` (its
windowed branch, rasterize.py:254-389, and with ``t_floor_exact`` its
aligned branch, rasterize.py:391-501) and ``_compose_tiles``.  Alpha
compositing is associative in (colour, transmittance) space, so each block
of B pairs of one 16x16 tile blends independently (ops/blend.py) into a
summary (C_b, S_b = sum log(1 - alpha)), and the blocks of a tile compose
with an exclusive prefix over their S_b (ops/compose.py).

Gradients: projection is one autograd Function (ops/projection._Project:
the presort's [N, 15] rows from the parameter fields, and back); the depth
presort is a ``_PermuteRows`` whose backward gathers by the inverse
permutation; pair expansion, tile sort and windows run once per frame,
outside autograd; each blend pass over the windows is an autograd Function
(``_BlendWindows``, ``_BlendWindowsTF``) whose backward is the blend backward followed by the
reduction to per-Gaussian sums that ``RasterConfig.grad_reduce`` picks
(ops.pairs.reduce_aligned_cotangents: the sort-prefix form, which
"autodiff" also takes, or the scatter); compose is one more (``_Compose``),
whose backward writes each blend pass's cotangent.  No step of the backward
uses float atomics.  Projection, the blends and compose run as CUDA
kernels on a CUDA device and as their plain PyTorch versions on the CPU;
``RasterConfig.blend_impl`` picks nothing here.

Nothing here reads a device value back to the host, so a train step can be
captured as a CUDA graph (train/graph.py).

The frame launches the stage marks ``projection``, ``pairs``, ``blend`` and
``compose`` (utils/tracing.py; the T-floor pass is a second ``blend`` then
``compose``), the image's cotangent ``compose_bwd``, and each blend backward
``blend_bwd``, ``reduction`` and ``projection_bwd``: a replayed graph shows
its stages on the device trace.  A frame of SH degree 2 or 3 adds ``sh``
before ``projection`` and ``sh_bwd`` after ``projection_bwd``.

With ``RasterConfig.primitive`` "surfel" (2D Gaussian Splatting's discs,
two log-scales a row) ``render`` is ``render_surfel``'s image: the surfel
projection (ops/surfel_projection.py), the same presort, pairs and windows,
the surfel blend (ops/surfel_blend.py) and its compose
(ops/surfel_compose.py), whose maps (``SurfelFrame``) the train step's
regularizers read; the float32 windowed path only.

Which Pallas kernel (gaussiansplatting_tpu/ops/pallas_blend.py) each launch
replaces:
  default path      windowed_blend_fwd    _fwd_kernel_win (:601)
                    windowed_blend_bwd    _bwd_kernel_win (:671)
  bf16 payload      windowed_blend_fwd_packed  _fwd_kernel_win's packed branch
                    windowed_blend_bwd_packed  _bwd_kernel_win's packed branch
  t_floor_exact     windowed_blend_fwd    _fwd_kernel (:161), the unmasked
                                          first pass: JAX's aligned block b
                                          is window b here, so the
                                          destination sort is not ported
                    windowed_blend_fwd_tf _fwd_kernel_tf (:249)
                    windowed_blend_bwd_tf _bwd_kernel_tf (:281)
                    windowed_blend_bwd    _bwd_kernel (:188), through the
                                          first pass's S_b (t_in)
and projection (project_fwd, project_bwd) and compose (compose_fwd,
compose_bwd; compose_logti before the T-floor pass) replace XLA's ops, no
Pallas kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gaussiansplatting_tpu_torch.config import RasterConfig
from gaussiansplatting_tpu_torch.core.camera import Camera
from gaussiansplatting_tpu_torch.core.gaussians import GaussianParams
from gaussiansplatting_tpu_torch.ops import blend as blend_mod
from gaussiansplatting_tpu_torch.ops import compose as compose_mod
from gaussiansplatting_tpu_torch.ops import pairs as pairs_mod
from gaussiansplatting_tpu_torch.ops import projection as proj_mod
from gaussiansplatting_tpu_torch.ops import surfel_blend, surfel_compose
from gaussiansplatting_tpu_torch.ops import surfel_projection as sproj
from gaussiansplatting_tpu_torch.utils import tracing

# frames rendered of 2D Gaussian surfels (render_surfel), in utils/
# tracing.py's registry as the SH frames are counted
tracing.counted("primitive.surfel")


class RenderAux(NamedTuple):
    num_pairs: torch.Tensor  # [] int32 pairs emitted this frame
    overflow: torch.Tensor   # [] bool pair capacity exceeded


def _check_payload(cfg: RasterConfig) -> None:
    if cfg.payload_dtype not in ("f32", "bf16"):
        raise ValueError(f"payload_dtype must be 'f32' or 'bf16', got {cfg.payload_dtype!r}")


def _tile_rows(camera: Camera, cfg: RasterConfig, tile_rows) -> tuple[int, int]:
    """(row0, n_rows) of the tile rows to rasterize: the whole image, or the
    strip ``tile_rows`` = (row0, n_rows), which may run past the image's
    last tile row (those rows hold only the background)."""
    if tile_rows is None:
        return 0, proj_mod.num_tiles(camera.height, cfg.tile_size)
    row0, n_rows = (int(x) for x in tile_rows)
    if row0 < 0 or n_rows < 1:
        raise ValueError(f"render: tile_rows {tuple(tile_rows)} needs row0 >= 0 and n_rows >= 1")
    return row0, n_rows


class _PermuteRows(torch.autograd.Function):
    """x[order] for a permutation ``order``; the cotangent is a gather by the
    inverse permutation (no scatter-add)."""

    @staticmethod
    def forward(ctx, x, order, inv_order):
        ctx.save_for_backward(inv_order)
        return x[order]

    @staticmethod
    def backward(ctx, g):
        (inv_order,) = ctx.saved_tensors
        return g[inv_order], None, None


class _Plan(NamedTuple):
    """The presorted frame: render data, the capacity plan and the static
    configuration of pair_windows_fwd and the blend."""
    data: torch.Tensor      # [N, 9] presorted (sx, sy, conic, opacity, rgb)
    ints: tuple             # counts, ccounts, coffsets, ty_lo, tmin_x, span_x [N] int32
    pcfg: tuple             # (n, pair_capacity, tiles_x, tiles_y, block, chunk_cap,
                            #  packed, pack_pos, tile_size)
    bconsts: tuple          # (tile_size, power_floor, alpha_cap, alpha_floor, tiles_x,
                            #  packed, pack_pos)
    aux: RenderAux


def _frame_colour(params: GaussianParams, camera: Camera, cfg: RasterConfig) -> torch.Tensor:
    """The frame's colour [N, 3], then the ``projection`` mark.  An SH row
    wider than band 1 (degree 2 or 3) counts the frame by its degree
    (``sh.degree_<d>``, projection.count_sh_frame) and, at a degree of 1 or
    more, evaluates the colour between the marks ``sh`` and
    ``projection``, its cotangent marked ``sh_bwd`` (the last of the
    backward, after ``projection_bwd``); otherwise the colour is evaluated
    after the mark (projection.default_color)."""
    if params.sh.shape[1] > 4:
        proj_mod.count_sh_frame(cfg.sh_degree)
        if cfg.sh_degree >= 1:
            tracing.mark("sh", params.means)
            color = tracing.mark_grad("sh_bwd", proj_mod.sh_color(params, camera, cfg))
            tracing.mark("projection", params.means)
            return color
    tracing.mark("projection", params.means)
    return proj_mod.default_color(params, camera, cfg)


def _presort(rows: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """The presort's rows permuted by the stable argsort of their depth key.
    Expansion emits pairs in presorted order and the tile sort is stable,
    so every tile's run comes out depth-sorted; culled rows all have depth
    0, so the sort must be stable too.  The rows ride the permutation as
    one tensor (_PermuteRows: its cotangent a gather)."""
    n = depth.shape[0]
    order = torch.argsort(depth, stable=True)
    inv_order = torch.empty_like(order)
    inv_order[order] = torch.arange(n, dtype=order.dtype, device=order.device)
    return _PermuteRows.apply(rows, order, inv_order)


def _plan(params: GaussianParams, camera: Camera, cfg: RasterConfig,
          vs_dummy: torch.Tensor | None = None, row0: int = 0,
          tiles_y: int | None = None) -> _Plan:
    """Projection (the presort's rows, ops/projection.project_rows), the
    stable depth presort and the capacity plan (rasterize.py:287-363) of
    tile rows [row0, row0 + tiles_y) (default: the whole image); the colour
    and its marks by _frame_colour."""
    color = _frame_colour(params, camera, cfg)
    ts = cfg.tile_size
    tiles_x = proj_mod.num_tiles(camera.width, ts)
    if tiles_y is None:
        tiles_y = proj_mod.num_tiles(camera.height, ts)

    # the presort's rows [N, 15] (projection, the dead-zone colour, vs_dummy;
    # integer fields exact in f32) and their depth key
    cols = _presort(*proj_mod.project_rows(params, camera, cfg, color, vs_dummy))
    data = cols[:, proj_mod.DATA_COL:]
    i32 = torch.int32
    n_tiles = cols[:, 5].to(i32)
    proj_p = proj_mod.Projected(
        screen_pos=data[:, :2],
        conic=data[:, 2:5],
        depth=cols[:, 0],
        opacity=data[:, 5],
        color=data[:, 6:9],
        radius=torch.zeros_like(cols[:, 0]),   # unused after the plan
        tile_min=cols[:, 1:3].to(i32),
        tile_max=cols[:, 3:5].to(i32),
        n_tiles=n_tiles,
        valid=n_tiles > 0,
    )

    # the bf16 payload mode packs the windowed branch only, as JAX does
    # (rasterize.py:304, 364-376)
    packed = cfg.payload_dtype == "bf16" and not cfg.t_floor_exact
    pack_pos = packed and cfg.pack_positions
    bconsts = (ts, cfg.power_floor, cfg.alpha_cap, cfg.alpha_floor, tiles_x,
               int(packed), int(pack_pos))
    return _pair_plan(data, proj_p, cfg, tiles_x, tiles_y, row0, bconsts, packed, pack_pos)


def _pair_plan(data, proj_p, cfg: RasterConfig, tiles_x: int, tiles_y: int, row0: int,
               bconsts: tuple, packed: bool = False, pack_pos: bool = False) -> _Plan:
    """The ``pairs`` mark and the capacity plan (rasterize.py:287-363) of
    the presorted rows' ``proj_p`` over tile rows [row0, row0 + tiles_y):
    the _Plan of ``data`` with the blend's ``bconsts``; both primitives'
    plans end here."""
    n = data.shape[0]
    tracing.mark("pairs", data)
    (counts, ccounts, coffsets, ty_lo, span_x, total,
     overflow) = pairs_mod.capacity_plan(
        proj_p, tiles_x, tiles_y, cfg.pair_capacity, row0, cfg.overflow_drop,
        cfg.chunk_slack,
    )
    pcfg = (
        n, cfg.pair_capacity, tiles_x, tiles_y, cfg.pair_block,
        pairs_mod._chunk_capacity(cfg.pair_capacity, n, cfg.chunk_slack),
        packed, pack_pos, cfg.tile_size,
    )
    ints = (counts, ccounts, coffsets, ty_lo, proj_p.tile_min[:, 0], span_x)
    return _Plan(data, ints, pcfg, bconsts,
                 RenderAux(num_pairs=total, overflow=overflow))


class _Windows(NamedTuple):
    """pair_windows_fwd of the plan: the blend's input windows."""
    table: torch.Tensor        # [16, EP] tile-sorted pair rows ([8, EP] packed)
    block_src: torch.Tensor    # [NB] int32 window starts
    block_valid: torch.Tensor  # [NB] int32 live lanes
    tile: torch.Tensor         # [NB] int32 tile, clamped to num_tiles-1
    block_tile: torch.Tensor   # [NB] int32 tile, num_tiles on padding blocks
    row0: int                  # first tile row: the kernels add it to a tile's row


def _windows(data, ints, pcfg, row0: int = 0) -> _Windows:
    """pair_windows_fwd of the plan (tile ids relative to ``row0``)."""
    counts, ccounts, coffsets, ty_lo, tmin_x, span_x = ints
    table, block_src, block_valid, block_tile, _ = pairs_mod.pair_windows_fwd(
        data, row0, counts, ccounts, coffsets, ty_lo, tmin_x, span_x, pcfg,
    )
    t = torch.clamp(block_tile, max=pcfg[2] * pcfg[3] - 1)
    return _Windows(table, block_src, block_valid, t, block_tile, row0)


def _reduce_to_data(dcols, gid, counts, n, grad_reduce):
    """The nine aligned-order column cotangents [NB, B] (five packed rows
    in the bf16 payload mode) -> per-Gaussian [N, 9] sums, by
    ``grad_reduce``."""
    tracing.mark("reduction", gid)
    d_rows = torch.stack([c.reshape(-1) for c in dcols])           # [9 or 5, a_cap]
    out = pairs_mod.reduce_aligned_cotangents(
        d_rows, gid.reshape(-1).to(torch.int32), counts, n, grad_reduce,
        packed_out=9 if len(dcols) == 5 else 0,
    )
    tracing.mark("projection_bwd", out)
    return out


class _BlendWindows(torch.autograd.Function):
    """The windowed blend as one differentiable unit over the frame's
    windows, the counterpart of the JAX ``_blend_windows`` custom VJP
    (rasterize.py:174-251) and, on the t_floor_exact path, of the first,
    unmasked ``block_blend_cols`` pass (rasterize.py:434-439).  The windows
    are built from ``data.detach()``; differentiable in ``data`` only.

    Forward returns (out [NB, 4, P2], gid [NB, B] f32) and keeps this
    pass's own S_b (``out[:, 3]``; in the bf16 payload mode the packed
    forward's q_b); backward runs the blend backward over the same windows
    from it, then reduces the aligned-order column cotangents to
    per-Gaussian sums by ``grad_reduce``."""

    @staticmethod
    def forward(ctx, data, win, counts, pcfg, bconsts, grad_reduce):
        args = (win.table, win.block_src, win.block_valid, win.tile, win.row0, pcfg[4],
                bconsts)
        if blend_mod.payload_flags(bconsts)[0]:
            out, gid, keep = blend_mod.windowed_blend_fwd_packed(*args)
        else:
            out, gid = blend_mod.windowed_blend_fwd(*args)
            keep = out[:, 3].contiguous()
        ctx.win, ctx.pcfg, ctx.bconsts, ctx.grad_reduce = win, pcfg, bconsts, grad_reduce
        ctx.save_for_backward(gid, counts, keep)
        ctx.mark_non_differentiable(gid)
        return out, gid

    @staticmethod
    def backward(ctx, d_out, _d_gid):
        tracing.mark("blend_bwd", d_out)
        gid, counts, keep = ctx.saved_tensors
        win, (n, block) = ctx.win, (ctx.pcfg[0], ctx.pcfg[4])
        bwd = (blend_mod.windowed_blend_bwd_packed if blend_mod.payload_flags(ctx.bconsts)[0]
               else blend_mod.windowed_blend_bwd)
        dcols = bwd(win.table, win.block_src, win.block_valid, win.tile, win.row0, block,
                    d_out.contiguous(), keep, ctx.bconsts)
        return (_reduce_to_data(dcols, gid, counts, n, ctx.grad_reduce),) + (None,) * 5


class _BlendWindowsTF(torch.autograd.Function):
    """The t_floor_exact second pass, the counterpart of
    ``block_blend_cols_tf`` and its VJP (rasterize.py:441-448): the blend
    over the SAME windows as _BlendWindows, with each pixel's lanes past
    the T-floor zeroed, given each block's incoming log T ``logti`` (from
    the first pass, detached).  Differentiable in ``data`` only: the
    termination mask is constant and ``logti`` gets no cotangent.

    Forward returns out [NB, 4, P2] (C_b and S_b over the survivors) and
    keeps its masked S_b (``out[:, 3]``) and each pixel's stop lane;
    backward runs the T-floor blend backward from them, then the same
    per-Gaussian reduction by the first pass's ``gid``."""

    @staticmethod
    def forward(ctx, data, win, gid, counts, logti, pcfg, bconsts, log_thr, grad_reduce):
        out, stop = blend_mod.windowed_blend_fwd_tf(
            win.table, win.block_src, win.block_valid, win.tile, win.row0, pcfg[4],
            bconsts, logti, log_thr,
        )
        ctx.win, ctx.pcfg, ctx.bconsts, ctx.log_thr = win, pcfg, bconsts, log_thr
        ctx.grad_reduce = grad_reduce
        ctx.save_for_backward(gid, counts, logti, out[:, 3].contiguous(), stop)
        return out

    @staticmethod
    def backward(ctx, d_out):
        tracing.mark("blend_bwd", d_out)
        gid, counts, logti, s_b, stop = ctx.saved_tensors
        win, (n, block) = ctx.win, (ctx.pcfg[0], ctx.pcfg[4])
        dcols = blend_mod.windowed_blend_bwd_tf(
            win.table, win.block_src, win.block_valid, win.tile, win.row0, block,
            d_out.contiguous(), s_b, stop, ctx.bconsts, logti, ctx.log_thr,
        )
        return (_reduce_to_data(dcols, gid, counts, n, ctx.grad_reduce),) + (None,) * 8


def render(params: GaussianParams, camera: Camera, cfg: RasterConfig,
           vs_dummy: torch.Tensor | None = None, tile_rows: tuple | None = None):
    """Render one view.  Returns (image [H, W, 3] float32, RenderAux) on the
    device of ``params``; differentiable in the parameters.  With
    ``cfg.primitive`` "surfel" the frame is render_surfel's image.

    vs_dummy: optional [N, 2] zeros added to the projected screen positions;
    its gradient is the per-Gaussian view-space positional gradient the
    density statistics accumulate (tiled_shaders.metal:717-720).

    tile_rows: optional (row0, n_rows) — rasterize only tile rows [row0,
    row0 + n_rows) and return the strip [n_rows * tile_size, W, 3], padded
    rows kept, so every strip of a split has one shape (rasterize.py:269-
    273, 548-551); parallel/sharded.py renders one strip per rank.  Cull and
    pair semantics are the full render's restricted to the strip: the
    strips' pair counts sum to the full frame's.

    With ``cfg.t_floor_exact`` the frame takes two blend passes over one
    set of windows (the expansion and sort run once): compose turns the
    first pass's S_b into each block's incoming log T, and the second pass
    zeroes every pair behind a pixel's T-floor.  The image takes C_b and
    S_b from the second pass and the blocks' incoming T from the first."""
    if cfg.primitive != "gaussian":
        if tile_rows is not None:
            raise ValueError("render: a surfel frame has no strips (tile_rows): the "
                             "tile-sharded step renders 3D Gaussians only")
        frame = render_surfel(params, camera, cfg, vs_dummy)
        return frame.image, frame.aux
    _check_payload(cfg)
    row0, n_rows = _tile_rows(camera, cfg, tile_rows)
    plan = _plan(params, camera, cfg, vs_dummy, row0, n_rows)
    win = _windows(plan.data.detach(), plan.ints, plan.pcfg, row0)
    counts = plan.ints[0]
    tracing.mark("blend", counts)
    out, gid = _BlendWindows.apply(plan.data, win, counts, plan.pcfg,
                                   plan.bconsts, cfg.grad_reduce)
    blend_tfloor = None
    if cfg.t_floor_exact:
        log_thr = math.log(cfg.transmittance_floor)

        def blend_tfloor(logti):
            tracing.mark("blend", logti)
            out_tf = _BlendWindowsTF.apply(plan.data, win, gid, counts, logti,
                                           plan.pcfg, plan.bconsts, log_thr,
                                           cfg.grad_reduce)
            tracing.mark("compose", logti)
            return out_tf

    tracing.mark("compose", out)
    img = compose(out, win.block_tile, camera, cfg, blend_tfloor, tile_rows)
    return tracing.mark_grad("compose_bwd", img), plan.aux


def blend_windows(params: GaussianParams, camera: Camera, cfg: RasterConfig,
                  tile_rows: tuple | None = None):
    """Everything render does before the blend: projection, the stable
    depth presort, the capacity plan and the per-block windows (of the
    strip ``tile_rows``, as render takes it).

    Returns (blend_args, block_tile, RenderAux) where blend_args are the
    positional arguments of ops.blend.windowed_blend_fwd (and, with the
    cotangent and the forward's S_b inserted before the constants, of
    windowed_blend_bwd; the T-floor variants take (logti, log_thr) after
    the constants, and the backward the cotangent, the T-floor forward's
    S_b and its stop lanes before them).  In the bf16 payload mode they
    are those of windowed_blend_fwd_packed (the packed table, constants
    with the payload flags), and of windowed_blend_bwd_packed with the
    cotangent and the packed forward's q_b inserted."""
    _check_payload(cfg)
    row0, n_rows = _tile_rows(camera, cfg, tile_rows)
    plan = _plan(params, camera, cfg, None, row0, n_rows)
    win = _windows(plan.data.detach(), plan.ints, plan.pcfg, row0)
    blend_args = (win.table, win.block_src, win.block_valid, win.tile, win.row0,
                  cfg.pair_block, plan.bconsts)
    return blend_args, win.block_tile, plan.aux


def compose_consts(camera: Camera, cfg: RasterConfig, tile_rows: tuple | None = None) -> tuple:
    """ops.compose's constants (ts, tiles_x, tiles_y, width, rows, bg) of
    the image, or of the strip ``tile_rows`` with its padded rows."""
    ts = cfg.tile_size
    _, tiles_y = _tile_rows(camera, cfg, tile_rows)
    rows = camera.height if tile_rows is None else tiles_y * ts
    return (ts, proj_mod.num_tiles(camera.width, ts), tiles_y, camera.width, rows,
            1.0 if cfg.white_background else 0.0)


class _Compose(torch.autograd.Function):
    """The image from the blend's summaries, differentiable in both passes'
    ``out`` (ops/compose.py has the contract): the forward kernel
    (``compose_fwd``) and, on the image's cotangent, the backward kernel
    (``compose_bwd``), which writes each pass's cotangent in the blend
    backward's own [NB, 4, P2] layout; on CPU tensors their plain
    versions.

    Part of the contract: on CUDA tensors the rows of the padding blocks
    (``seg`` == the tile count) of both cotangents are undefined (never
    written, so whatever the allocator held), where the CPU's plain
    backward writes zeros.  Every blend backward returns before it reads
    the cotangent of a block with no live lane, so the parameters'
    gradients are the same either way
    (tests/test_torch_compose.py::test_padding_rows_are_never_read_cuda)."""

    @staticmethod
    def forward(ctx, out, out_tf, seg, consts):
        ctx.consts = consts
        ctx.save_for_backward(out, out_tf, seg)
        return compose_mod.compose_fwd(out, out_tf, seg, consts)

    @staticmethod
    def backward(ctx, g):
        out, out_tf, seg = ctx.saved_tensors
        d_out, d_tf = compose_mod.compose_bwd(g, out, out_tf, seg, ctx.consts)
        return d_out, d_tf, None, None


def compose(out: torch.Tensor, block_tile: torch.Tensor, camera: Camera,
            cfg: RasterConfig, blend_tfloor=None,
            tile_rows: tuple | None = None) -> torch.Tensor:
    """The image [H, W, 3] (the strip [n_rows * tile_size, W, 3] with
    ``tile_rows``, padded rows kept, as the JAX strip keeps them,
    rasterize.py:548-551) from the blend's per-block summaries ``out`` [NB,
    4, P2] and each block's tile id, relative to the strip's first row
    (non-decreasing; padding blocks carry the tile count).

    blend_tfloor: with ``cfg.t_floor_exact``, a function of each block's
    incoming log T ``logti`` [NB, P2] (ops.compose.compose_logti of ``out``,
    detached) that returns the T-floor pass's out_tf [NB, 4, P2]; the image
    takes its C_b and S_b, with the incoming T from ``out``, which stays
    differentiable (rasterize.py:520-530)."""
    consts = compose_consts(camera, cfg, tile_rows)
    if not cfg.t_floor_exact:
        return _Compose.apply(out, None, block_tile, consts)
    if blend_tfloor is None:
        raise ValueError("compose: t_floor_exact needs blend_tfloor")
    out_tf = blend_tfloor(compose_mod.compose_logti(out.detach(), block_tile, consts))
    return _Compose.apply(out, out_tf, block_tile, consts)


# -- 2D Gaussian surfels (Huang et al. 2024): ops/surfel_projection.py,
#    ops/surfel_blend.py, ops/surfel_compose.py


class SurfelFrame(NamedTuple):
    """A surfel frame's maps [H, W, ...]: the image, alpha A = sum w, the
    expected depth sum w z / A (0 where A = 0), the camera-space normal
    sum w n, and the depth distortion A M2 - M1^2 (eq. 13, squared form)."""
    image: torch.Tensor      # [H, W, 3]
    alpha: torch.Tensor      # [H, W]
    depth: torch.Tensor      # [H, W]
    normal: torch.Tensor     # [H, W, 3]
    dist: torch.Tensor       # [H, W]
    aux: RenderAux


def check_surfel(params: GaussianParams, cfg: RasterConfig) -> None:
    """Raise unless ``cfg`` and ``params`` describe a surfel frame the port
    renders: two log-scales a row, the float32 windowed path (no bf16
    payload, no t_floor_exact)."""
    if cfg.primitive != "surfel":
        raise ValueError(f"primitive must be 'gaussian' or 'surfel', got {cfg.primitive!r}")
    if params.log_scales.shape[-1] != 2:
        raise ValueError(f"a surfel row holds two log-scales, got "
                         f"{tuple(params.log_scales.shape)}")
    if cfg.payload_dtype != "f32":
        raise ValueError("primitive 'surfel' renders the float32 payload only "
                         "(payload_dtype 'f32'), not the bf16 packed one")
    if cfg.t_floor_exact:
        raise ValueError("primitive 'surfel' has no exact T-floor pass (t_floor_exact)")


def _plan_surfel(params: GaussianParams, camera: Camera, cfg: RasterConfig,
                 vs_dummy: torch.Tensor | None = None) -> _Plan:
    """_plan for surfels: the colour (_frame_colour), the presort's [N, 22]
    rows (ops/surfel_projection.project_rows), the stable depth presort and
    the capacity plan of the whole image; the plan's data is the rows'
    sixteen render columns."""
    color = _frame_colour(params, camera, cfg)
    ts = cfg.tile_size
    tiles_x = proj_mod.num_tiles(camera.width, ts)
    tiles_y = proj_mod.num_tiles(camera.height, ts)
    cols = _presort(*sproj.project_rows(params, camera, cfg, color, vs_dummy))
    data = cols[:, sproj.DATA_COL:]
    i32 = torch.int32
    n_tiles = cols[:, 5].to(i32)
    zeros = torch.zeros_like(cols[:, 0])
    proj_p = proj_mod.Projected(
        screen_pos=data[:, :2], conic=data[:, :3], depth=cols[:, 0], opacity=data[:, 9],
        color=data[:, 10:13], radius=zeros, tile_min=cols[:, 1:3].to(i32),
        tile_max=cols[:, 3:5].to(i32), n_tiles=n_tiles, valid=n_tiles > 0)
    bconsts = (ts, cfg.power_floor, cfg.alpha_cap, cfg.alpha_floor, tiles_x)
    return _pair_plan(data, proj_p, cfg, tiles_x, tiles_y, 0, bconsts)


# rows of the surfel blend's cotangents the float64 reduction takes at once
SURFEL_REDUCE_ROWS = 8


class _BlendSurfels(torch.autograd.Function):
    """The surfel blend over the frame's windows as one differentiable unit
    (ops/surfel_blend.py): forward (out [NB, 10, P2], gid [NB, B]); the
    backward runs the blend backward from out's S_b, then reduces its
    sixteen column cotangents to per-surfel sums by ``grad_reduce`` (the
    sort-prefix form eight rows at a time)."""

    @staticmethod
    def forward(ctx, data, win, counts, pcfg, bconsts, grad_reduce):
        out, gid = surfel_blend.surfel_blend_fwd(win.table, win.block_src, win.block_valid,
                                                 win.tile, win.row0, pcfg[4], bconsts)
        ctx.win, ctx.pcfg, ctx.bconsts, ctx.grad_reduce = win, pcfg, bconsts, grad_reduce
        ctx.save_for_backward(gid, counts, out[:, 3].contiguous())
        ctx.mark_non_differentiable(gid)
        return out, gid

    @staticmethod
    def backward(ctx, d_out, _d_gid):
        tracing.mark("blend_bwd", d_out)
        gid, counts, s_b = ctx.saved_tensors
        win, (n, block) = ctx.win, (ctx.pcfg[0], ctx.pcfg[4])
        dcols = surfel_blend.surfel_blend_bwd(win.table, win.block_src, win.block_valid,
                                              win.tile, win.row0, block, d_out.contiguous(),
                                              s_b, ctx.bconsts)
        tracing.mark("reduction", gid)
        d_data = pairs_mod.reduce_aligned_cotangents(
            dcols.reshape(dcols.shape[0], -1), gid.reshape(-1).to(torch.int32), counts, n,
            ctx.grad_reduce, row_chunk=SURFEL_REDUCE_ROWS)
        tracing.mark("projection_bwd", d_data)
        return (d_data,) + (None,) * 5


class _ComposeSurfels(torch.autograd.Function):
    """The surfel maps from the blend's sums, differentiable in ``out``
    (ops/surfel_compose.py): (image [H, W, 3], aux [H, W, 7])."""

    @staticmethod
    def forward(ctx, out, seg, consts):
        ctx.consts = consts
        ctx.save_for_backward(out, seg)
        return surfel_compose.surfel_compose_fwd(out, seg, consts)

    @staticmethod
    def backward(ctx, g_img, g_aux):
        out, seg = ctx.saved_tensors
        if g_img is None:
            g_img = torch.zeros((ctx.consts[4], ctx.consts[3], 3), device=out.device)
        if g_aux is None:
            g_aux = torch.zeros((ctx.consts[4], ctx.consts[3], surfel_compose.AUX),
                                device=out.device)
        return surfel_compose.surfel_compose_bwd(g_img, g_aux, out, seg, ctx.consts), None, None


def render_surfel(params: GaussianParams, camera: Camera, cfg: RasterConfig,
                  vs_dummy: torch.Tensor | None = None) -> SurfelFrame:
    """Render one view of 2D Gaussian surfels (``cfg.primitive`` "surfel",
    two log-scales a row): projection, the presort, pairs and windows as
    the 3D Gaussian's, the surfel blend and its compose.  Returns the
    SurfelFrame of the whole image, differentiable in the parameters (and
    vs_dummy, as render takes it).  The marks are the 3D Gaussian frame's:
    ``projection``, ``pairs``, ``blend``, ``compose`` and, backward,
    ``compose_bwd``, ``blend_bwd``, ``reduction``, ``projection_bwd``; a
    frame counts once under ``primitive.surfel``."""
    check_surfel(params, cfg)
    tracing.add_launches({"primitive.surfel": 1})
    plan = _plan_surfel(params, camera, cfg, vs_dummy)
    win = _windows(plan.data.detach(), plan.ints, plan.pcfg, 0)
    counts = plan.ints[0]
    tracing.mark("blend", counts)
    out, _ = _BlendSurfels.apply(plan.data, win, counts, plan.pcfg, plan.bconsts,
                                 cfg.grad_reduce)
    tracing.mark("compose", out)
    img, aux = _ComposeSurfels.apply(out, win.block_tile, compose_consts(camera, cfg))
    img = tracing.mark_grad("compose_bwd", img)
    trans = aux[..., 6]
    alpha = 1.0 - trans
    depth = torch.where(alpha > 0.0, aux[..., 0] / torch.where(alpha > 0.0, alpha, 1.0), 0.0)
    dist = alpha * aux[..., 5] - aux[..., 4] * aux[..., 4]
    return SurfelFrame(img, alpha, depth, aux[..., 1:4], dist, plan.aux)
