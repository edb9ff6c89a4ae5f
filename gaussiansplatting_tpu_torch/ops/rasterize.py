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
from gaussiansplatting_tpu_torch.utils import tracing


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


def _plan(params: GaussianParams, camera: Camera, cfg: RasterConfig,
          vs_dummy: torch.Tensor | None = None, row0: int = 0,
          tiles_y: int | None = None) -> _Plan:
    """Projection (the presort's rows, ops/projection.project_rows), the
    stable depth presort and the capacity plan (rasterize.py:287-363) of
    tile rows [row0, row0 + tiles_y) (default: the whole image).  An SH row wider than band 1
    (degree 2 or 3) counts the frame by its degree
    (``sh.degree_<d>``, projection.count_sh_frame) and, at a degree of 1 or more, evaluates the
    colour first, between the marks ``sh`` and ``projection``, its
    cotangent marked ``sh_bwd`` (the last of the backward, after
    ``projection_bwd``)."""
    color = None
    if params.sh.shape[1] > 4:
        proj_mod.count_sh_frame(cfg.sh_degree)
        if cfg.sh_degree >= 1:
            tracing.mark("sh", params.means)
            color = tracing.mark_grad("sh_bwd", proj_mod.sh_color(params, camera, cfg))
    tracing.mark("projection", params.means)
    ts = cfg.tile_size
    tiles_x = proj_mod.num_tiles(camera.width, ts)
    if tiles_y is None:
        tiles_y = proj_mod.num_tiles(camera.height, ts)

    if color is None:
        color = proj_mod.default_color(params, camera, cfg)
    # the presort's rows [N, 15] (projection, the dead-zone colour, vs_dummy;
    # integer fields exact in f32) and their depth key
    rows, depth = proj_mod.project_rows(params, camera, cfg, color, vs_dummy)

    # depth presort: expansion emits pairs in Gaussian order and the tile
    # sort is stable, so every tile's run comes out depth-sorted.  Culled
    # Gaussians all have depth 0, so the sort must be stable too.  The rows
    # ride the permutation as one tensor.
    n = depth.shape[0]
    order = torch.argsort(depth, stable=True)
    inv_order = torch.empty_like(order)
    inv_order[order] = torch.arange(n, dtype=order.dtype, device=order.device)
    cols = _PermuteRows.apply(rows, order, inv_order)
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

    tracing.mark("pairs", data)
    (counts, ccounts, coffsets, ty_lo, span_x, total,
     overflow) = pairs_mod.capacity_plan(
        proj_p, tiles_x, tiles_y, cfg.pair_capacity, row0, cfg.overflow_drop,
        cfg.chunk_slack,
    )
    # the bf16 payload mode packs the windowed branch only, as JAX does
    # (rasterize.py:304, 364-376)
    packed = cfg.payload_dtype == "bf16" and not cfg.t_floor_exact
    pack_pos = packed and cfg.pack_positions
    pcfg = (
        n, cfg.pair_capacity, tiles_x, tiles_y, cfg.pair_block,
        pairs_mod._chunk_capacity(cfg.pair_capacity, n, cfg.chunk_slack),
        packed, pack_pos, ts,
    )
    bconsts = (ts, cfg.power_floor, cfg.alpha_cap, cfg.alpha_floor, tiles_x,
               int(packed), int(pack_pos))
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
    device of ``params``; differentiable in the parameters.

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
