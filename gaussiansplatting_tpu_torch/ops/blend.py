"""Windowed block blend, forward and backward, plain and with the exact
T-floor: the CUDA kernels' wrappers and their plain PyTorch versions.

Counterpart of ``windowed_blend_fwd`` / ``windowed_blend_bwd`` in
gaussiansplatting_tpu/ops/pallas_blend.py (the Pallas kernels
``_fwd_kernel_win`` and ``_bwd_kernel_win``) and, over the same windows, of
``block_blend_cols`` / ``block_blend_cols_tf`` and their VJPs (the Pallas
kernels ``_fwd_kernel``, ``_bwd_kernel``, ``_fwd_kernel_tf`` and
``_bwd_kernel_tf``): aligned block b of the JAX aligned path is the window
b here.  Contract, for NB blocks of B = ``block`` lanes and P2 =
tile_size**2 pixels:

  inputs   table [16, EP] f32, tile-sorted pair rows (0=gid, 1=sx, 2=sy,
           3..5=conic a/b/c, 6=opacity, 7..9=rgb), see ops/pairs.py;
           block_src / block_valid / block_tile [NB] int32 (the tile clamped
           to num_tiles-1, as the JAX caller passes it); row0 (int, first
           tile row); cfg_consts = (tile_size, power_floor, alpha_cap,
           alpha_floor, tiles_x).
  forward  out [NB, 4, P2] f32: rows 0-2 the block's blended colour
           C_b = sum_k w_k c_k, row 3 S_b = sum_k log1p(-alpha_k);
           gid [NB, B] f32: the window's Gaussian ids, -1 on dead lanes.
  backward g [NB, 4, P2] f32, the cotangent of ``out`` (rows 0-2 dC, row 3
           dS) -> nine [NB, B] f32 column cotangents (mx, my, conic a, b, c,
           opacity, r, g, b), zero on dead lanes and dead blocks.  d mx is
           the cotangent of the screen x position (mx = sx - tile centre).
  T-floor  the ``_tf`` variants take two more arguments, logti [NB, P2] f32
           (each block's incoming global log-transmittance, from the
           unmasked first pass) and log_thr = log(transmittance_floor).  A
           kept lane survives iff its exclusive in-block log T plus logti is
           > log_thr (tiled_shaders.metal:334); termination is monotone, so
           the survivors are a prefix of each pixel's kept lanes.  The
           forward returns out only (C and S over survivors); the backward
           holds the mask constant, and logti gets no cotangent.

On a CUDA tensor each wrapper launches its kernel (csrc/blend_fwd.cu,
csrc/blend_bwd.cu); on a CPU tensor it runs the plain version.  Nothing falls
back from one to the other.  The wrappers are raw kernel entries: gradients
reach the backward through ops/rasterize._BlendWindows, so the forward
refuses inputs that require grad.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

_P2_MAX_THREADS = 1024   # one CUDA thread per tile pixel
_B_MAX = 1024            # staged window lanes (9 f32 each in shared memory)
_SMEM_MAX = 232_448      # bytes of shared memory a Hopper block can have
_BWD_STATIC_SMEM = 128   # blend_bwd.cu's static per-warp kend array


def _check_no_grad(*tensors):
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "windowed_blend_fwd has no backward of its own: differentiate "
            "through ops.rasterize.render, whose _BlendWindows calls "
            "windowed_blend_bwd"
        )


def _device_type(name, table):
    if table.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"{name}: unsupported device {table.device}")
    return table.device.type


def windowed_blend_fwd(table, block_src, block_valid, block_tile, row0, block,
                       cfg_consts):
    """Forward windowed blend: returns (out [NB, 4, P2], gid [NB, B] f32).

    ``windowed_blend_fwd.launches`` counts CUDA kernel launches."""
    _check_no_grad(table)
    if _device_type("windowed_blend_fwd", table) == "cuda":
        return _launch_fwd_cuda(table, block_src, block_valid, block_tile,
                                row0, block, cfg_consts)
    return windowed_blend_fwd_plain(table, block_src, block_valid, block_tile,
                                    row0, block, cfg_consts)


windowed_blend_fwd.launches = 0


def windowed_blend_fwd_tf(table, block_src, block_valid, block_tile, row0,
                          block, cfg_consts, logti, log_thr):
    """Forward windowed blend with the exact T-floor: returns out [NB, 4,
    P2] over each pixel's surviving lanes.

    ``windowed_blend_fwd_tf.launches`` counts CUDA kernel launches."""
    _check_no_grad(table)
    if _device_type("windowed_blend_fwd_tf", table) == "cuda":
        out, _ = _launch_fwd_cuda(table, block_src, block_valid, block_tile,
                                  row0, block, cfg_consts, logti, log_thr)
        return out
    return windowed_blend_fwd_tf_plain(table, block_src, block_valid,
                                       block_tile, row0, block, cfg_consts,
                                       logti, log_thr)


windowed_blend_fwd_tf.launches = 0


def windowed_blend_bwd(table, block_src, block_valid, block_tile, row0, block,
                       g, cfg_consts):
    """Backward windowed blend: the nine [NB, B] column cotangents (mx, my,
    a, b, c, op, r, g, b) of the forward's ``out`` given its cotangent ``g``
    [NB, 4, P2].

    ``windowed_blend_bwd.launches`` counts CUDA kernel launches."""
    if _device_type("windowed_blend_bwd", table) == "cuda":
        return _launch_bwd_cuda(table, block_src, block_valid, block_tile,
                                row0, block, g, cfg_consts)
    return windowed_blend_bwd_plain(table, block_src, block_valid, block_tile,
                                    row0, block, g, cfg_consts)


windowed_blend_bwd.launches = 0


def windowed_blend_bwd_tf(table, block_src, block_valid, block_tile, row0,
                          block, g, cfg_consts, logti, log_thr):
    """Backward of windowed_blend_fwd_tf with the termination mask held
    constant: the nine [NB, B] column cotangents given ``g`` [NB, 4, P2].

    ``windowed_blend_bwd_tf.launches`` counts CUDA kernel launches."""
    if _device_type("windowed_blend_bwd_tf", table) == "cuda":
        return _launch_bwd_cuda(table, block_src, block_valid, block_tile,
                                row0, block, g, cfg_consts, logti, log_thr)
    return windowed_blend_bwd_tf_plain(table, block_src, block_valid,
                                       block_tile, row0, block, g, cfg_consts,
                                       logti, log_thr)


windowed_blend_bwd_tf.launches = 0


def _checked_launch_args(table, block_src, block_valid, block_tile, block,
                         cfg_consts):
    """Validate what the kernels take; returns contiguous inputs and the
    int/float constants."""
    ts, power_floor, alpha_cap, alpha_floor, tiles_x = cfg_consts
    ts, tiles_x, block = int(ts), int(tiles_x), int(block)
    nb = block_src.shape[0]
    dev = table.device
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[0] < 10:
        raise ValueError(f"table must be [>=10, EP] float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    for name, t in (("block_src", block_src), ("block_valid", block_valid),
                    ("block_tile", block_tile)):
        if t.dtype != torch.int32 or t.shape != (nb,) or t.device != dev:
            raise ValueError(f"{name} must be [{nb}] int32 on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if not 0 < block <= _B_MAX:
        raise ValueError(f"pair_block must be in [1, {_B_MAX}], got {block}")
    if ts * ts > _P2_MAX_THREADS:
        raise ValueError(f"tile_size**2 must be <= {_P2_MAX_THREADS}, got {ts * ts}")
    tensors = tuple(x.contiguous() for x in (table, block_src, block_valid, block_tile))
    return tensors, (ts, tiles_x, block), (float(power_floor), float(alpha_cap),
                                           float(alpha_floor))


def _checked_logti(logti, nb, p2, dev):
    if logti.dtype != torch.float32 or logti.shape != (nb, p2) or logti.device != dev:
        raise ValueError(f"logti must be [{nb}, {p2}] float32 on {dev}, got "
                         f"{tuple(logti.shape)} {logti.dtype} on {logti.device}")
    return logti.contiguous()


def _c_fn(lib, name, pointers_before, ints, floats, pointers_after):
    """ctypes prototype: pointers, long long EP, pointers, ints, floats,
    pointers, stream; returns int."""
    fn = getattr(lib, name)
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = ([vp, ctypes.c_longlong] + [vp] * pointers_before
                       + [ctypes.c_int] * ints + [ctypes.c_float] * floats
                       + [vp] * pointers_after + [vp])
        fn.restype = ctypes.c_int
    return fn


def _launch_fwd_cuda(table, block_src, block_valid, block_tile, row0, block,
                     cfg_consts, logti=None, log_thr=None):
    """gs_blend_fwd_win, or gs_blend_fwd_win_tf when ``logti`` is given
    (then gid is None: the T-floor pass takes it from the first pass)."""
    from gaussiansplatting_tpu_torch.kernels import build

    (table, block_src, block_valid, block_tile), (ts, tiles_x, block), floats = (
        _checked_launch_args(table, block_src, block_valid, block_tile, block,
                             cfg_consts))
    nb = block_src.shape[0]
    dev = table.device
    out = torch.empty((nb, 4, ts * ts), dtype=torch.float32, device=dev)
    tf = logti is not None
    gid = None if tf else torch.empty((nb, block), dtype=torch.float32, device=dev)
    if tf:
        logti = _checked_logti(logti, nb, ts * ts, dev)
    if nb == 0:
        return out, gid
    lib = build.load_library("blend_fwd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    windows = (table.data_ptr(), table.shape[1], block_src.data_ptr(),
               block_valid.data_ptr(), block_tile.data_ptr())
    ints = (nb, block, ts, tiles_x, int(row0))
    with torch.cuda.device(dev):
        if tf:
            name = "gs_blend_fwd_win_tf"
            err = _c_fn(lib, name, 4, 5, 4, 1)(
                *windows, logti.data_ptr(), *ints, *floats, float(log_thr),
                out.data_ptr(), stream)
        else:
            name = "gs_blend_fwd_win"
            err = _c_fn(lib, name, 3, 5, 3, 2)(
                *windows, *ints, *floats, out.data_ptr(), gid.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    if tf:
        windowed_blend_fwd_tf.launches += 1
    else:
        windowed_blend_fwd.launches += 1
    return out, gid


def _launch_bwd_cuda(table, block_src, block_valid, block_tile, row0, block,
                     g, cfg_consts, logti=None, log_thr=None):
    """gs_blend_bwd_win, or gs_blend_bwd_win_tf when ``logti`` is given."""
    from gaussiansplatting_tpu_torch.kernels import build

    (table, block_src, block_valid, block_tile), (ts, tiles_x, block), floats = (
        _checked_launch_args(table, block_src, block_valid, block_tile, block,
                             cfg_consts))
    nb = block_src.shape[0]
    dev = table.device
    p2 = ts * ts
    if g.dtype != torch.float32 or g.shape != (nb, 4, p2) or g.device != dev:
        raise ValueError(f"g must be [{nb}, 4, {p2}] float32 on {dev}, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    warps = -(-p2 // 32)
    smem = (1 + warps) * 9 * block * 4 + _BWD_STATIC_SMEM
    if smem > _SMEM_MAX:
        raise ValueError(f"pair_block {block} at tile_size {ts} needs {smem} "
                         f"bytes of shared memory (at most {_SMEM_MAX})")
    g = g.contiguous()
    tf = logti is not None
    if tf:
        logti = _checked_logti(logti, nb, p2, dev)
    dcols = torch.empty((9, nb, block), dtype=torch.float32, device=dev)
    if nb > 0:
        lib = build.load_library("blend_bwd")
        windows = (table.data_ptr(), table.shape[1], block_src.data_ptr(),
                   block_valid.data_ptr(), block_tile.data_ptr(), g.data_ptr())
        ints = (nb, block, ts, tiles_x, int(row0))
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            if tf:
                name = "gs_blend_bwd_win_tf"
                err = _c_fn(lib, name, 5, 5, 4, 1)(
                    *windows, logti.data_ptr(), *ints, *floats, float(log_thr),
                    dcols.data_ptr(), stream)
            else:
                name = "gs_blend_bwd_win"
                err = _c_fn(lib, name, 4, 5, 3, 1)(
                    *windows, *ints, *floats, dcols.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        if tf:
            windowed_blend_bwd_tf.launches += 1
        else:
            windowed_blend_bwd.launches += 1
    return tuple(dcols.unbind(0))


class _Replay(NamedTuple):
    """The forward of one chunk of K blocks, as both plain versions need
    it: [K, B] lane columns and [K, P2, B] pixel-by-lane terms."""
    live: torch.Tensor      # [K, B] lane < block_valid
    cols: torch.Tensor      # [10, K, B] table rows 0..9 of the window
    op: torch.Tensor        # [K, B] opacity, 0 on dead / degenerate lanes
    dx: torch.Tensor        # [K, P2, B] pixel minus tile-relative mean
    dy: torch.Tensor
    a_raw: torch.Tensor     # [K, P2, B] uncapped alpha
    alpha: torch.Tensor     # [K, P2, B] capped and masked alpha (0 past the T-floor)
    log1m: torch.Tensor     # [K, P2, B] log1p(-alpha)
    t_local: torch.Tensor   # [K, P2, B] in-block transmittance in front
    margin: torch.Tensor | None  # [K, P2] T-floor termination margin


def _replay(table, block_src, block_valid, block_tile, row0, block, cfg_consts,
            k0, k1, logti=None, log_thr=0.0):
    """Blocks [k0, k1): gather each window into aligned [K, B] columns,
    then the rasterize._block_blend math with the direct quadratic form

        power = -0.5 (a dx^2 + c dy^2) - b dx dy,   dx = px - mx,

    written in the same operation order as the kernels, the alpha mask and
    T = exp(cumsum(l) - l).

    With ``logti`` (the T-floor pass), a lane survives iff
    (cumsum(l) - l) + logti > log_thr, computed from the unmasked l as
    _fwd_kernel_tf does; alpha and l are zeroed past it.  Survivors are a
    prefix of the kept lanes, so their T is unchanged.  ``margin`` is each
    pixel's smallest |(cumsum(l) - l) + logti - log_thr| over kept lanes
    (inf where none is kept): how near the decision came to flipping."""
    ts, power_floor, alpha_cap, alpha_floor, tiles_x = cfg_consts
    ts, tiles_x, block = int(ts), int(tiles_x), int(block)
    dev = table.device
    half = ts / 2.0
    coords = torch.arange(ts, dtype=torch.float32, device=dev) + 0.5 - half
    py = coords.repeat_interleave(ts)[None, :, None]   # [1, P2, 1], p = y*ts + x
    px = coords.repeat(ts)[None, :, None]
    lane = torch.arange(block, dtype=torch.int64, device=dev)

    valid = block_valid[k0:k1].long()
    live = lane[None, :] < valid[:, None]                           # [K, B]
    idx = torch.where(live, block_src[k0:k1].long()[:, None] + lane, 0)
    w = table[:10, idx]                                             # [10, K, B]
    t = block_tile[k0:k1]
    tcx = (t % tiles_x).to(torch.float32) * ts + half
    tcy = (t // tiles_x + int(row0)).to(torch.float32) * ts + half
    mx = (w[1] - tcx[:, None])[:, None, :]                          # [K, 1, B]
    my = (w[2] - tcy[:, None])[:, None, :]
    ca, cb, cc = (w[r][:, None, :] for r in (3, 4, 5))
    conic_mag = w[3].abs() + w[4].abs() + w[5].abs()
    op = torch.where(live & (conic_mag >= 1e-4), w[6], 0.0)

    dx = px - mx                                                    # [K, P2, B]
    dy = py - my
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * (dx * dy)
    a_raw = op[:, None, :] * torch.exp(power)
    mask = (power <= 0.0) & (power >= power_floor) & (a_raw >= alpha_floor)
    alpha = torch.where(mask, torch.clamp(a_raw, max=alpha_cap), 0.0)
    log1m = torch.log1p(-alpha)
    log_excl = torch.cumsum(log1m, dim=-1) - log1m
    t_local = torch.exp(log_excl)
    margin = None
    if logti is not None:
        log_global = log_excl + logti[k0:k1, :, None]
        survive = log_global > log_thr
        margin = torch.where(mask, (log_global - log_thr).abs(),
                             torch.inf).amin(-1)                    # [K, P2]
        alpha = torch.where(survive, alpha, 0.0)
        log1m = torch.where(survive, log1m, 0.0)
    return _Replay(live, w, op, dx, dy, a_raw, alpha, log1m, t_local, margin)


def _fwd_plain(table, block_src, block_valid, block_tile, row0, block,
               cfg_consts, logti, log_thr, chunk_blocks):
    """(out, gid, margin) of the plain forward, in chunks of blocks."""
    _check_no_grad(table)
    dev = table.device
    nb = block_src.shape[0]
    p2 = int(cfg_consts[0]) ** 2
    outs, gids, margins = [], [], []
    for k0 in range(0, nb, chunk_blocks):
        r = _replay(table, block_src, block_valid, block_tile, row0, block,
                    cfg_consts, k0, min(k0 + chunk_blocks, nb), logti, log_thr)
        gids.append(torch.where(r.live, r.cols[0], -1.0))
        weight = r.alpha * r.t_local                                # [K, P2, B]
        color = r.cols[7:10].permute(1, 2, 0)                       # [K, B, 3]
        c_b = torch.bmm(weight, color).transpose(1, 2)              # [K, 3, P2]
        s_b = r.log1m.sum(-1)[:, None, :]                           # [K, 1, P2]
        outs.append(torch.cat([c_b, s_b], dim=1))
        if r.margin is not None:
            margins.append(r.margin)
    if not outs:
        return (torch.zeros((0, 4, p2), dtype=torch.float32, device=dev),
                torch.zeros((0, int(block)), dtype=torch.float32, device=dev),
                torch.zeros((0, p2), dtype=torch.float32, device=dev))
    return (torch.cat(outs), torch.cat(gids),
            torch.cat(margins) if margins else None)


def windowed_blend_fwd_plain(table, block_src, block_valid, block_tile, row0,
                             block, cfg_consts, chunk_blocks: int = 256):
    """Plain PyTorch version of the forward kernel (the CPU path and the
    kernel's oracle): the replay (see _replay), then C = sum w c and
    S = sum log1p(-alpha).  Blocks go in chunks of ``chunk_blocks`` so no
    [NB, P2, B] intermediate is ever whole."""
    out, gid, _ = _fwd_plain(table, block_src, block_valid, block_tile, row0,
                             block, cfg_consts, None, 0.0, chunk_blocks)
    return out, gid


def windowed_blend_fwd_tf_plain(table, block_src, block_valid, block_tile,
                                row0, block, cfg_consts, logti, log_thr,
                                return_margin: bool = False,
                                chunk_blocks: int = 256):
    """Plain PyTorch version of the T-floor forward kernel: C = sum w c over
    the surviving lanes and S = sum of their log1p(-alpha).  With
    ``return_margin``, returns (out, margin [NB, P2]) (see _replay), which
    the kernel comparisons use to excuse termination flips."""
    out, _, margin = _fwd_plain(table, block_src, block_valid, block_tile,
                                row0, block, cfg_consts, logti, log_thr,
                                chunk_blocks)
    return (out, margin) if return_margin else out


def _bwd_plain(table, block_src, block_valid, block_tile, row0, block, g,
               cfg_consts, logti, log_thr, chunk_blocks):
    """(nine columns, margin) of the plain backward, in chunks of blocks."""
    dev = table.device
    nb = block_src.shape[0]
    cols, margins = [], []
    for k0 in range(0, nb, chunk_blocks):
        k1 = min(k0 + chunk_blocks, nb)
        r = _replay(table, block_src, block_valid, block_tile, row0, block,
                    cfg_consts, k0, k1, logti, log_thr)
        gg = g[k0:k1]                                               # [K, 4, P2]
        wgt = r.alpha * r.t_local                                   # [K, P2, B]
        e = (gg[:, 0, :, None] * r.cols[7][:, None, :]
             + gg[:, 1, :, None] * r.cols[8][:, None, :]
             + gg[:, 2, :, None] * r.cols[9][:, None, :])
        ew = e * wgt
        suffix = ew.flip(-1).cumsum(-1).flip(-1) - ew               # sum_{j>i}
        dl = suffix + gg[:, 3, :, None]
        dalpha = e * r.t_local - dl / (1.0 - r.alpha)
        # alpha > 0 exactly on the kept (and, with the T-floor, surviving)
        # lanes, so g_S and every other term reaches those alone
        dpow = torch.where(r.alpha > 0.0, dalpha * r.a_raw, 0.0)
        pdx = dpow * r.dx
        pdy = dpow * r.dy
        s_x = pdx.sum(1)                                            # [K, B]
        s_y = pdy.sum(1)
        ca, cb, cc = r.cols[3], r.cols[4], r.cols[5]
        dcol = torch.bmm(gg[:, :3, :], wgt)                         # [K, 3, B]
        opv = r.op
        chunk = torch.stack([
            ca * s_x + cb * s_y,
            cb * s_x + cc * s_y,
            -0.5 * (pdx * r.dx).sum(1),
            -(pdx * r.dy).sum(1),
            -0.5 * (pdy * r.dy).sum(1),
            torch.where(opv > 0.0, dpow.sum(1) / torch.where(opv > 0.0, opv, 1.0), 0.0),
            dcol[:, 0], dcol[:, 1], dcol[:, 2],
        ])                                                          # [9, K, B]
        cols.append(torch.where(r.live, chunk, 0.0))
        if r.margin is not None:
            margins.append(r.margin)
    if not cols:
        p2 = int(cfg_consts[0]) ** 2
        return (tuple(torch.zeros((0, int(block)), dtype=torch.float32, device=dev)
                      for _ in range(9)),
                torch.zeros((0, p2), dtype=torch.float32, device=dev))
    return (tuple(torch.cat(cols, dim=1).unbind(0)),
            torch.cat(margins) if margins else None)


def windowed_blend_bwd_plain(table, block_src, block_valid, block_tile, row0,
                             block, g, cfg_consts, chunk_blocks: int = 256):
    """Plain PyTorch version of the backward kernel (the CPU path and the
    kernel's oracle), the chain rule written out per chunk of blocks:

        e = sum_ch g_ch c_ch,   dl = sum_{j>i} e_j w_j + g_S,
        dalpha = e T - dl / (1 - alpha),   dpow = dalpha a_raw (kept lanes),

    then the moment sums of dpow against (dx, dy) over the pixels, d op =
    sum dpow / op and d colour = sum g_ch w.  The alpha cap passes the
    gradient through, as in the TPU kernel."""
    dcols, _ = _bwd_plain(table, block_src, block_valid, block_tile, row0,
                          block, g, cfg_consts, None, 0.0, chunk_blocks)
    return dcols


def windowed_blend_bwd_tf_plain(table, block_src, block_valid, block_tile,
                                row0, block, g, cfg_consts, logti, log_thr,
                                return_margin: bool = False,
                                chunk_blocks: int = 256):
    """Plain PyTorch version of the T-floor backward kernel, the chain rule
    of _bwd_kernel_tf: the replay with the termination mask held constant,
    then windowed_blend_bwd_plain's chain rule over the surviving lanes,

        dl = sum_{j>i} e_j w_j + g_S where the lane survives,
        dpow = dalpha a_raw on lanes both kept and surviving;

    logti gets no cotangent.  With ``return_margin``, returns (columns,
    margin [NB, P2])."""
    dcols, margin = _bwd_plain(table, block_src, block_valid, block_tile,
                               row0, block, g, cfg_consts, logti, log_thr,
                               chunk_blocks)
    return (dcols, margin) if return_margin else dcols
