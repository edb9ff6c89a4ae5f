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
           (each block's incoming log-transmittance within its tile, from
           the unmasked first pass, ops.compose.compose_logti) and
           log_thr = log(transmittance_floor).  A kept lane survives iff
           its exclusive in-block log T plus logti is > log_thr
           (tiled_shaders.metal:334); termination is monotone, so the
           survivors are a prefix of each pixel's kept lanes.  The forward
           returns (out, stop): out is C and S over the survivors, stop
           [NB, P2] int32 each pixel's stop lane, one past its last
           surviving lane (0 where none survives).  The backward holds the
           mask constant, and logti gets no cotangent.

  s_b      the backward also takes s_b [NB, P2] f32, the forward's S_b
           (``out[:, 3]``; of the T-floor forward, its masked S_b, with its
           ``stop``): the kernel walks each pixel's transmittance back from
           it instead of replaying the forward.
  packed   the bf16 payload mode (the TPU kernels' packed branch,
           cfg_consts = (..., tiles_x, packed=1, pack_pos)): ``_packed``
           entries over the 8-row table [8, EP] (0=gid, 1=sx, 2=sy,
           3..6 = bf16 pairs (a, b), (c, op), (r, g), (b, 0); with pack_pos
           1 = the tile-relative (mx, my) pair and 2..5 the four pairs).
           The in-block prefix takes each l = log1p(-alpha) rounded to bf16
           (T = exp(Q - l), Q their float32 sum up to the lane), the
           backward's suffix each e w rounded to bf16; S_b stays the
           unrounded sum.  The forward returns (out, gid, q_b), q_b [NB, P2]
           each pixel's Q over the block, which the backward takes in place
           of s_b; the backward returns five bf16-pair rows (dmx, dmy),
           (da, db), (dc, dop), (dr, dg), (db, 0).  The float32 entries
           refuse packed constants and the packed ones float32 constants.
           The kernels carry T by multiplication, exp(Q) times a cubic in
           the bf16 rounding error l - bf16(l) (csrc/blend_common.cuh).

On a CUDA tensor each wrapper launches its kernel (csrc/blend_fwd.cu,
csrc/blend_bwd.cu) and counts the launch under its own name in
utils/tracing.py's registry; on a CPU tensor it runs the plain version.
Nothing falls back from one to the other.  The wrappers are raw kernel
entries: gradients reach the backward through ops/rasterize._BlendWindows,
so the forward refuses inputs that require grad.

The kernels (``gs_blend_*_win``, ``gs_blend_*_win_tf`` and
``gs_blend_*_win_packed``) are instances of one design for Hopper: several
pixels per thread, staged lane records, a per-warp cull, the backward
walking back from s_b with a batched warp exchange; the packed instances
carry T by multiplication.

Every launch goes to ``torch.cuda.current_stream``, so a train step or a
render captured as a CUDA graph (train/graph.py) records it.  The graph's
eager warm-up call loads the shared libraries before the capture; the
``cudaFuncSetAttribute`` each launch makes is no stream operation, so the
capture may make it again.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussiansplatting_tpu_torch.kernels import build
from gaussiansplatting_tpu_torch.ops import packing
from gaussiansplatting_tpu_torch.utils import tracing

_P2_MAX = 1024           # pixels of a tile (ts <= 32)
_B_MAX = 1024            # staged window lanes
_SMEM_MAX = 232_448      # bytes of shared memory a Hopper block can have
_TF_BWD_STATIC_SMEM = 128  # blend_bwd.cu's static warp_stop array (T-floor instance)
_LANE_BYTES = 48         # blend_common.cuh's staged lane record
# pixels per thread: the forward's kPixels and, for its T-floor instance,
# kPixelsTF (blend_fwd.cu); the backward's kPixels in both instances
# (blend_bwd.cu)
_FWD_PIXELS = {False: 4, True: 2}
_BWD_PIXELS = 2

tracing.counted("windowed_blend_fwd", "windowed_blend_fwd_tf", "windowed_blend_bwd",
                "windowed_blend_bwd_tf", "windowed_blend_fwd_packed",
                "windowed_blend_bwd_packed")


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
    """Forward windowed blend: returns (out [NB, 4, P2], gid [NB, B] f32)."""
    _check_payload("windowed_blend_fwd", cfg_consts, False)
    _check_no_grad(table)
    if _device_type("windowed_blend_fwd", table) == "cuda":
        return _launch_fwd_cuda("windowed_blend_fwd", table, block_src,
                                block_valid, block_tile, row0, block,
                                cfg_consts)
    return windowed_blend_fwd_plain(table, block_src, block_valid, block_tile,
                                    row0, block, cfg_consts)


def windowed_blend_fwd_tf(table, block_src, block_valid, block_tile, row0,
                          block, cfg_consts, logti, log_thr):
    """Forward windowed blend with the exact T-floor: returns (out [NB, 4,
    P2] over each pixel's surviving lanes, stop [NB, P2] int32)."""
    _check_payload("windowed_blend_fwd_tf", cfg_consts, False)
    _check_no_grad(table)
    if _device_type("windowed_blend_fwd_tf", table) == "cuda":
        return _launch_fwd_cuda("windowed_blend_fwd_tf", table, block_src,
                                block_valid, block_tile, row0, block,
                                cfg_consts, logti, log_thr)
    return windowed_blend_fwd_tf_plain(table, block_src, block_valid,
                                       block_tile, row0, block, cfg_consts,
                                       logti, log_thr)


def windowed_blend_bwd(table, block_src, block_valid, block_tile, row0, block,
                       g, s_b, cfg_consts):
    """Backward windowed blend: the nine [NB, B] column cotangents (mx, my,
    a, b, c, op, r, g, b) of the forward's ``out`` given its cotangent ``g``
    [NB, 4, P2] and its S_b ``s_b`` = ``out[:, 3]`` [NB, P2]."""
    _check_payload("windowed_blend_bwd", cfg_consts, False)
    if _device_type("windowed_blend_bwd", table) == "cuda":
        return _launch_bwd_cuda("windowed_blend_bwd", table, block_src,
                                block_valid, block_tile, row0, block, g,
                                cfg_consts, s_b=s_b)
    return windowed_blend_bwd_plain(table, block_src, block_valid, block_tile,
                                    row0, block, g, s_b, cfg_consts)


def windowed_blend_fwd_packed(table, block_src, block_valid, block_tile, row0,
                              block, cfg_consts):
    """Forward windowed blend of the bf16 payload mode (an 8-row packed
    table; cfg_consts carries the (packed, pack_pos) flags): returns (out
    [NB, 4, P2], gid [NB, B], q_b [NB, P2]), q_b each pixel's bf16-rounded
    log T total, which the packed backward takes."""
    _check_no_grad(table)
    _check_payload("windowed_blend_fwd_packed", cfg_consts, True)
    if _device_type("windowed_blend_fwd_packed", table) == "cuda":
        return _launch_fwd_cuda("windowed_blend_fwd_packed", table, block_src,
                                block_valid, block_tile, row0, block, cfg_consts)
    return windowed_blend_fwd_packed_plain(table, block_src, block_valid, block_tile,
                                           row0, block, cfg_consts)


def windowed_blend_bwd_packed(table, block_src, block_valid, block_tile, row0,
                              block, g, q_b, cfg_consts):
    """Backward windowed blend of the bf16 payload mode: five [NB, B]
    bf16-pair rows (dmx, dmy), (da, db), (dc, dop), (dr, dg), (db, 0) of
    the packed forward's ``out`` given its cotangent ``g`` [NB, 4, P2] and
    its ``q_b`` [NB, P2]."""
    _check_payload("windowed_blend_bwd_packed", cfg_consts, True)
    if _device_type("windowed_blend_bwd_packed", table) == "cuda":
        return _launch_bwd_cuda("windowed_blend_bwd_packed", table, block_src,
                                block_valid, block_tile, row0, block, g,
                                cfg_consts, s_b=q_b)
    return windowed_blend_bwd_packed_plain(table, block_src, block_valid, block_tile,
                                           row0, block, g, q_b, cfg_consts)


def windowed_blend_bwd_tf(table, block_src, block_valid, block_tile, row0,
                          block, g, s_b, stop, cfg_consts, logti, log_thr):
    """Backward of windowed_blend_fwd_tf with the termination mask held
    constant: the nine [NB, B] column cotangents given ``g`` [NB, 4, P2]
    and the T-floor forward's masked S_b ``s_b`` = ``out[:, 3]`` [NB, P2]
    and ``stop`` [NB, P2] int32, from which the kernel walks each pixel
    back.  ``logti`` and ``log_thr`` are the forward's; only the plain
    version reads them (it replays the mask from them)."""
    _check_payload("windowed_blend_bwd_tf", cfg_consts, False)
    if _device_type("windowed_blend_bwd_tf", table) == "cuda":
        return _launch_bwd_cuda("windowed_blend_bwd_tf", table, block_src,
                                block_valid, block_tile, row0, block, g,
                                cfg_consts, s_b=s_b, stop=stop)
    return windowed_blend_bwd_tf_plain(table, block_src, block_valid,
                                       block_tile, row0, block, g, s_b, stop,
                                       cfg_consts, logti, log_thr)


def _check_payload(name, cfg_consts, packed):
    """The packed entries take the bf16 payload mode's constants, the
    others refuse them."""
    if payload_flags(cfg_consts)[0] != packed:
        raise ValueError(
            f"{name} takes {'packed' if packed else 'float32'} payload constants, got "
            f"{tuple(cfg_consts)}: the bf16 payload mode runs "
            f"windowed_blend_{{fwd,bwd}}_packed")


def _checked_launch_args(table, block_src, block_valid, block_tile, block,
                         cfg_consts):
    """Validate what the kernels take; returns contiguous inputs and the
    int/float constants.  The table has 10 rows that the kernels read (16
    in all); packed, 7, and 6 with pack_pos (8 in all)."""
    ts, power_floor, alpha_cap, alpha_floor, tiles_x = cfg_consts[:5]
    ts, tiles_x, block = int(ts), int(tiles_x), int(block)
    nb = block_src.shape[0]
    dev = table.device
    packed, pack_pos = payload_flags(cfg_consts)
    rows = (6 if pack_pos else 7) if packed else 10
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[0] < rows:
        raise ValueError(f"table must be [>={rows}, EP] float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    for name, t in (("block_src", block_src), ("block_valid", block_valid),
                    ("block_tile", block_tile)):
        if t.dtype != torch.int32 or t.shape != (nb,) or t.device != dev:
            raise ValueError(f"{name} must be [{nb}] int32 on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if not 0 < block <= _B_MAX:
        raise ValueError(f"pair_block must be in [1, {_B_MAX}], got {block}")
    if ts * ts > _P2_MAX:
        raise ValueError(f"tile_size**2 must be <= {_P2_MAX}, got {ts * ts}")
    tensors = tuple(x.contiguous() for x in (table, block_src, block_valid, block_tile))
    return tensors, (ts, tiles_x, block), (float(power_floor), float(alpha_cap),
                                           float(alpha_floor))


def _checked_plane(name, x, nb, p2, dev, dtype=torch.float32):
    """A [NB, P2] input (logti, s_b: float32; stop: int32) on ``dev``,
    contiguous."""
    if x.dtype != dtype or x.shape != (nb, p2) or x.device != dev:
        raise ValueError(f"{name} must be [{nb}, {p2}] {str(dtype)[6:]} on {dev}, "
                         f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    return x.contiguous()


def launch_geometry(ts, block, backward, tfloor=False):
    """(threads, shared-memory bytes) of one CUDA block of the blend at tile
    size ``ts`` and ``block`` lanes, as csrc/blend_fwd.cu and blend_bwd.cu
    launch it: ts * ceil(ts / P) threads (P = 4 pixels each in the forward,
    2 in the backward; 2 in both T-floor instances, ``tfloor``; the packed
    instances as the float32 ones) rounded up to whole warps, 48 bytes per
    staged lane and, in the backward, 9 floats per (warp, lane) of partial
    sums (plus, in the T-floor instance, the static warp_stop array).
    Raises where the block would need more shared memory than a Hopper
    block can have (232,448 bytes)."""
    ts, block = int(ts), int(block)
    pixels = _BWD_PIXELS if backward else _FWD_PIXELS[bool(tfloor)]
    threads = -(-ts * -(-ts // pixels) // 32) * 32
    smem = block * _LANE_BYTES
    if backward:
        smem += threads // 32 * 9 * block * 4 + (_TF_BWD_STATIC_SMEM if tfloor else 0)
    if smem > _SMEM_MAX:
        raise ValueError(f"pair_block {block} at tile_size {ts} needs {smem} "
                         f"bytes of shared memory (at most {_SMEM_MAX})")
    return threads, smem


def _signature(inputs, ints, floats, outputs) -> str:
    """build.launch's signature of a blend entry: the table and its row
    length EP, the window arrays, then ``inputs`` more pointers, the ints,
    the floats and ``outputs`` pointers."""
    return "pLppp" + "p" * inputs + "i" * ints + "f" * floats + "p" * outputs


def _launch_fwd_cuda(name, table, block_src, block_valid, block_tile, row0,
                     block, cfg_consts, logti=None, log_thr=None):
    """gs_blend_fwd_win, which returns (out, gid), or, when ``logti`` is
    given, gs_blend_fwd_win_tf, which returns (out, stop); with packed
    constants gs_blend_fwd_win_packed, which returns (out, gid, q_b).
    ``name``: the wrapper, under which the launch counts."""
    (table, block_src, block_valid, block_tile), (ts, tiles_x, block), floats = (
        _checked_launch_args(table, block_src, block_valid, block_tile, block,
                             cfg_consts))
    nb = block_src.shape[0]
    dev = table.device
    tf = logti is not None
    packed, pack_pos = payload_flags(cfg_consts)
    launch_geometry(ts, block, False, tf)
    ints = (nb, block, ts, tiles_x, int(row0))
    inputs = ()
    out = torch.empty((nb, 4, ts * ts), dtype=torch.float32, device=dev)
    if packed:
        outs = (out, torch.empty((nb, block), dtype=torch.float32, device=dev),
                torch.empty((nb, ts * ts), dtype=torch.float32, device=dev))
        ints += (int(pack_pos),)
    elif tf:
        inputs = (_checked_plane("logti", logti, nb, ts * ts, dev),)
        outs = (out, torch.empty((nb, ts * ts), dtype=torch.int32, device=dev))
        floats += (float(log_thr),)
    else:
        outs = (out, torch.empty((nb, block), dtype=torch.float32, device=dev))
    if nb > 0:
        symbol = "gs_blend_fwd_win" + ("_tf" if tf else "") + ("_packed" if packed else "")
        build.launch("blend_fwd", symbol, _signature(len(inputs), len(ints), len(floats),
                                                     len(outs)), dev,
                     table, table.shape[1], block_src, block_valid, block_tile, *inputs,
                     *ints, *floats, *outs, count=name)
    return outs


def _launch_bwd_cuda(name, table, block_src, block_valid, block_tile, row0,
                     block, g, cfg_consts, s_b, stop=None):
    """gs_blend_bwd_win given the forward's ``s_b``, or gs_blend_bwd_win_tf
    given the T-floor forward's ``s_b`` and ``stop``; with packed constants
    gs_blend_bwd_win_packed, given the packed forward's q_b as ``s_b``,
    which returns five packed rows.  ``name``: the wrapper, under which the
    launch counts."""
    (table, block_src, block_valid, block_tile), (ts, tiles_x, block), floats = (
        _checked_launch_args(table, block_src, block_valid, block_tile, block,
                             cfg_consts))
    nb = block_src.shape[0]
    dev = table.device
    p2 = ts * ts
    if g.dtype != torch.float32 or g.shape != (nb, 4, p2) or g.device != dev:
        raise ValueError(f"g must be [{nb}, 4, {p2}] float32 on {dev}, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    tf = stop is not None
    packed, pack_pos = payload_flags(cfg_consts)
    launch_geometry(ts, block, True, tf)
    # the pointers each entry takes after the window arrays, its ints and floats
    inputs = (g.contiguous(), _checked_plane("q_b" if packed else "s_b", s_b, nb, p2, dev))
    ints = (nb, block, ts, tiles_x, int(row0))
    if packed:
        ints += (int(pack_pos),)
    elif tf:
        inputs += (_checked_plane("stop", stop, nb, p2, dev, torch.int32),)
    dcols = torch.empty((5 if packed else 9, nb, block), dtype=torch.float32, device=dev)
    if nb > 0:
        symbol = "gs_blend_bwd_win" + ("_tf" if tf else "") + ("_packed" if packed else "")
        build.launch("blend_bwd", symbol, _signature(len(inputs), len(ints), len(floats), 1),
                     dev, table, table.shape[1], block_src, block_valid, block_tile, *inputs,
                     *ints, *floats, dcols, count=name)
    return tuple(dcols.unbind(0))


class _Replay(NamedTuple):
    """The forward of one chunk of K blocks, as both plain versions need
    it: [K, B] lane columns and [K, P2, B] pixel-by-lane terms."""
    live: torch.Tensor      # [K, B] lane < block_valid
    cols: torch.Tensor      # [10, K, B] the window's gid, sx, sy (packed
                            # with pack_pos: mx, my), conic, opacity, rgb,
                            # unpacked
    mx: torch.Tensor        # [K, B] mean relative to the tile centre
    my: torch.Tensor
    op: torch.Tensor        # [K, B] opacity, 0 on dead / degenerate lanes
    dx: torch.Tensor        # [K, P2, B] pixel minus tile-relative mean
    dy: torch.Tensor
    a_raw: torch.Tensor     # [K, P2, B] uncapped alpha
    alpha: torch.Tensor     # [K, P2, B] capped and masked alpha (0 past the T-floor)
    log1m: torch.Tensor     # [K, P2, B] log1p(-alpha)
    t_local: torch.Tensor   # [K, P2, B] in-block transmittance in front
    margin: torch.Tensor | None  # [K, P2] T-floor termination margin
    stop: torch.Tensor | None    # [K, P2] int32 T-floor stop lane
    q_b: torch.Tensor | None     # [K, P2] packed: the bf16-rounded log T total


def payload_flags(cfg_consts) -> tuple[bool, bool]:
    """(packed, pack_pos) of a blend's constants: the JAX bconsts' two
    trailing flags (rasterize.py:375-376), both False when absent."""
    packed = len(cfg_consts) > 5 and bool(cfg_consts[5])
    return packed, packed and len(cfg_consts) > 6 and bool(cfg_consts[6])


def _window_columns(table, idx, tcx, tcy, packed, pack_pos):
    """The window's ten columns [10, K, B] (gid, x, y, ca, cb, cc, op, r, g,
    b) and its tile-relative mean (mx, my) [K, B], unpacking a packed table
    (_win_cols, pallas_blend.py:504-542)."""
    if not packed:
        w = table[:10, idx]
        return w, w[1] - tcx[:, None], w[2] - tcy[:, None]
    rows = table[:7, idx]
    if pack_pos:
        mx, my = packing.unpack2(rows[1])
        data = packing.unpack_cols(list(rows[2:6]), 7)
        return torch.stack([rows[0], mx, my] + data), mx, my
    data = packing.unpack_cols(list(rows[3:7]), 7)
    w = torch.stack([rows[0], rows[1], rows[2]] + data)
    return w, w[1] - tcx[:, None], w[2] - tcy[:, None]


def _replay(table, block_src, block_valid, block_tile, row0, block, cfg_consts,
            k0, k1, logti=None, log_thr=0.0):
    """Blocks [k0, k1): gather each window into aligned [K, B] columns,
    then the rasterize._block_blend math with the direct quadratic form

        power = -0.5 (a dx^2 + c dy^2) - b dx dy,   dx = px - mx,

    written in the same operation order as the kernels, the alpha mask and
    T = exp(cumsum(l) - l).

    Packed (``payload_flags(cfg_consts)``, the bf16 payload mode): the
    window's columns are unpacked first (a lane's opacity is zeroed on the
    unpacked conic), and the in-block prefix takes each l rounded to bf16,
    T = exp(Q - l) with Q = cumsum(bf16(l)) in float32, as the TPU kernel's
    bf16 triangular matmul does (pallas_blend.py:647, 652); ``q_b`` is each
    pixel's Q over the block.

    With ``logti`` (the T-floor pass), a lane survives iff
    (cumsum(l) - l) + logti > log_thr, computed from the unmasked l as
    _fwd_kernel_tf does; alpha and l are zeroed past it.  Survivors are a
    prefix of the kept lanes, so their T is unchanged.  ``margin`` is each
    pixel's smallest |(cumsum(l) - l) + logti - log_thr| over kept lanes
    (inf where none is kept): how near the decision came to flipping;
    ``stop`` one past each pixel's last surviving lane (0 where none
    survives)."""
    ts, power_floor, alpha_cap, alpha_floor, tiles_x = cfg_consts[:5]
    packed, pack_pos = payload_flags(cfg_consts)
    if packed and logti is not None:
        raise ValueError("the T-floor pass has no packed payload (JAX packs only the "
                         "windowed branch, rasterize.py:304)")
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
    t = block_tile[k0:k1]
    tcx = (t % tiles_x).to(torch.float32) * ts + half
    tcy = (t // tiles_x + int(row0)).to(torch.float32) * ts + half
    w, mx, my = _window_columns(table, idx, tcx, tcy, packed, pack_pos)
    ca, cb, cc = (w[r][:, None, :] for r in (3, 4, 5))
    conic_mag = w[3].abs() + w[4].abs() + w[5].abs()
    op = torch.where(live & (conic_mag >= 1e-4), w[6], 0.0)

    dx = px - mx[:, None, :]                                        # [K, P2, B]
    dy = py - my[:, None, :]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * (dx * dy)
    a_raw = op[:, None, :] * torch.exp(power)
    mask = (power <= 0.0) & (power >= power_floor) & (a_raw >= alpha_floor)
    alpha = torch.where(mask, torch.clamp(a_raw, max=alpha_cap), 0.0)
    log1m = torch.log1p(-alpha)
    q_b = None
    if packed:
        q = torch.cumsum(packing.round_bf16(log1m), dim=-1)
        log_excl, q_b = q - log1m, q[..., -1]
    else:
        log_excl = torch.cumsum(log1m, dim=-1) - log1m
    t_local = torch.exp(log_excl)
    margin = stop = None
    if logti is not None:
        log_global = log_excl + logti[k0:k1, :, None]
        survive = log_global > log_thr
        margin = torch.where(mask, (log_global - log_thr).abs(),
                             torch.inf).amin(-1)                    # [K, P2]
        alpha = torch.where(survive, alpha, 0.0)
        log1m = torch.where(survive, log1m, 0.0)
        # alpha > 0 exactly on the kept lanes that survive
        stop = torch.where(alpha > 0.0, lane + 1, 0).amax(-1).to(torch.int32)
    return _Replay(live, w, mx, my, op, dx, dy, a_raw, alpha, log1m, t_local, margin,
                   stop, q_b)


def _fwd_plain(table, block_src, block_valid, block_tile, row0, block,
               cfg_consts, logti, log_thr, chunk_blocks):
    """(out, gid, margin, stop, q_b) of the plain forward, in chunks of
    blocks (margin and stop None without logti, q_b None unpacked)."""
    _check_no_grad(table)
    dev = table.device
    nb = block_src.shape[0]
    p2 = int(cfg_consts[0]) ** 2
    outs, gids, margins, stops, qs = [], [], [], [], []
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
            stops.append(r.stop)
        if r.q_b is not None:
            qs.append(r.q_b)
    if not outs:
        plane = torch.zeros((0, p2), dtype=torch.float32, device=dev)
        return (torch.zeros((0, 4, p2), dtype=torch.float32, device=dev),
                torch.zeros((0, int(block)), dtype=torch.float32, device=dev),
                plane, plane.to(torch.int32), plane)

    def cat(xs):
        return torch.cat(xs) if xs else None

    return torch.cat(outs), torch.cat(gids), cat(margins), cat(stops), cat(qs)


def windowed_blend_fwd_plain(table, block_src, block_valid, block_tile, row0,
                             block, cfg_consts, chunk_blocks: int = 256):
    """Plain PyTorch version of the forward kernel (the CPU path and the
    kernel's oracle): the replay (see _replay), then C = sum w c and
    S = sum log1p(-alpha).  Blocks go in chunks of ``chunk_blocks`` so no
    [NB, P2, B] intermediate is ever whole."""
    _check_payload("windowed_blend_fwd_plain", cfg_consts, False)
    out, gid, _, _, _ = _fwd_plain(table, block_src, block_valid, block_tile, row0,
                                   block, cfg_consts, None, 0.0, chunk_blocks)
    return out, gid


def windowed_blend_fwd_tf_plain(table, block_src, block_valid, block_tile,
                                row0, block, cfg_consts, logti, log_thr,
                                return_margin: bool = False,
                                chunk_blocks: int = 256):
    """Plain PyTorch version of the T-floor forward kernel: C = sum w c over
    the surviving lanes and S = sum of their log1p(-alpha); returns (out,
    stop), stop taken from the replay's survivors.  With ``return_margin``,
    returns (out, stop, margin [NB, P2]) (see _replay), which the kernel
    comparisons use to excuse termination flips."""
    out, _, margin, stop, _ = _fwd_plain(table, block_src, block_valid, block_tile,
                                         row0, block, cfg_consts, logti, log_thr,
                                         chunk_blocks)
    return (out, stop, margin) if return_margin else (out, stop)


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
        if r.q_b is not None:
            ew = packing.round_bf16(ew)    # the bf16 suffix (pallas_blend.py:751)
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
        chunk = torch.where(r.live, chunk, 0.0)
        if r.q_b is not None:
            chunk = torch.stack(packing.pack_cols(list(chunk)))     # [5, K, B]
        cols.append(chunk)
        if r.margin is not None:
            margins.append(r.margin)
    if not cols:
        p2 = int(cfg_consts[0]) ** 2
        n_out = 5 if payload_flags(cfg_consts)[0] else 9
        return (tuple(torch.zeros((0, int(block)), dtype=torch.float32, device=dev)
                      for _ in range(n_out)),
                torch.zeros((0, p2), dtype=torch.float32, device=dev))
    return (tuple(torch.cat(cols, dim=1).unbind(0)),
            torch.cat(margins) if margins else None)


def windowed_blend_bwd_plain(table, block_src, block_valid, block_tile, row0,
                             block, g, s_b, cfg_consts, chunk_blocks: int = 256):
    """Plain PyTorch version of the backward kernel (the CPU path and the
    kernel's oracle), the chain rule written out per chunk of blocks:

        e = sum_ch g_ch c_ch,   dl = sum_{j>i} e_j w_j + g_S,
        dalpha = e T - dl / (1 - alpha),   dpow = dalpha a_raw (kept lanes),

    then the moment sums of dpow against (dx, dy) over the pixels, d op =
    sum dpow / op and d colour = sum g_ch w.  The alpha cap passes the
    gradient through, as in the TPU kernel.

    ``s_b`` [NB, P2] is the forward's S_b, which the kernel walks each
    pixel's transmittance back from; the plain version checks its shape and
    takes T from its own replay's prefix sums, so it stays an independent
    oracle of the kernel's use of s_b."""
    _check_payload("windowed_blend_bwd_plain", cfg_consts, False)
    _checked_plane("s_b", s_b, block_src.shape[0], int(cfg_consts[0]) ** 2,
                   table.device)
    dcols, _ = _bwd_plain(table, block_src, block_valid, block_tile, row0,
                          block, g, cfg_consts, None, 0.0, chunk_blocks)
    return dcols


def windowed_blend_bwd_tf_plain(table, block_src, block_valid, block_tile,
                                row0, block, g, s_b, stop, cfg_consts, logti,
                                log_thr, return_margin: bool = False,
                                chunk_blocks: int = 256):
    """Plain PyTorch version of the T-floor backward kernel, the chain rule
    of _bwd_kernel_tf: the replay with the termination mask held constant,
    then windowed_blend_bwd_plain's chain rule over the surviving lanes,

        dl = sum_{j>i} e_j w_j + g_S where the lane survives,
        dpow = dalpha a_raw on lanes both kept and surviving;

    logti gets no cotangent.  With ``return_margin``, returns (columns,
    margin [NB, P2]).

    ``s_b`` and ``stop`` [NB, P2] are the T-floor forward's masked S_b and
    stop lanes, which the kernel walks each pixel back from; the plain
    version checks their shapes and replays the mask from logti, so it
    stays an independent oracle of the kernel's use of them."""
    nb, p2 = block_src.shape[0], int(cfg_consts[0]) ** 2
    _checked_plane("s_b", s_b, nb, p2, table.device)
    _checked_plane("stop", stop, nb, p2, table.device, torch.int32)
    dcols, margin = _bwd_plain(table, block_src, block_valid, block_tile,
                               row0, block, g, cfg_consts, logti, log_thr,
                               chunk_blocks)
    return (dcols, margin) if return_margin else dcols


def windowed_blend_fwd_packed_plain(table, block_src, block_valid, block_tile, row0,
                                    block, cfg_consts, chunk_blocks: int = 256):
    """Plain PyTorch version of the packed forward kernel (the bf16 payload
    mode, the TPU kernel's packed branch): windowed_blend_fwd_plain on the
    unpacked window, with T = exp(Q - l), Q the float32 prefix of the
    bf16-rounded l (see _replay).  S_b stays the unrounded sum of l.
    Returns (out [NB, 4, P2], gid [NB, B], q_b [NB, P2]), q_b each pixel's
    Q over the block, which the backward walks back from."""
    _check_payload("windowed_blend_fwd_packed_plain", cfg_consts, True)
    out, gid, _, _, q_b = _fwd_plain(table, block_src, block_valid, block_tile, row0,
                                     block, cfg_consts, None, 0.0, chunk_blocks)
    return out, gid, q_b


def windowed_blend_bwd_packed_plain(table, block_src, block_valid, block_tile, row0,
                                    block, g, q_b, cfg_consts, chunk_blocks: int = 256):
    """Plain PyTorch version of the packed backward kernel: the chain rule
    of windowed_blend_bwd_plain with the packed forward's T and the suffix
    sum_{j>i} bf16(e_j w_j) of bf16-rounded terms (pallas_blend.py:721,
    751), the nine cotangents packed into five bf16-pair rows (dmx, dmy),
    (da, db), (dc, dop), (dr, dg), (db, 0) (pallas_blend.py:807-818).

    ``q_b`` [NB, P2] is the packed forward's; the plain version checks its
    shape and takes T from its own replay, so it stays an independent
    oracle of the kernel's use of q_b."""
    _check_payload("windowed_blend_bwd_packed_plain", cfg_consts, True)
    _checked_plane("q_b", q_b, block_src.shape[0], int(cfg_consts[0]) ** 2, table.device)
    dcols, _ = _bwd_plain(table, block_src, block_valid, block_tile, row0, block, g,
                          cfg_consts, None, 0.0, chunk_blocks)
    return dcols
