"""Compose of the surfel blend's per-block sums into the frame's maps, and
back: the CUDA kernels' wrappers and their plain PyTorch versions.

ops/compose.py's composition with every row of the surfel blend's out
(ops/surfel_blend.py) but S carried as colour is: each block's sums are
scaled by its incoming transmittance t_in = exp(sum of the S_b before it in
its tile).  Contract, for NB blocks of P2 = ts**2 pixels over T tiles:

  inputs   out [NB, 10, P2] f32 (rows 0-2 C, 3 S, 4 sum w z, 5-7 sum w n,
           8 M1, 9 M2); seg [NB] int32, each block's tile, non-decreasing,
           T on padding blocks; consts = (ts, tiles_x, tiles_y, width,
           rows, bg) as ops/compose.py takes them.
  forward  (image [rows, width, 3], aux [rows, width, 7]): the image sum_b
           t_in C_b + bg exp(S); aux the sums of rows 4-9 over the tile's
           blocks, each t_in-scaled (the depth sum, the normal sum (3), M1,
           M2), then the transmittance exp(S), S = sum_b S_b.  float32 sums
           in block order, t_in within a rounding of the float64 prefix.
  backward (g_image, g_aux) -> d_out [NB, 10, P2]: the scaled rows' t_in g,
           and row 3 the float64 suffix over the tile's later blocks of t_in
           <g, row_b'> plus exp(S) (g_T + bg sum_c g_image_c), where g_T is
           aux's last channel's cotangent.

The 2DGS maps follow from aux: alpha A = 1 - exp(S), the expected depth
sum w z / A, the normal sum w n, and the depth distortion A M2 - M1^2 (eq.
13 in its squared form).  On a CUDA tensor each wrapper launches a kernel
of csrc/surfel_compose.cu (one CUDA block a tile, one thread a pixel),
counted as ``surfel_compose_fwd`` / ``surfel_compose_bwd``; on a CPU tensor
the plain version runs.  The kernels leave padding blocks' rows of d_out
unwritten, as ops/compose.py's do: the surfel blend's backward returns
before it reads a block with no live lane.
"""

from __future__ import annotations

import torch

from gaussiansplatting_tpu_torch.kernels import build
from gaussiansplatting_tpu_torch.ops import compose as compose_mod
from gaussiansplatting_tpu_torch.ops.surfel_blend import OUT_ROWS
from gaussiansplatting_tpu_torch.utils import tracing

LIN = (0, 1, 2, 4, 5, 6, 7, 8, 9)   # the rows scaled by t_in
AUX = 7                             # sum w z, sum w n (3), M1, M2, exp(S)

tracing.counted("surfel_compose_fwd", "surfel_compose_bwd")


def _check(out, seg, consts):
    ts, tiles_x, tiles_y, width, rows, _ = consts
    nb, p2 = seg.shape[0], int(ts) ** 2
    if (out.dtype != torch.float32 or out.shape != (nb, OUT_ROWS, p2)
            or out.device != seg.device or not out.is_contiguous()):
        raise ValueError(f"out must be contiguous [{nb}, {OUT_ROWS}, {p2}] float32 on "
                         f"{seg.device}, got {tuple(out.shape)} {out.dtype} on {out.device}")
    if seg.dtype != torch.int32 or seg.dim() != 1:
        raise ValueError(f"seg must be [NB] int32, got {tuple(seg.shape)} {seg.dtype}")
    if not (0 < rows <= tiles_y * ts and 0 < width <= tiles_x * ts and p2 <= 1024):
        raise ValueError(f"compose constants {tuple(consts)}: the image must lie in the tile "
                         f"grid, tile_size**2 <= 1024")
    return nb, p2


def _ints(consts, nb):
    ts, tiles_x, tiles_y, width, rows, _ = consts
    return (nb, int(ts), int(tiles_x), int(tiles_x) * int(tiles_y), int(width), int(rows))


def surfel_compose_fwd(out, seg, consts):
    """(image [rows, width, 3], aux [rows, width, 7]) f32."""
    nb, _ = _check(out, seg, consts)
    if out.device.type != "cuda":
        return surfel_compose_fwd_plain(out, seg, consts)
    img = torch.empty((consts[4], consts[3], 3), dtype=torch.float32, device=out.device)
    aux = torch.empty((consts[4], consts[3], AUX), dtype=torch.float32, device=out.device)
    build.launch("surfel_compose", "gs_surfel_compose_fwd", "pp" + "i" * 6 + "f" + "pp",
                 out.device, out, seg, *_ints(consts, nb), float(consts[5]), img, aux,
                 count="surfel_compose_fwd")
    return img, aux


def surfel_compose_bwd(g_img, g_aux, out, seg, consts):
    """d_out [NB, 10, P2] f32 from the cotangents of the image and aux."""
    nb, p2 = _check(out, seg, consts)
    shape = (consts[4], consts[3])
    g_img = g_img.to(torch.float32).contiguous()
    g_aux = g_aux.to(torch.float32).contiguous()
    if g_img.shape != shape + (3,) or g_aux.shape != shape + (AUX,):
        raise ValueError(f"the cotangents must be {list(shape)} + [3] and [{AUX}], got "
                         f"{tuple(g_img.shape)}, {tuple(g_aux.shape)}")
    if out.device.type != "cuda":
        return surfel_compose_bwd_plain(g_img, g_aux, out, seg, consts)
    d_out = torch.empty((nb, OUT_ROWS, p2), dtype=torch.float32, device=out.device)
    if nb > 0:
        build.launch("surfel_compose", "gs_surfel_compose_bwd", "pppp" + "i" * 6 + "f" + "p",
                     out.device, g_img, g_aux, out, seg, *_ints(consts, nb), float(consts[5]),
                     d_out, count="surfel_compose_bwd")
    return d_out


# -- plain versions: the CPU path and the kernels' oracle


def surfel_compose_fwd_plain(out, seg, consts):
    """Plain PyTorch version of the forward kernel: ops/compose.py's
    incoming_log_t, then the per-tile sums of t_in times each scaled row and
    of S, each in block order."""
    nt, nb, bg = int(consts[1]) * int(consts[2]), seg.shape[0], consts[5]
    t_in = torch.exp(compose_mod.incoming_log_t(out[:, 3], seg, nt))
    lin = out[:, list(LIN)]
    tile_lin = compose_mod._tile_sums((t_in[:, None, :] * lin).reshape(nb, -1), seg, nt)
    tile_lin = tile_lin.reshape(nt, len(LIN), -1)
    trans = torch.exp(compose_mod._tile_sums(out[:, 3], seg, nt))      # [T, P2]
    img = tile_lin[:, :3] + trans[:, None, :] * bg
    aux = torch.cat([tile_lin[:, 3:], trans[:, None, :]], dim=1)
    return compose_mod._image(img, consts), compose_mod._image(aux, consts)


def surfel_compose_bwd_plain(g_img, g_aux, out, seg, consts):
    """Plain PyTorch version of the backward kernel, the chain rule per tile
    (see the module docstring); padding blocks get zeros."""
    nt, bg = int(consts[1]) * int(consts[2]), consts[5]
    t_in = torch.exp(compose_mod.incoming_log_t(out[:, 3], seg, nt))
    live = (seg < nt)[:, None, None]
    tile = torch.clamp(seg, max=nt - 1).long()
    gi = compose_mod._tiles(g_img.to(out.dtype), consts)
    ga = compose_mod._tiles(g_aux.to(out.dtype), consts)
    g_lin = torch.cat([gi, ga[:, :AUX - 1]], dim=1)                      # [T, 9, P2]
    g_b = torch.where(live, g_lin[tile], 0.0)                           # [NB, 9, P2]
    lin = out[:, list(LIN)]
    d_lin = t_in[:, None, :] * g_b
    d_s1 = compose_mod.tile_suffix((g_b * lin).sum(1) * t_in, seg, nt)
    trans = torch.exp(compose_mod._tile_sums(out[:, 3], seg, nt))       # [T, P2]
    g_t = (ga[:, AUX - 1] + bg * gi.sum(1)) * trans
    d_s2 = torch.where(live[:, 0], g_t[tile], 0.0)
    d_out = torch.empty_like(out)
    d_out[:, list(LIN)] = d_lin
    d_out[:, 3] = d_s1 + d_s2
    return d_out
