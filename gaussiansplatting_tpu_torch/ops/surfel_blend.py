"""Windowed block blend of 2D Gaussian surfels, forward and backward: the
CUDA kernels' wrappers and their plain PyTorch versions.

The 3D Gaussian's windowed blend (ops/blend.py) with each (pixel, lane)
test replaced by the ray-splat intersection of 2D Gaussian Splatting (Huang
et al. 2024, arXiv:2403.17888, eqs. 8-12), over the same windows, blocks
and tiles (ops/pairs.py).  Per pixel centre (x, y) and lane, with T the
lane's 3x3 of ops/surfel_projection.py:

    h_u = x T_2 - T_0,  h_v = y T_2 - T_1,  c = h_u x h_v,
    (u, v) = (c_0, c_1) / c_2,  rho3 = u^2 + v^2   (+inf where c_2 = 0),
    rho2 = 2 |(x, y) - (T_02, T_12) / T_22|^2      (eq. 11: sigma = sqrt(2)/2 px),
    power = -rho / 2,  rho = rho3 if rho3 <= rho2 else rho2,
    z = T_20 u + T_21 v + T_22 if rho3 <= rho2 else T_22,
    m = f / (f - n) (1 - n / z),  n = 0.2, f = 100 (2DGS's NEAR_PLANE, FAR_PLANE),

and the 3D Gaussian's window and alpha: kept iff power >= power_floor and
a_raw = op exp(power) >= alpha_floor, alpha = min(a_raw, alpha_cap) with
the cap passing the gradient through, as the 3D Gaussian's kernels and
2DGS's rasterizer do.  Contract, for NB blocks of B lanes and P2 pixels:

  inputs   table [17, EP] f32, tile-sorted pair rows (0 = gid, 1-9 = T
           row-major, 10 = opacity, 11-13 = rgb, 14-16 = the camera-space
           normal n); block_src / block_valid / block_tile [NB] int32 (the
           tile clamped to num_tiles-1); row0; consts = (tile_size,
           power_floor, alpha_cap, alpha_floor, tiles_x).
  forward  out [NB, 10, P2] f32, each pixel's sums over the block's kept
           lanes front to back, w = alpha T_in-block: rows 0-2 sum w c, 3
           S = sum log1p(-alpha), 4 sum w z, 5-7 sum w n, 8 M1 = sum w m,
           9 M2 = sum w m^2; gid [NB, B] f32, -1 on dead lanes.  Every row
           but S composes across a tile's blocks as colour does
           (ops/surfel_compose.py), and the depth distortion of eq. 13 in
           the squared form of 2DGS's rasterizer, sum_{i<j} w_i w_j (m_i -
           m_j)^2, is A M2 - M1^2 of the composed moments (A = sum w).
  backward g [NB, 10, P2], the cotangent of ``out`` -> sixteen [NB, B]
           f32 column cotangents (T's nine, opacity, rgb, n), zero on dead
           lanes and dead blocks.

On a CUDA tensor each wrapper launches a kernel of csrc/surfel_blend.cu and
counts the launch under ``surfel_blend_fwd`` / ``surfel_blend_bwd`` in
utils/tracing.py's registry; on a CPU tensor it runs the plain version.
Nothing falls back from one to the other.  Gradients reach the backward
through ops/rasterize._BlendSurfels.
"""

from __future__ import annotations

import torch

from gaussiansplatting_tpu_torch.kernels import build
from gaussiansplatting_tpu_torch.utils import tracing

OUT_ROWS = 10            # C (3), S, sum w z, sum w n (3), M1, M2
COLS = 16                # T (9), opacity, rgb (3), n (3)
TABLE_ROWS = 17          # gid and COLS
DIST_NEAR, DIST_FAR = 0.2, 100.0
_U_MAX = 1e18            # |u|, |v| past it: rho3 >= 1e36 > any rho2, never a hit
_P2_MAX = 1024
_B_MAX = 1024
# launch geometry: csrc/surfel_blend.cu's pixels per thread (both ways) and
# staged lane record (24 floats)
PIXELS = 2
LANE_BYTES = 96
_SMEM_MAX = 232_448

tracing.counted("surfel_blend_fwd", "surfel_blend_bwd")


def depth_map(z: torch.Tensor) -> torch.Tensor:
    """2DGS's depth mapped to [0, 1) between its near and far planes, m =
    f / (f - n) (1 - n / z)."""
    return DIST_FAR / (DIST_FAR - DIST_NEAR) * (1.0 - DIST_NEAR / z)


def _check_launch(table, block_src, block_valid, block_tile, block, consts):
    ts, tiles_x, block = int(consts[0]), int(consts[4]), int(block)
    nb = block_src.shape[0]
    dev = table.device
    if table.dtype != torch.float32 or table.dim() != 2 or table.shape[0] < TABLE_ROWS:
        raise ValueError(f"table must be [>={TABLE_ROWS}, EP] float32, got "
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
    return nb, ts, tiles_x, block


def launch_geometry(ts, block, backward):
    """(threads, shared-memory bytes) of one CUDA block of the surfel blend
    as csrc/surfel_blend.cu launches it: ts * ceil(ts / 2) threads rounded
    up to whole warps, 96 bytes a staged lane and, backward, 16 floats a
    (warp, lane) of partial sums."""
    ts, block = int(ts), int(block)
    threads = -(-ts * -(-ts // PIXELS) // 32) * 32
    smem = block * LANE_BYTES + (threads // 32 * COLS * block * 4 if backward else 0)
    if smem > _SMEM_MAX:
        raise ValueError(f"pair_block {block} at tile_size {ts} needs {smem} bytes of "
                         f"shared memory (at most {_SMEM_MAX})")
    return threads, smem


def surfel_blend_fwd(table, block_src, block_valid, block_tile, row0, block, consts):
    """Forward: (out [NB, 10, P2], gid [NB, B] f32)."""
    if table.device.type != "cuda":
        return surfel_blend_fwd_plain(table, block_src, block_valid, block_tile, row0, block,
                                      consts)
    nb, ts, tiles_x, block = _check_launch(table, block_src, block_valid, block_tile, block,
                                           consts)
    launch_geometry(ts, block, False)
    dev = table.device
    out = torch.empty((nb, OUT_ROWS, ts * ts), dtype=torch.float32, device=dev)
    gid = torch.empty((nb, block), dtype=torch.float32, device=dev)
    if nb > 0:
        build.launch("surfel_blend", "gs_surfel_blend_fwd", "pLppp" + "i" * 5 + "f" * 3 + "pp",
                     dev, table.contiguous(), table.shape[1], block_src.contiguous(),
                     block_valid.contiguous(), block_tile.contiguous(), nb, block, ts, tiles_x,
                     int(row0), float(consts[1]), float(consts[2]), float(consts[3]), out, gid,
                     count="surfel_blend_fwd")
    return out, gid


def surfel_blend_bwd(table, block_src, block_valid, block_tile, row0, block, g, s_b, consts):
    """Backward: the cotangents [16, NB, B] of the lanes' columns given
    ``g`` [NB, 10, P2], the cotangent of the forward's out, and its S_b
    ``s_b`` [NB, P2] (out's row 3), which the kernel walks each pixel back
    from."""
    if table.device.type != "cuda":
        return surfel_blend_bwd_plain(table, block_src, block_valid, block_tile, row0, block,
                                      g, consts)
    nb, ts, tiles_x, block = _check_launch(table, block_src, block_valid, block_tile, block,
                                           consts)
    dev = table.device
    p2 = ts * ts
    if g.dtype != torch.float32 or g.shape != (nb, OUT_ROWS, p2) or g.device != dev:
        raise ValueError(f"g must be [{nb}, {OUT_ROWS}, {p2}] float32 on {dev}, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    if s_b.dtype != torch.float32 or s_b.shape != (nb, p2) or s_b.device != dev:
        raise ValueError(f"s_b must be [{nb}, {p2}] float32 on {dev}")
    _, smem = launch_geometry(ts, block, True)
    dcols = torch.empty((COLS, nb, block), dtype=torch.float32, device=dev)
    if nb > 0:
        build.launch("surfel_blend", "gs_surfel_blend_bwd", "pLppppp" + "i" * 5 + "f" * 3 + "p",
                     dev, table.contiguous(), table.shape[1], block_src.contiguous(),
                     block_valid.contiguous(), block_tile.contiguous(), g.contiguous(),
                     s_b.contiguous(), nb, block, ts, tiles_x, int(row0), float(consts[1]),
                     float(consts[2]), float(consts[3]), dcols, count="surfel_blend_bwd")
    return dcols


# -- plain versions: the CPU path and the kernels' oracle


def _window(table, block_src, block_valid, block_tile, row0, block, consts, blocks):
    """The blocks ``blocks`` [K] int64: (live [K, B], cols [17, K, B], px
    [K, P2, 1], py)."""
    ts, tiles_x = int(consts[0]), int(consts[4])
    dev = table.device
    lane = torch.arange(int(block), dtype=torch.int64, device=dev)
    live = lane[None, :] < block_valid[blocks].long()[:, None]
    idx = torch.where(live, block_src[blocks].long()[:, None] + lane, 0)
    cols = table[:TABLE_ROWS, idx]
    t = block_tile[blocks]
    coords = torch.arange(ts, dtype=torch.float32, device=dev) + 0.5
    px = ((t % tiles_x).to(torch.float32) * ts)[:, None] + coords.repeat(ts)[None, :]
    py = ((t // tiles_x + int(row0)).to(torch.float32) * ts)[:, None] + \
        coords.repeat_interleave(ts)[None, :]
    return live, cols, px[:, :, None], py[:, :, None]


def lane_terms(tm, op, px, py, consts):
    """The per-(pixel, lane) terms of the module docstring, in the kernels'
    order of operations: (alpha [K, P2, B] with the cap passing the
    gradient through, 0 where not kept; z, the intersection's depth, 1 where
    not kept).  ``tm`` [9, K, B] (T row-major), ``op`` [K, B] (0 on dead
    lanes), pixel centres px, py [K, P2, 1]; differentiable in tm and op."""
    _, power_floor, alpha_cap, alpha_floor = (float(x) for x in consts[:4])
    t00, t01, t02, t10, t11, t12, t20, t21, t22 = (x[:, None, :] for x in tm)
    hu0, hu1, hu2 = px * t20 - t00, px * t21 - t01, px * t22 - t02
    hv0, hv1, hv2 = py * t20 - t10, py * t21 - t11, py * t22 - t12
    c0 = hu1 * hv2 - hu2 * hv1
    c1 = hu2 * hv0 - hu0 * hv2
    c2 = hu0 * hv1 - hu1 * hv0
    zero = c2 == 0.0
    c2s = torch.where(zero, 1.0, c2)
    u = torch.clamp(c0 / c2s, -_U_MAX, _U_MAX)
    v = torch.clamp(c1 / c2s, -_U_MAX, _U_MAX)
    rho3 = torch.where(zero, torch.inf, u * u + v * v)
    t22s = torch.where(t22 == 0.0, 1.0, t22)
    dx = px - t02 / t22s
    dy = py - t12 / t22s
    rho2 = 2.0 * (dx * dx + dy * dy)
    hit = rho3 <= rho2
    power = -0.5 * torch.where(hit, rho3, rho2)
    a_raw = op[:, None, :] * torch.exp(power)
    mask = (power >= power_floor) & (a_raw >= alpha_floor)
    capped = a_raw + (torch.clamp(a_raw, max=alpha_cap) - a_raw).detach()
    alpha = torch.where(mask, capped, 0.0)
    z = torch.where(mask, torch.where(hit, t20 * u + t21 * v + t22, t22), 1.0)
    return alpha, z


def _blend_chunk(cols, live, px, py, consts):
    """out [K, 10, P2] of a chunk of blocks from its columns [17, K, B]."""
    op = torch.where(live, cols[10], 0.0)
    alpha, z = lane_terms(cols[1:10], op, px, py, consts)
    log1m = torch.log1p(-alpha)
    w = alpha * torch.exp(torch.cumsum(log1m, -1) - log1m)           # [K, P2, B]
    m = depth_map(z)
    per_lane = torch.stack([cols[11], cols[12], cols[13], cols[14], cols[15], cols[16]], 1)
    lin = torch.bmm(w, per_lane.transpose(1, 2))                      # [K, P2, 6]
    sums = torch.stack([(w * z).sum(-1), (w * m).sum(-1), (w * m * m).sum(-1)], -1)
    return torch.stack([lin[..., 0], lin[..., 1], lin[..., 2], log1m.sum(-1), sums[..., 0],
                        lin[..., 3], lin[..., 4], lin[..., 5], sums[..., 1], sums[..., 2]], 1)


def surfel_blend_fwd_plain(table, block_src, block_valid, block_tile, row0, block, consts,
                           chunk_blocks: int = 32):
    """Plain PyTorch version of the forward kernel (the CPU path and the
    kernel's oracle): the terms of ``lane_terms``, T = exp(cumsum(l) - l)
    over the block, then the ten sums.  The blocks with a live lane go in
    chunks of ``chunk_blocks``; the others are zero (gid -1)."""
    nb, ts, _, block = _check_launch(table, block_src, block_valid, block_tile, block, consts)
    dev = table.device
    out = torch.zeros((nb, OUT_ROWS, ts * ts), dtype=torch.float32, device=dev)
    gid = torch.full((nb, block), -1.0, dtype=torch.float32, device=dev)
    busy = torch.nonzero(block_valid > 0).squeeze(1)
    with torch.no_grad():
        for k0 in range(0, busy.numel(), chunk_blocks):
            blocks = busy[k0:k0 + chunk_blocks]
            live, cols, px, py = _window(table, block_src, block_valid, block_tile, row0,
                                         block, consts, blocks)
            out[blocks] = _blend_chunk(cols, live, px, py, consts)
            gid[blocks] = torch.where(live, cols[0], -1.0)
    return out, gid


def surfel_blend_bwd_plain(table, block_src, block_valid, block_tile, row0, block, g, consts,
                           chunk_blocks: int = 32):
    """Plain PyTorch version of the backward kernel: autograd's
    vector-Jacobian product of the forward's chunks with ``g`` [NB, 10, P2]
    in the lanes' sixteen columns, [16, NB, B], zero on dead lanes.  It
    takes T from its own replay of the forward, so it stays an independent
    oracle of the kernel's walk back from s_b."""
    nb, _, _, block = _check_launch(table, block_src, block_valid, block_tile, block, consts)
    out = torch.zeros((COLS, nb, block), dtype=torch.float32, device=table.device)
    busy = torch.nonzero(block_valid > 0).squeeze(1)
    for k0 in range(0, busy.numel(), chunk_blocks):
        blocks = busy[k0:k0 + chunk_blocks]
        live, cols, px, py = _window(table, block_src, block_valid, block_tile, row0, block,
                                     consts, blocks)
        with torch.enable_grad():
            leaf = cols[1:].detach().requires_grad_(True)
            full = torch.cat([cols[:1], leaf])
            (d,) = torch.autograd.grad(_blend_chunk(full, live, px, py, consts), leaf,
                                       g[blocks])
        out[:, blocks] = torch.where(live, d, 0.0)
    return out
