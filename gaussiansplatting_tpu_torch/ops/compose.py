"""Compose: the blend's per-block summaries into the image, and back.  The
CUDA kernels' wrappers and their plain PyTorch versions.

Counterpart of the JAX package's ``_compose_tiles`` (gaussiansplatting_tpu/
ops/rasterize.py:503-551), which XLA compiles: no Pallas kernel.  Alpha
compositing is associative in (colour, transmittance) space, so the blocks
of a tile compose with an exclusive prefix over their S_b.  Contract, for
NB blocks of P2 = ts**2 pixels over T = tiles_x * tiles_y tiles:

  inputs   out [NB, 4, P2] f32, the blend's summaries: rows 0-2 C_b, row 3
           S_b; out_tf, the T-floor pass's (None without the T-floor); seg
           [NB] int32, each block's tile, non-decreasing, T on padding
           blocks; consts = (ts, tiles_x, tiles_y, width, rows, bg): the
           image is [rows, width, 3] of the tile grid's pixels (rows the
           image's height, or a strip's n_rows * ts with its padded rows)
           and bg the background (1 white, 0 black).
  logti    each block's incoming log-transmittance [NB, P2]: the sum of
           out's S_b over the blocks before it in its tile, rounded once to
           float32 from a float64 sum (incoming_log_t).
  forward  the image: sum_b t_in_b C_b + bg exp(S), t_in = exp(logti), C_b
           and S = sum_b S_b from out_tf where given, from out otherwise;
           float32 sums in block order; a tile with no blocks is bg.
  backward g [rows, width, 3], the image's cotangent -> the cotangents of
           out and out_tf [NB, 4, P2]:  dC_b = t_in g,  dS_b (of the pass
           that gives S) = bg exp(S) sum_c g_c,  dS_b (of out, through
           t_in) = sum over the tile's later blocks b' of t_in_b' <g, C_b'>,
           a float64 suffix, exactly 0 where every later term is.  Without
           out_tf, out's row 3 takes both; with it, out's colour rows are 0.

On a CUDA tensor each wrapper launches a kernel of csrc/compose.cu and
counts the launch under its own name in utils/tracing.py's registry; on a
CPU tensor it runs the plain version.  Nothing falls back from one to the
other.  The kernels leave padding blocks' rows of logti and of the
cotangents unwritten (csrc/compose.cu says why no reader needs them); the
plain versions write them (the cotangents as zeros).  Gradients reach the
backward through ops/rasterize._Compose.

Every launch goes to ``torch.cuda.current_stream``, so a train step or a
render captured as a CUDA graph (train/graph.py) records it.
"""

from __future__ import annotations

import torch

from gaussiansplatting_tpu_torch.kernels import build
from gaussiansplatting_tpu_torch.ops import pairs as pairs_mod
from gaussiansplatting_tpu_torch.utils import tracing

tracing.counted("compose_fwd", "compose_logti", "compose_bwd")


def compose_fwd(out, out_tf, seg, consts):
    """The image [rows, width, 3] f32 (see the module docstring)."""
    nb, p2 = _check(out, out_tf, seg, consts)
    if out.device.type == "cuda":
        img = torch.empty((consts[4], consts[3], 3), dtype=torch.float32, device=out.device)
        _launch("gs_compose_fwd", "compose_fwd", consts, nb, (out, out_tf, seg), (img, None))
        return img
    return compose_fwd_plain(out, out_tf, seg, consts)


def compose_logti(out, seg, consts):
    """Each block's incoming log T [NB, P2] f32 from ``out``'s S_b: the
    T-floor pass's input.  On the card the forward kernel in its logti
    mode; padding blocks' rows are left unwritten there."""
    nb, p2 = _check(out, None, seg, consts)
    if out.device.type == "cuda":
        logti = torch.empty((nb, p2), dtype=torch.float32, device=out.device)
        _launch("gs_compose_fwd", "compose_logti", consts, nb, (out, None, seg), (None, logti))
        return logti
    return incoming_log_t(out[:, 3], seg, _num_tiles(consts))


def compose_bwd(g, out, out_tf, seg, consts):
    """(d_out, d_out_tf) [NB, 4, P2] f32 from the image's cotangent ``g``
    [rows, width, 3]; d_out_tf is None without ``out_tf``."""
    nb, p2 = _check(out, out_tf, seg, consts)
    g = g.to(torch.float32).contiguous()
    if g.shape != (consts[4], consts[3], 3) or g.device != out.device:
        raise ValueError(f"g must be [{consts[4]}, {consts[3]}, 3] on {out.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    if out.device.type == "cuda":
        d_out = torch.empty((nb, 4, p2), dtype=torch.float32, device=out.device)
        d_tf = None if out_tf is None else torch.empty_like(d_out)
        _launch("gs_compose_bwd", "compose_bwd", consts, nb, (g, out, out_tf, seg),
                (d_out, d_tf))
        return d_out, d_tf
    return compose_bwd_plain(g, out, out_tf, seg, consts)


def _num_tiles(consts) -> int:
    return int(consts[1]) * int(consts[2])


def _check(out, out_tf, seg, consts):
    """Validate the summaries, the tile ids and the constants; returns (NB,
    P2)."""
    ts, tiles_x, tiles_y, width, rows, _ = consts
    nb, p2 = seg.shape[0], int(ts) ** 2
    for name, t in (("out", out), ("out_tf", out_tf)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (nb, 4, p2)
                              or t.device != seg.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous [{nb}, 4, {p2}] float32 on "
                             f"{seg.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if seg.dtype != torch.int32 or seg.dim() != 1:
        raise ValueError(f"seg must be [NB] int32, got {tuple(seg.shape)} {seg.dtype}")
    if not (0 < rows <= tiles_y * ts and 0 < width <= tiles_x * ts and p2 <= 1024):
        raise ValueError(f"compose constants {tuple(consts)}: the image must lie in the tile "
                         f"grid, tile_size**2 <= 1024")
    return nb, p2


def _launch(symbol, name, consts, nb, inputs, outputs):
    """One launch of ``symbol`` (csrc/compose.cu: the pointers in, six ints,
    the background, the pointers out) on the current stream, counted under
    the wrapper ``name``; None pointers pass as null."""
    ts, tiles_x, tiles_y, width, rows, bg = consts
    ints = (nb, int(ts), int(tiles_x), int(tiles_x) * int(tiles_y), int(width), int(rows))
    build.launch("compose", symbol, "p" * len(inputs) + "iiiiiif" + "p" * len(outputs),
                 inputs[-1].device, *inputs, *ints, float(bg), *outputs, count=name)


# -- plain versions: the CPU path and the kernels' oracle


def _tile_bounds(seg, num_tiles):
    """[T + 2] start of each tile's run of blocks in ``seg`` (sorted)."""
    q = torch.arange(num_tiles + 2, dtype=seg.dtype, device=seg.device)
    return torch.searchsorted(seg, q, right=False)


def _transposed64(x: torch.Tensor) -> torch.Tensor:
    """[NB, P2] -> contiguous float64 [P2, NB], so the scans run along the
    innermost dimension (pairs._prefix_sum)."""
    return x.t().to(torch.float64, memory_format=torch.contiguous_format)


def tile_suffix(x: torch.Tensor, seg: torch.Tensor, num_tiles: int) -> torch.Tensor:
    """Each block's exclusive suffix sum of x [NB, P2] over the later blocks
    of its own tile, taken in float64 and rounded once to x's dtype; exactly
    0 where every later block's x is 0 (a count of nonzeros,
    pairs.nonzero_prefix, zeroes the difference of the two prefixes).  The
    transpose of incoming_log_t: its vector-Jacobian product in ``x``,
    where the JAX package's float32 global form leaves the other tiles'
    cancellation residue behind a zero tail."""
    bounds = _tile_bounds(seg, num_tiles)
    last = bounds[torch.clamp(seg, max=num_tiles).long() + 1] - 1   # the tile's last block
    incl = pairs_mod._prefix_sum(_transposed64(x))                  # [P2, NB]
    nz = pairs_mod.nonzero_prefix(x.t())[:, 1:]
    d = torch.where(nz[:, last] == nz, 0.0, incl[:, last] - incl)
    return d.t().to(x.dtype, memory_format=torch.contiguous_format)


def incoming_log_t(s_b: torch.Tensor, seg: torch.Tensor, num_tiles: int):
    """Each block's incoming log-transmittance [NB, P2] from the blocks'
    S_b [NB, P2] and their tile ids ``seg`` [NB] (non-decreasing; padding
    blocks carry num_tiles): the sum of S_b over the blocks before it in
    its tile.  Returns ``s_b``'s dtype, outside autograd.  The plain
    version of compose_logti, and of the kernels' t_in; its transpose, the
    backward's suffix over the tile's later blocks, is tile_suffix.

    The prefix runs in float64 over the transposed [P2, NB] layout and is
    rounded once, so logti is within a rounding of the exact per-tile sum.
    The JAX package (rasterize.py:509-518) takes a float32 cumsum over all
    blocks of the frame and subtracts its value at the tile's first block:
    at 18,284 blocks that difference of two large sums is up to ~1e-2 off,
    enough to move a pixel's termination under the T-floor.  The scan is
    fixed-order, so a replay gives the same bits."""
    with torch.no_grad():
        bounds = _tile_bounds(seg, num_tiles)
        tile = torch.clamp(seg, max=num_tiles).long()
        incl = pairs_mod._prefix_sum(_transposed64(s_b))        # [P2, NB]
        excl = torch.nn.functional.pad(incl[:, :-1], (1, 0))
        out = excl - excl[:, bounds[tile]]                      # minus the tile's first
        return out.t().to(s_b.dtype, memory_format=torch.contiguous_format)


def _tile_sums(x, seg, num_tiles):
    """Per-tile sums [T, ...] of x [NB, ...] over each tile's blocks, each
    summed sequentially in block order (torch.segment_reduce; ``unsafe``:
    its checks read the offsets back to the host, and the bounds are sorted
    and span every block by construction)."""
    bounds = _tile_bounds(seg, num_tiles)
    return torch.segment_reduce(x, "sum", offsets=bounds, axis=0, unsafe=True)[:num_tiles]


def _image(tile_img, consts):
    """[T, K, P2] per-tile pixels of K channels -> the image [rows, width,
    K]."""
    ts, tiles_x, tiles_y, width, rows, _ = consts
    k = tile_img.shape[1]
    img = tile_img.reshape(tiles_y, tiles_x, k, ts, ts).permute(0, 3, 1, 4, 2)
    return img.reshape(tiles_y * ts, tiles_x * ts, k)[:rows, :width]


def _tiles(g, consts):
    """The inverse of _image: [rows, width, K] -> [T, K, P2], zero on the
    pixels the image crops."""
    ts, tiles_x, tiles_y, width, rows, _ = consts
    k = g.shape[-1]
    full = torch.nn.functional.pad(g, (0, 0, 0, tiles_x * ts - width, 0, tiles_y * ts - rows))
    full = full.reshape(tiles_y, ts, tiles_x, ts, k).permute(0, 2, 4, 1, 3)
    return full.reshape(tiles_x * tiles_y, k, ts * ts)


def compose_fwd_plain(out, out_tf, seg, consts):
    """Plain PyTorch version of the forward kernel (the CPU path and the
    kernel's oracle): incoming_log_t, then the per-tile sums of t_in C_b and
    S_b, each in block order.  Any float dtype."""
    nt, nb, bg = _num_tiles(consts), seg.shape[0], consts[5]
    t_in = torch.exp(incoming_log_t(out[:, 3], seg, nt))
    src = out if out_tf is None else out_tf
    contrib = (t_in[:, None, :] * src[:, :3]).reshape(nb, -1)
    tile_color = _tile_sums(contrib, seg, nt).reshape(nt, 3, -1)
    tile_s = _tile_sums(src[:, 3], seg, nt)
    return _image(tile_color + torch.exp(tile_s)[:, None, :] * bg, consts)


def compose_bwd_plain(g, out, out_tf, seg, consts):
    """Plain PyTorch version of the backward kernel, the chain rule written
    out per tile (see the module docstring): dC_b = t_in g, the float64
    suffix of t_in <g, C_b> over the tile's later blocks (tile_suffix), and
    bg exp(S) sum_c g_c.  Padding blocks get zeros.  Any float dtype."""
    nt, bg = _num_tiles(consts), consts[5]
    t_in = torch.exp(incoming_log_t(out[:, 3], seg, nt))
    src = out if out_tf is None else out_tf
    live = (seg < nt)[:, None, None]
    tile = torch.clamp(seg, max=nt - 1).long()
    g_tiles = _tiles(g.to(out.dtype), consts)                        # [T, 3, P2]
    g_b = torch.where(live, g_tiles[tile], 0.0)                     # [NB, 3, P2]
    d_c = t_in[:, None, :] * g_b
    d_s1 = tile_suffix((g_b * src[:, :3]).sum(1) * t_in, seg, nt)
    d_s = (g_tiles * bg).sum(1) * torch.exp(_tile_sums(src[:, 3], seg, nt))
    d_s2 = torch.where(live[:, 0], d_s[tile], 0.0)
    if out_tf is None:
        return torch.cat([d_c, (d_s1 + d_s2)[:, None]], dim=1), None
    return (torch.cat([torch.zeros_like(d_c), d_s1[:, None]], dim=1),
            torch.cat([d_c, d_s2[:, None]], dim=1))
