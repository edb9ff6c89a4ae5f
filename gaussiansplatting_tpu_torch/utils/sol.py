"""Speed-of-light model of the port on one NVIDIA H100: the least time the
card could take for a blend kernel's work or for one train step.

Counterpart of gaussiansplatting_tpu/utils/sol.py (the v5e model), with the
H100's rates and the port's dataflow:

  * ``blend_work`` counts what the blend's inputs need, from the plain
    replay of the kernels' math (ops.blend._replay): the lanes read, the
    power tests on (warp, lane) pairs the per-warp box cull keeps, the kept
    pairs; ``work_bound`` turns a kernel's counts and bytes into its bound.
  * ``step_model`` counts the single-touch bytes of one fwd+bwd+Adam step at
    its static shapes (every array each stage must read or write at least
    once) and its f32 instructions, and returns the larger of the two times
    as ``floor_ms``: a step faster than that is impossible on the card for
    this dataflow.

The rates: an H100 SXM's HBM rate and its f32 instruction rate outside the
tensor cores (NVIDIA's data sheet, at 700 W: its 67 TFLOP/s counts an FMA as
two operations, so 33.5e12 instructions per second, 128 per SM per clock).
The instructions the blend needs, each separately rounded multiply, add,
compare or FMA counted once: per (pixel, lane) power test 7 multiplies, 1
add, 1 subtraction and the 2 window compares (11; dx and dy are shared along
a column and a row); per kept pair in the forward op * exp, the floor
compare, the cap, w = alpha T, 3 colour FMAs, T *= 1 - alpha and S += log1p
(12); in the backward op * exp, the floor compare, the cap, 1 - alpha and its
reciprocal, T, w, e (3), dl, dpow (3), dpow dx and dpow dy, the nine sums and
the suffix (27).  The bf16 payload mode's packed kernels: in the forward
op * exp, the floor compare, the cap, log1p, Q += bf16(l), Q - l, exp for T,
w, 3 colour FMAs and S += l (13); in the backward op * exp, the floor
compare, the cap, log1p, Q - l, exp for T, Q -= bf16(l), 1 - alpha, the
division, w, e (3), dl, dpow (3), dpow dx and dpow dy, the nine sums, e w
and the suffix (31); the bf16 roundings are integer operations and count
nothing.  exp, log1p and the reciprocal count as one each, though each
takes several, so the bound stays a lower bound.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_INSTR_PER_S = 67e12 / 2
OPS_PER_TEST = 11
FWD_OPS_PER_KEPT = 12
BWD_OPS_PER_KEPT = 27
FWD_PACKED_OPS_PER_KEPT = 13
BWD_PACKED_OPS_PER_KEPT = 31

F32 = I32 = 4
F64 = 8


def cull_extent(ca, cb, cc, op, power_floor, alpha_floor):
    """Half-extents (ex, ey) of each lane's padded ellipse box, as
    blend_common.cuh's cull_extent computes them: -inf where no pixel can
    keep the lane, +inf where the conic is too near singular to cull."""
    import torch

    inf = torch.full_like(op, float("inf"))
    thr = torch.fmax(torch.log(alpha_floor / op), torch.full_like(op, power_floor))
    thr = thr - (1e-3 + 1e-4 * thr.abs())
    det = ca * cc - cb * cb
    regular = (ca > 0) & (cc > 0) & (det > 0.1 * ca * cc)
    r = -2.0 * thr
    never = (op == 0) | (thr >= 0)
    ex = torch.where(regular, torch.sqrt(r * cc / det) * 1.001 + 0.01, inf)
    ey = torch.where(regular, torch.sqrt(r * ca / det) * 1.001 + 0.01, inf)
    return torch.where(never, -inf, ex), torch.where(never, -inf, ey)


def blend_work(args, logti=None, log_thr=0.0, chunk=128):
    """What the blend's inputs need at ts = 16, counted from the plain
    replay (ops.blend._replay) on the inputs' device in chunks of blocks,
    for the Hopper designs' layouts (``fwd`` and ``bwd``: column strips of P
    pixels per thread, P from ops.blend.launch_geometry, of the T-floor
    instances with logti; a warp covers 16 x 2P pixels).

    ``args`` are ops.blend.windowed_blend_fwd's positional arguments.
    Returns the lanes each reads (``live_fwd``, ``live_bwd``); the kept
    pairs (with logti, those that survive the T-floor); per layout the
    (warp, lane) pairs on lanes with opacity (``pairs_*``), those whose
    padded box misses the warp's rectangle (``culled_*``), and on the rest
    the power tests the pixels need (``tests_*``).  Without logti a pixel
    tests every live lane.  With logti (the T-floor pass) the forward reads
    the lanes of blocks with a pixel above the floor and a pixel tests the
    lanes up to its first kept lane that fails (all, if none does; none if
    it arrives at or below the floor); the backward reads the lanes before
    the block's largest stop lane and a pixel tests the lanes before its
    own.  The backward's output depends on a pixel's cotangent and S_b only
    where the pixel keeps a lane (with logti: a surviving one, stop > 0),
    ``bwd_pixels``; ``bwd_blocks`` counts the blocks whose lanes it reads (a
    live lane; with logti, a stop > 0).  Without logti, also the (warp,
    batch of 4 lanes) exchanges of the backward.  Raises if a kept pair
    lies in a culled (warp, lane) pair."""
    import torch
    import torch.nn.functional as F

    from gaussiansplatting_tpu_torch.ops import blend

    table, src, valid, tile, row0, block, consts = args
    ts, power_floor, _, alpha_floor, tiles_x = consts[:5]
    nb, p2 = src.shape[0], int(ts) ** 2
    if p2 != 256:
        raise ValueError(f"blend_work counts 16 x 16 tiles, got tile_size {ts}")
    layouts = {d: p2 // blend.launch_geometry(ts, block, d == "bwd", tfloor=logti is not None)[0]
               for d in ("fwd", "bwd")}
    w = dict.fromkeys(("live_fwd", "live_bwd", "bwd_blocks", "bwd_pixels", "kept", "exchanges",
                       "batches") + tuple(f"{c}_{d}" for c in ("pairs", "culled", "tests")
                                          for d in layouts), 0)
    w["pixels"] = layouts
    for k0 in range(0, nb, chunk):
        k1 = min(k0 + chunk, nb)
        r = blend._replay(table, src, valid, tile, row0, block, consts, k0, k1)
        kept = r.alpha > 0                                          # [K, P2, B]
        k, b = kept.shape[0], kept.shape[2]
        lane = torch.arange(b, device=kept.device)
        nv = r.live.sum(1)                                          # [K]
        if logti is None:
            surv = kept
            need = {d: nv[:, None].expand(k, p2) for d in layouts}   # [K, P2]
            w["live_fwd"] += int(nv.sum())
            w["live_bwd"] += int(nv.sum())
            w["bwd_blocks"] += int((nv > 0).sum())
            w["bwd_pixels"] += int(kept.any(-1).sum())
        else:
            arrive = torch.cumsum(r.log1m, -1) - r.log1m + logti[k0:k1, :, None]
            surv = kept & (arrive > log_thr)
            fail = torch.where(kept & ~surv, lane, b).amin(-1)       # [K, P2]
            open_px = logti[k0:k1] > log_thr
            stop = torch.where(surv, lane + 1, 0).amax(-1)
            need = {"fwd": torch.where(open_px, torch.minimum(fail + 1, nv[:, None]), 0),
                    "bwd": stop}
            w["live_fwd"] += int((nv * open_px.any(1)).sum())
            w["live_bwd"] += int(stop.amax(1).sum())
            w["bwd_blocks"] += int((stop.amax(1) > 0).sum())
            w["bwd_pixels"] += int((stop > 0).sum())
        w["kept"] += int(surv.sum())
        mx, my = r.mx, r.my                                         # [K, B]
        ex, ey = cull_extent(r.cols[3], r.cols[4], r.cols[5], r.op, power_floor, alpha_floor)
        has_op = (r.op > 0)[:, None, :]                              # [K, 1, B]
        for name, pixels in layouts.items():
            rows = 2 * pixels                  # a warp: 16 columns x rows
            warps = 16 // rows
            cy = (torch.arange(warps, device=kept.device) * rows
                  + (rows - 1) / 2.0 + 0.5 - 8.0)[None, :, None]   # [1, W, 1]
            meets = (((0.0 - mx).abs() <= 7.5 + ex)[:, None, :]
                     & ((cy - my[:, None, :]).abs() <= (rows - 1) / 2.0 + ey[:, None, :]))
            if bool((kept.reshape(k, warps, -1, b).any(2) & ~meets).any()):
                raise AssertionError(f"blend_work ({name}): a kept pair lies outside "
                                     f"its lane's padded box")
            tested = has_op & meets                                 # [K, W, B]
            w[f"pairs_{name}"] += int(has_op.sum()) * warps
            w[f"culled_{name}"] += int((has_op & ~meets).sum())
            testers = (lane < need[name][:, :, None]).reshape(k, warps, -1, b).sum(2)
            w[f"tests_{name}"] += int((tested * testers).sum())
        if logti is None:
            warps = p2 // (32 * layouts["bwd"])
            parts = F.pad(kept.reshape(k, warps, -1, b).any(2), (0, -b % 4))
            w["exchanges"] += int(parts.reshape(k, warps, -1, 4).any(3).sum())
            w["batches"] += warps * int(((nv + 3) // 4).sum())
    return w


def bound(nbytes, ops):
    """(bound ms, what sets it): the larger of the bytes over the H100's HBM
    rate and the instructions over its f32 instruction rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_INSTR_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def work_bound(w, layout, nbytes, ops_per_kept):
    """A kernel's bound from blend_work's counts for its layout: the
    kernels-line fields (bound_ms, bound_by, power_tests, kept_pairs,
    culled_share) and a log line of the work."""
    tests, kept = w[f"tests_{layout}"], w["kept"]
    ops = OPS_PER_TEST * tests + ops_per_kept * kept
    bound_ms, bound_by = bound(nbytes, ops)
    res = {"bound_ms": bound_ms, "bound_by": bound_by, "power_tests": tests,
           "kept_pairs": kept, "culled_share": w[f"culled_{layout}"] / w[f"pairs_{layout}"]}
    line = (f"{w[f'live_{layout}']} lanes read; the box cull skips {w[f'culled_{layout}']} of "
            f"{w[f'pairs_{layout}']} (warp, lane) pairs ({res['culled_share']:.4f}); "
            f"{tests} power tests, {kept} kept pairs ({kept / max(tests, 1):.4f} of the "
            f"tests); {nbytes} bytes, {ops} instructions: bound {bound_ms:.4f} ms "
            f"({bound_by})")
    return res, line


def step_model(
    n: int,
    pair_capacity: int,
    height: int,
    width: int,
    tile_size: int = 16,
    block: int = 128,
    chunk_slack: float = 1.0,
    work: dict | None = None,
    packed: bool = False,
    pack_positions: bool = False,
) -> dict:
    """Single-touch bytes and f32 instructions of one fwd+bwd+Adam step of
    the default path at the given STATIC shapes.

    ``packed`` (the bf16 payload mode) and ``pack_positions``, as in the
    JAX model (utils/sol.py:45-70): the table has 8 rows (16 unpacked), a
    window lane reads 7 of them (6 with pack_positions; 10 unpacked), the
    forward writes and the backward reads each pixel's q_b in place of S_b,
    and the backward writes 5 packed cotangent rows (9 unpacked), which the
    reduction gathers and then unpacks to 9.

    ``work`` (blend_work of the frame's windows) gives the blend kernels'
    instructions; without it they count 0, and the floor stays a lower
    bound.  Returns the JAX model's keys with ``mxu_flops`` replaced by
    ``instructions``: bytes_by_stage, bytes_total, instructions, t_bytes_ms,
    t_flops_ms (the instructions over the f32 instruction rate) and
    floor_ms, the larger of the two times."""
    from gaussiansplatting_tpu_torch.ops import pairs as pairs_mod

    tiles_x = -(-width // tile_size)
    tiles_y = -(-height // tile_size)
    tiles = tiles_x * tiles_y
    p2 = tile_size * tile_size
    chunk_cap = pairs_mod._chunk_capacity(pair_capacity, n, chunk_slack)
    e_cap = chunk_cap * pairs_mod.PAIR_CHUNK
    a_cap = pairs_mod.aligned_capacity(pair_capacity, tiles, block)
    nb = a_cap // block
    ep = -(-(e_cap + 2 * block) // 512) * 512
    pack_positions = packed and pack_positions
    rows = pairs_mod.PACKED_TABLE_ROWS if packed else pairs_mod.TABLE_ROWS
    lane_rows = (6 if pack_positions else 7) if packed else 10   # rows a lane reads
    n_out = 5 if packed else 9           # backward cotangent rows
    d_full = 9                           # cotangent columns
    npix = height * width

    b = {}
    # -- stages the port shares with the JAX package: its formulas
    # per-frame depth presort of the Gaussians (key + permutation index)
    b["presort"] = 2 * 2 * n * F32
    # compose tiles -> image, L1 + D-SSIM (~12 image touches)
    b["image_loss"] = nb * 4 * p2 * F32 + 12 * npix * 3 * F32
    # projection fwd+bwd (~40 f32 fields per Gaussian each way)
    b["projection"] = 2 * 40 * n * F32
    # Adam: 23 trainable floats per Gaussian; read p/m/v/g, write p/m/v
    b["optimizer"] = 7 * 23 * n * F32

    # -- stages the port does its own way
    # the presorted rows ride one gather of [N, 15] f32 (depth, tile rect,
    # tile count, 9 render values; rasterize._PermuteRows), and its
    # cotangent one gather back
    b["presort_rows"] = 2 * 2 * 15 * n * F32
    # expansion: each chunk slot looks up its Gaussian and reads its six int
    # fields, each lane writes a tile key and a gid (no data rows: torch.sort
    # carries no payload, where the JAX expansion writes them for its fat sort)
    b["expand"] = n * 6 * I32 + chunk_cap * 6 * I32 + e_cap * 2 * I32
    # ONE int32 key sort with its permutation (JAX: the fat sort of key,
    # gid and the data rows)
    b["tile_sort"] = 2 * e_cap * 2 * I32
    # the table: the render data read once, gid and the data gathered by
    # the permutation into the zeroed [16, EP] table
    b["table"] = n * 9 * F32 + e_cap * I32 + rows * ep * F32
    # per-block windows: src, valid and tile from the tile runs (JAX: the
    # aligned destination sort, not ported)
    b["windows"] = nb * 3 * I32 + tiles * 4 * I32
    # blend forward: each block reads its own window of lane_rows rows once
    # (JAX: a 2x over-fetched DMA), out [NB, 4, P2] and gid [NB, B] written
    # (packed: q_b [NB, P2] too)
    b["blend_fwd"] = (nb * block * lane_rows * F32 + nb * 3 * I32
                      + nb * (4 * p2 + block) * F32 + (nb * p2 * F32 if packed else 0))
    # blend backward: the window again, g [NB, 4, P2] and the forward's S_b
    # (packed: q_b) in (no replay), n_out columns out
    b["blend_bwd"] = (nb * block * lane_rows * F32 + nb * 3 * I32 + nb * 5 * p2 * F32
                      + nb * n_out * block * F32)
    # compose's backward (csrc/compose.cu: the incoming log T recomputed
    # per tile): out read again, its cotangent [NB, 4, P2] written (JAX:
    # inside image_loss)
    b["compose_bwd"] = 2 * nb * 4 * p2 * F32
    # per-Gaussian sums: a stable int32 key sort with its permutation, the
    # n_out rows gathered (packed: then unpacked to nine), their float64
    # prefix and the int32 count of nonzero lanes, the run ends read,
    # [N, 9] out
    b["grad_reduce"] = (2 * a_cap * 2 * I32 + 2 * a_cap * n_out * F32
                        + (a_cap * d_full * F32 if packed else 0)
                        + 2 * a_cap * d_full * F64 + 2 * a_cap * I32
                        + 2 * n * d_full * F64 + n * d_full * F32)

    bytes_total = float(sum(b.values()))

    # f32 instructions: the D-SSIM blurs (4 blurs x 2 separable passes x 11
    # taps, one FMA each, per pixel and channel; TF32 is off) and, from
    # ``work``, the blend kernels' power tests and kept pairs
    instructions = 4 * 2 * 11 * npix * 3
    if work is not None:
        instructions += (OPS_PER_TEST * (work["tests_fwd"] + work["tests_bwd"])
                         + (FWD_OPS_PER_KEPT + BWD_OPS_PER_KEPT) * work["kept"])
    t_bytes_ms = bytes_total / HBM_BYTES_PER_S * 1e3
    t_flops_ms = instructions / F32_INSTR_PER_S * 1e3
    return {
        "bytes_by_stage": b,
        "bytes_total": bytes_total,
        "instructions": float(instructions),
        "t_bytes_ms": t_bytes_ms,
        "t_flops_ms": t_flops_ms,
        "floor_ms": max(t_bytes_ms, t_flops_ms),
    }
