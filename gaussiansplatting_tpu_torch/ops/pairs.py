"""(tile, depth) pair expansion, the tile sort and per-block source windows.

Counterpart of the WINDOWED half of gaussiansplatting_tpu/ops/pairs.py: the
capacity plan, the two-tier chunked expansion, ONE stable single-key tile
sort (Gaussians arrive depth-presorted, so a stable sort by tile leaves every
tile's run depth-sorted) and the per-aligned-block source windows the blend
reads; and, for the backward, the reduction of aligned-order cotangents to
per-Gaussian sums (sort-prefix or scatter).  Every integer output matches
the JAX package exactly, and so does the table, packed or not.

Sort: ``lax.sort`` carries payload operands; ``torch.sort`` does not, so the
int32 tile keys are sorted once (stable) and the payload is gathered by the
returned permutation.  Public integer outputs are int32; indices are cast to
int64 only where they index.  Slots to runs (chunk slot -> Gaussian, aligned
block -> tile) go through ops/runs.py: a CUDA kernel pair on the card.

Overflow beyond ``pair_capacity`` drops whole Gaussians: in emission order
(the "index" policy) or the least visible first ("impact").

With the bf16 payload mode (``payload_dtype="bf16"``) the table carries
conic, opacity and colour as bf16 pairs (ops/packing.py) in 8 rows instead
of 16, and with ``pack_positions`` the tile-relative positions too; the
backward's cotangents arrive as five packed rows and are unpacked after
the gather by Gaussian id.
"""

from __future__ import annotations

import torch

from gaussiansplatting_tpu_torch.ops import packing, runs
from gaussiansplatting_tpu_torch.ops.projection import Projected

# pairs per expansion chunk: the per-Gaussian metadata/render-data gather
# runs once per chunk, then broadcasts to the chunk's lanes
PAIR_CHUNK = 8

_I32 = torch.int32


def _chunk_capacity(pair_capacity: int, n: int, slack: float = 1.0) -> int:
    """Static chunk-slot capacity: enough chunks for pair_capacity packed
    pairs plus per-Gaussian padding waste (< PAIR_CHUNK-1 each for up to n
    live Gaussians), scaled by ``slack``."""
    base = -(-pair_capacity // PAIR_CHUNK)
    return base + int(min(n, base) * slack)


def _cumsum32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum (torch promotes integer cumsum to int64)."""
    return torch.cumsum(x, 0).to(_I32)


def aligned_capacity(pair_capacity: int, num_tiles: int, block: int) -> int:
    """Static capacity of the block-aligned layout: every tile can waste at
    most block-1 slots of padding."""
    return pair_capacity + num_tiles * block


def capacity_plan(proj: Projected, tiles_x: int, tiles_y: int, pair_capacity: int,
                  row0: int = 0, overflow_drop: str = "index",
                  chunk_slack: float = 1.0):
    """Per-Gaussian pair/chunk counts with the capacity drop applied.

    ``overflow_drop`` picks which Gaussians lose all their pairs when the
    frame exceeds a capacity: "index", those whose run would cross the end
    of either the real-pair or the chunk-slot capacity in emission order;
    "impact", all but the prefix of the Gaussians ranked by opacity x pair
    count (stable, descending) that fits both capacities, so that a capped
    capacity sheds the least visible content (pairs.py:160-169).  Nothing
    is dropped when everything fits.

    Returns (counts, ccounts, coffsets, ty_lo, span_x, total, overflow); all
    int32 [N] except total (0-dim int32) and overflow (0-dim bool)."""
    if overflow_drop not in ("index", "impact"):
        raise ValueError(f"overflow_drop must be 'index' or 'impact', got {overflow_drop!r}")
    n = proj.depth.shape[0]
    chunk_cap = _chunk_capacity(pair_capacity, n, chunk_slack)
    ty_lo = torch.clamp(proj.tile_min[:, 1], min=row0)
    ty_hi = torch.clamp(proj.tile_max[:, 1], max=row0 + tiles_y - 1)
    span_y = torch.clamp(ty_hi - ty_lo + 1, min=0)
    span_x = proj.tile_max[:, 0] - proj.tile_min[:, 0] + 1
    counts = torch.where(proj.n_tiles > 0, span_x * span_y, 0).to(_I32)
    ccounts = -(-counts // PAIR_CHUNK)
    cum = _cumsum32(counts)
    offsets = cum - counts
    ccum = _cumsum32(ccounts)
    coffsets = ccum - ccounts
    zero = torch.zeros((), dtype=_I32, device=counts.device)
    total = cum[-1] if n > 0 else zero
    ctotal = ccum[-1] if n > 0 else zero

    if overflow_drop == "impact":
        impact = torch.where(counts > 0, proj.opacity.detach() * counts, -1.0)
        order = torch.argsort(-impact, stable=True)
        fits_o = ((torch.cumsum(counts[order], 0) <= pair_capacity)
                  & (torch.cumsum(ccounts[order], 0) <= chunk_cap))
        fits = torch.empty_like(fits_o)
        fits[order] = fits_o
    else:
        fits = ((offsets + counts) <= pair_capacity) & ((coffsets + ccounts) <= chunk_cap)
    counts = torch.where(fits, counts, 0)
    ccounts = torch.where(fits, ccounts, 0)
    overflow = (total > pair_capacity) | (ctotal > chunk_cap)
    cum = _cumsum32(counts)
    coffsets = _cumsum32(ccounts) - ccounts
    total = torch.clamp(cum[-1], max=pair_capacity) if n > 0 else zero
    return counts, ccounts, coffsets, ty_lo, span_x, total, overflow


def _expand_and_sort1(data, row0, counts, ccounts, coffsets, ty_lo, tmin_x,
                      span_x, cfg):
    """Two-tier expansion + the stable tile sort (depth-presorted input).
    Chunk slot -> Gaussian is a run-id lookup, chunk -> PAIR_CHUNK lanes a
    broadcast.

    Returns (sorted_tile [E] int32, sorted_gid [E] int32, sorted_data
    [E, D] f32, e_cap)."""
    n, _p_cap, tiles_x, tiles_y, _block, chunk_cap = cfg[:6]
    dev = data.device
    num_tiles = tiles_x * tiles_y
    e_cap = chunk_cap * PAIR_CHUNK

    cslots = torch.arange(chunk_cap, dtype=_I32, device=dev)
    if n > 0:
        ctotal = torch.clamp(coffsets[-1] + ccounts[-1], max=chunk_cap)
    else:
        ctotal = torch.zeros((), dtype=_I32, device=dev)
    cgid = torch.clamp(runs.run_ids(coffsets, ccounts > 0, chunk_cap), 0, max(n - 1, 0))
    cvalid = cslots < ctotal

    cg = cgid.long()
    crank = cslots - coffsets[cg]
    c_count = counts[cg]
    c_span = torch.clamp(span_x[cg], min=1)
    c_ty = ty_lo[cg]
    c_tx = tmin_x[cg]

    def bcast(x):  # [chunk_cap] -> [e_cap] chunk-to-lane broadcast
        return x[:, None].expand(chunk_cap, PAIR_CHUNK).reshape(-1)

    lane = torch.arange(PAIR_CHUNK, dtype=_I32, device=dev).repeat(chunk_cap)
    rank = bcast(crank * PAIR_CHUNK) + lane
    span_p = bcast(c_span)
    slot_valid = bcast(cvalid) & (rank < bcast(c_count))
    ty = bcast(c_ty) + rank // span_p
    tx = bcast(c_tx) + rank % span_p
    tile_id = torch.where(slot_valid, (ty - row0) * tiles_x + tx, num_tiles).to(_I32)
    gid_v = torch.where(slot_valid, bcast(cgid), -1).to(_I32)

    sorted_tile, perm = torch.sort(tile_id, stable=True)
    sorted_gid = gid_v[perm]
    # payload rides by the permutation: lane e belongs to chunk e // PAIR_CHUNK
    sorted_data = data[cgid.long()[perm // PAIR_CHUNK]]
    if len(cfg) > 6 and cfg[6] and cfg[7]:
        # pack_positions: positions relative to the pair's tile centre (its
        # absolute tile row), every lane as JAX computes it (pairs.py:318-334)
        ts, half = float(cfg[8]), float(cfg[8]) / 2.0
        centre = torch.stack([tx[perm].to(torch.float32) * ts + half,
                              ty[perm].to(torch.float32) * ts + half], dim=1)
        sorted_data = torch.cat([sorted_data[:, :2] - centre, sorted_data[:, 2:]], dim=1)
    return sorted_tile, sorted_gid, sorted_data, e_cap


def _tile_runs(sorted_tile, num_tiles: int, block: int):
    """Per-tile run starts/counts and their block-aligned layout."""
    q = torch.arange(num_tiles + 1, dtype=_I32, device=sorted_tile.device)
    starts_all = torch.searchsorted(sorted_tile, q, right=False).to(_I32)
    tile_starts = starts_all[:num_tiles]
    tile_counts = starts_all[1:] - tile_starts
    aligned_counts = -(-tile_counts // block) * block
    aligned_cum = _cumsum32(aligned_counts)
    aligned_starts = aligned_cum - aligned_counts
    aligned_total = aligned_cum[-1]
    return tile_starts, tile_counts, aligned_counts, aligned_starts, aligned_total


def _block_tiles(aligned_starts, aligned_counts, aligned_total, num_tiles: int,
                 block: int, num_blocks: int):
    """Tile id of each aligned block (blocks never straddle tiles; blocks
    past aligned_total get num_tiles)."""
    dev = aligned_starts.device
    block_starts = torch.arange(num_blocks, dtype=_I32, device=dev) * block
    bt = runs.run_ids(aligned_starts // block, aligned_counts > 0, num_blocks)
    return torch.where(
        block_starts < aligned_total, torch.clamp(bt, 0, num_tiles - 1), num_tiles
    ).to(_I32)


TABLE_ROWS = 16
PACKED_TABLE_ROWS = 8


def _packed_payload(sorted_data, pack_pos):
    """The packed table's data rows [E, R] from the sorted pairs' [E, 9]
    render data: sx, sy, then bf16 pairs (ca, cb), (cc, op), (r, g),
    (b, 0); with ``pack_pos`` the first two columns are the tile-relative
    (mx, my) of _expand_and_sort1 and ride as one pair."""
    cols = packing.pack_cols([sorted_data[:, j] for j in range(2, sorted_data.shape[1])])
    pos = ([packing.pack2(sorted_data[:, 0], sorted_data[:, 1])] if pack_pos
           else [sorted_data[:, 0], sorted_data[:, 1]])
    return torch.stack(pos + cols, dim=1)


def pair_windows_fwd(data, row0, counts, ccounts, coffsets, ty_lo, tmin_x,
                     span_x, cfg):
    """Expansion + the tile sort, then per-aligned-block source windows:
    aligned block b of tile t reads the contiguous sorted-order window
    [block_src[b], block_src[b] + block) with its first block_valid[b]
    lanes live.

    ``data`` is the depth-presorted [N, D] f32 render data (D = 9, or 16 for
    surfels; 9 when packed); ``cfg`` = (n, pair_capacity, tiles_x, tiles_y, block,
    chunk_cap), optionally followed by (packed, pack_pos, tile_size), the
    JAX pcfg's packing flags (pcfg[8:11]).

    Returns (table [R, EP] f32, block_src, block_valid, block_tile [NB]
    int32, aligned_total 0-dim int32).  Table rows are [gid, data0..D-1,
    zeros...], R = max(16, D + 1); packed, R = 8 and the rows are gid, sx, sy, (ca,
    cb), (cc, op), (r, g), (b, 0), with pack_pos gid, (mx, my), (ca, cb),
    (cc, op), (r, g), (b, 0) (bf16 pairs, ops/packing.py).  EP pads e_cap +
    2*block up to a multiple of 512 as the JAX table does, so the tables
    compare equal, bit for bit."""
    n, p_cap, tiles_x, tiles_y, block, _chunk_cap = cfg[:6]
    packed = len(cfg) > 6 and bool(cfg[6])
    pack_pos = packed and bool(cfg[7])
    dev = data.device
    num_tiles = tiles_x * tiles_y
    num_blocks = aligned_capacity(p_cap, num_tiles, block) // block

    sorted_tile, sorted_gid, sorted_data, e_cap = _expand_and_sort1(
        data, row0, counts, ccounts, coffsets, ty_lo, tmin_x, span_x, cfg
    )
    if packed:
        sorted_data = _packed_payload(sorted_data, pack_pos)
    d = sorted_data.shape[-1]
    (tile_starts, tile_counts, aligned_counts, aligned_starts,
     aligned_total) = _tile_runs(sorted_tile, num_tiles, block)
    block_tile = _block_tiles(
        aligned_starts, aligned_counts, aligned_total, num_tiles, block, num_blocks
    )

    ep = -(-(e_cap + 2 * block) // 512) * 512
    # a surfel's 16 data columns (ops/surfel_projection.py) take 17 rows
    rows = PACKED_TABLE_ROWS if packed else max(TABLE_ROWS, 1 + d)
    table = torch.zeros((rows, ep), dtype=torch.float32, device=dev)
    table[0, :e_cap] = sorted_gid.to(torch.float32)   # exact: gid < 2^24
    table[1:1 + d, :e_cap] = sorted_data.T

    # per-block source window: start + live lane count
    t_idx = torch.clamp(block_tile, max=num_tiles - 1).long()
    ts_b = tile_starts[t_idx]
    as_b = aligned_starts[t_idx]
    cnt_b = tile_counts[t_idx]
    b_start = torch.arange(num_blocks, dtype=_I32, device=dev) * block
    src0 = ts_b + (b_start - as_b)
    live = block_tile < num_tiles
    block_valid = torch.where(
        live, torch.clamp(ts_b + cnt_b - src0, 0, block), 0
    ).to(_I32)
    block_src = torch.clamp(torch.where(live, src0, 0), 0, e_cap).to(_I32)
    return table, block_src, block_valid, block_tile, aligned_total


# chunk length of the two-level prefix sum (_prefix_sum)
_SCAN_CHUNK = 1024


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of x [D, A] along A, in x's dtype: a cumsum
    within chunks of _SCAN_CHUNK, plus the exclusive cumsum of the chunk
    totals.  Both are cumsums along the innermost dimension of a tensor of
    more than one row, which torch runs on CUDA as fixed-order block scans:
    a 1-D float cumsum there is a look-back scan whose rounding may change
    from run to run, and a cumsum along dim 0 of [A, D] is D threads walking
    A serially.

    A block scan adds in a tree whose shape depends on the position, so on
    CUDA the prefixes at the two ends of a run of zeros may differ in their
    last bit; a caller that needs such a difference to be exactly 0 masks
    it by a count of nonzeros (nonzero_prefix)."""
    d, a = x.shape
    k = max(-(-a // _SCAN_CHUNK), 1)
    xp = torch.nn.functional.pad(x, (0, k * _SCAN_CHUNK - a))
    local = torch.cumsum(xp.view(d, k, _SCAN_CHUNK), dim=2, dtype=x.dtype)
    carry = torch.nn.functional.pad(torch.cumsum(local[:, :-1, -1], dim=1, dtype=x.dtype),
                                    (1, 0))
    return (local + carry[:, :, None]).view(d, k * _SCAN_CHUNK)[:, :a]


def nonzero_prefix(x: torch.Tensor) -> torch.Tensor:
    """Zero-led inclusive count of the nonzero entries of x [D, A] along A,
    int32 [D, A + 1]: exact in any order of summation.  Chunked by
    _prefix_sum: on CUDA a cumsum along a few rows of millions of entries
    leaves most of the card idle."""
    return _prefix_sum(torch.nn.functional.pad((x != 0).to(torch.int32), (1, 0)))


def reduce_aligned_cotangents(d_rows: torch.Tensor, gid_aligned: torch.Tensor,
                              counts: torch.Tensor, n: int,
                              grad_reduce: str = "sortprefix",
                              packed_out: int = 0, row_chunk: int = 0) -> torch.Tensor:
    """Per-Gaussian sums of aligned-order cotangents d_rows [D, a_cap]
    (the deterministic replacement for the reference's per-field atomics,
    tiled_shaders.metal:698-736), the JAX ``reduce_aligned_cotangents``.
    Returns [N, D] in presorted order (D = ``packed_out`` when the rows are
    bf16 pairs of that many columns, which are unpacked after the gather by
    Gaussian id; the sums themselves see the unpacked values).

    The key is gid, or n for padding lanes, sorted stably; the payload rides
    by the permutation.  Gaussian g's pairs are then the contiguous run of
    counts[g] entries ending at cumsum(counts)[g], in aligned-lane order.
    No float atomics in either form:

    "sortprefix" (and "autodiff", which JAX's windowed path reduces the same
    way, pairs.py:553): a difference of the zero-led prefix sum at the run's
    two ends, taken in float64 and rounded once to d_rows' dtype.  In
    float32 (the JAX form) a small per-Gaussian sum read back as the
    difference of two prefixes over millions of lanes keeps only the digits
    the prefix has left: at 2^21 lanes of same-sign cotangents each column
    was 2.1e-3 off float64 in relative norm, in float64 it is within a
    rounding of it.  A Gaussian whose cotangents are all zero (behind every
    pixel's T-floor) gets exactly 0, on both devices: a count of the run's
    lanes with a nonzero cotangent (nonzero_prefix) zeroes the difference,
    which a block scan's rounding alone need not (see _prefix_sum).

    "scatter": each run summed on its own in float32, lane by lane in
    aligned order (torch.segment_reduce), which is the sum JAX's
    duplicate-index scatter-add takes (pairs.py:547-552).

    ``row_chunk`` > 0 (unpacked rows only) takes the sort-prefix form over
    that many rows at a time, sharing the one sort: the same sums, with the
    float64 prefix's working memory cut to the chunk's (the surfel's
    sixteen rows)."""
    if grad_reduce not in ("sortprefix", "autodiff", "scatter"):
        raise ValueError(f"grad_reduce must be 'sortprefix', 'autodiff' or 'scatter', "
                         f"got {grad_reduce!r}")
    key = torch.where(gid_aligned >= 0, gid_aligned, n)
    _, perm = torch.sort(key, stable=True)
    if row_chunk and grad_reduce != "scatter" and not packed_out:
        return torch.cat([_sortprefix_sums(d_rows[r:r + row_chunk, perm], counts)
                          for r in range(0, d_rows.shape[0], row_chunk)], dim=1)
    rows = d_rows[:, perm]
    if packed_out:
        rows = torch.stack(packing.unpack_cols(list(rows), packed_out))
    if grad_reduce == "scatter":
        # the padding lanes sort last; they go in segments of at most
        # _SCAN_CHUNK lanes, as one segment's lanes are summed by one CUDA
        # thread (and their count stays on the device: no sync).  The
        # lengths sum to the lanes by construction, so segment_reduce's
        # checks, which read them back to the host, are skipped (unsafe)
        chunks = torch.arange(-(-rows.shape[1] // _SCAN_CHUNK), device=counts.device)
        pad = rows.shape[1] - counts.sum()
        fill = (pad - chunks * _SCAN_CHUNK).clamp(0, _SCAN_CHUNK).to(counts.dtype)
        sums = torch.segment_reduce(rows.T.contiguous(), "sum",
                                    lengths=torch.cat([counts, fill]), axis=0, unsafe=True)
        return sums[:n].contiguous()
    return _sortprefix_sums(rows, counts)


def _sortprefix_sums(rows: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """reduce_aligned_cotangents' sort-prefix form on rows [D, a_cap]
    already sorted by Gaussian id: [N, D] in rows' dtype."""
    csum = _prefix_sum(torch.nn.functional.pad(rows, (1, 0)).to(torch.float64))
    nz = nonzero_prefix((rows != 0).any(0, keepdim=True))   # [1, a_cap + 1]
    ends = torch.cumsum(counts, 0)                      # [N] int64 run ends
    starts = ends - counts
    sums = torch.where(nz[:, ends] == nz[:, starts], 0.0, csum[:, ends] - csum[:, starts])
    return sums.T.to(rows.dtype, memory_format=torch.contiguous_format)
