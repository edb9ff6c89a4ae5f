"""The port's pair machinery (gaussiansplatting_tpu_torch.ops.pairs) against
the JAX package's windowed half of ops/pairs.py: capacity plan, expansion +
stable tile sort, tile runs and per-block windows.  Every integer output and
the table's gid row must be exactly equal."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gaussiansplatting_tpu.ops import pairs as jpairs

from gaussiansplatting_tpu_torch.ops import pairs as tpairs
from gaussiansplatting_tpu_torch.ops import projection as tproj

from torch_parity import (
    cameras, configs, jax_presorted_inputs, jax_windows, scene_params, t2n,
)

torch.set_num_threads(1)


def _to_port(proj_p):
    return tproj.Projected(**{
        f.name: torch.from_numpy(np.array(getattr(proj_p, f.name)))
        for f in dataclasses.fields(tproj.Projected)
    })


def _port_windows(jp, jc, jcfg, packed=False, pack_pos=False, tile_rows=None):
    """The port's plan and windows on the JAX-presorted projection (handed
    over as numpy, so the comparison isolates ops/pairs), with the bf16
    payload flags, of the strip ``tile_rows`` = (row0, n_rows)."""
    proj_p, data = jax_presorted_inputs(jp, jc, jcfg)
    tp = _to_port(proj_p)
    tiles_x = tproj.num_tiles(jc.width, jcfg.tile_size)
    row0, tiles_y = tile_rows or (0, tproj.num_tiles(jc.height, jcfg.tile_size))
    n = tp.depth.shape[0]
    plan = tpairs.capacity_plan(tp, tiles_x, tiles_y, jcfg.pair_capacity, row0)
    counts, ccounts, coffsets, ty_lo, span_x, _total, _ = plan
    pcfg = (n, jcfg.pair_capacity, tiles_x, tiles_y, jcfg.pair_block,
            tpairs._chunk_capacity(jcfg.pair_capacity, n), packed, pack_pos, jcfg.tile_size)
    windows = tpairs.pair_windows_fwd(
        torch.from_numpy(np.array(data)), row0, counts, ccounts, coffsets, ty_lo,
        tp.tile_min[:, 0], span_x, pcfg,
    )
    return plan, windows


def _assert_same(jax_out, port_out, names):
    for name, a, b in zip(names, jax_out, port_out):
        a, b = np.asarray(a), t2n(b)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        assert b.dtype == a.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=name)


PLAN = ("counts", "ccounts", "coffsets", "ty_lo", "span_x", "total", "overflow")
WINDOWS = ("table", "block_src", "block_valid", "block_tile", "aligned_total")


def _check(jp, jc, jcfg, expect_overflow=False):
    jplan, jwin, _ = jax_windows(jp, jc, jcfg)
    tplan, twin = _port_windows(jp, jc, jcfg)
    _assert_same(jplan, tplan, PLAN)
    assert bool(tplan[-1]) is expect_overflow
    # integer windows exactly; the table's gid row exactly (payload rows are
    # the same floats moved by the same permutation, so also exact)
    _assert_same(jwin, twin, WINDOWS)
    assert int(tplan[5]) > 0


@pytest.mark.parametrize("seed", [41, 42])
def test_windows_match_jax(seed):
    jp, _ = scene_params(seed, n=48)
    jc, _ = cameras()
    _check(jp, jc, configs()[0])


def test_windows_match_jax_on_overflow():
    """pair_capacity far below the frame's pairs: whole Gaussians drop in
    emission order (overflow=True) identically."""
    jp, _ = scene_params(43, n=64, spread=0.3)
    jc, _ = cameras()
    _check(jp, jc, configs(pair_capacity=96)[0], expect_overflow=True)


def test_windows_match_jax_with_culled_ties():
    """Most Gaussians culled (behind the camera or transparent): they all
    sort at depth 0, so the depth presort's large tie group must keep the
    JAX order (a stable argsort) for the windows to match."""
    rng = np.random.default_rng(44)
    jp, _ = scene_params(44, n=64)
    means = np.array(jp.means)
    raw_op = np.array(jp.raw_opacities)
    behind = rng.random(64) < 0.4
    means[behind, 2] = -means[behind, 2]          # behind the camera
    raw_op[rng.random(64) < 0.3] = -8.0           # below the pair floor
    jp = jp.replace(means=jnp.asarray(means), raw_opacities=jnp.asarray(raw_op))
    jc, _ = cameras()
    jcfg = configs()[0]
    proj_p, _ = jax_presorted_inputs(jp, jc, jcfg)
    assert int((np.asarray(proj_p.depth) == 0).sum()) >= 20
    _check(jp, jc, jcfg)


def test_render_presort_matches_jax_argsort():
    """The port's render presorts with torch.argsort(stable=True); on depth
    ties it must give jnp.argsort's order."""
    depth = np.random.default_rng(45).choice([0.0, 1.5, 2.0, 3.25], 257).astype(np.float32)
    np.testing.assert_array_equal(
        torch.argsort(torch.from_numpy(depth), stable=True).numpy(),
        np.asarray(jnp.argsort(jnp.asarray(depth))),
    )


def test_full_size_scene_pair_count_matches_jax():
    """The full-size workload (100k Gaussians, seed 0, canonical 800x608
    view, pair_capacity 2^21): both packages emit the same 1,666,075 pairs
    from the untrained scene — the count chip_smoke.py holds the card to."""
    from gaussiansplatting_tpu.config import RasterConfig as JRasterConfig
    from gaussiansplatting_tpu.ops import projection as jproj
    from gaussiansplatting_tpu.utils import synthetic as jsyn

    from gaussiansplatting_tpu_torch.config import RasterConfig
    from gaussiansplatting_tpu_torch.utils import synthetic as tsyn

    jcfg = JRasterConfig(pair_capacity=1 << 21, pair_block=128)
    jpr = jproj.project(jsyn.make_scene(100_000, seed=0),
                        jsyn.make_canonical_camera(800, 608), jcfg)
    jplan = jpairs.capacity_plan(jpr, 50, 38, 1 << 21, jnp.int32(0))
    with torch.no_grad():
        tpr = tproj.project(tsyn.make_scene(100_000, seed=0),
                            tsyn.make_canonical_camera(800, 608),
                            RasterConfig(pair_capacity=1 << 21, pair_block=128))
    tplan = tpairs.capacity_plan(tpr, 50, 38, 1 << 21, 0)
    np.testing.assert_array_equal(t2n(tpr.n_tiles), np.asarray(jpr.n_tiles))
    assert int(tplan[5]) == int(jplan[5]) == 1_666_075
    assert not bool(tplan[6]) and not bool(jplan[6])


@pytest.mark.parametrize("num_slots", [1, 7, 40])
def test_run_ids_matches_jax(num_slots):
    rng = np.random.default_rng(46 + num_slots)
    counts = rng.integers(0, 4, 12).astype(np.int32)
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    live = counts > 0
    want = jpairs._run_ids(jnp.asarray(starts), jnp.asarray(live), num_slots)
    got = tpairs._run_ids(torch.from_numpy(starts), torch.from_numpy(live), num_slots)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cap,n", [(2048, 48), (1 << 21, 100_000), (64, 1000)])
def test_capacities_match_jax(cap, n):
    assert tpairs._chunk_capacity(cap, n) == jpairs._chunk_capacity(cap, n)
    assert tpairs._chunk_capacity(cap, n, 0.5) == jpairs._chunk_capacity(cap, n, 0.5)
    assert tpairs.aligned_capacity(cap, 1900, 128) == jpairs.aligned_capacity(cap, 1900, 128)


def test_impact_drop_not_ported():
    """The impact drop is ported: without overflow its plan is JAX's (and
    the index plan); a policy neither package has is refused
    (tests/test_torch_packing.py forces the overflow)."""
    jp, _ = scene_params(47, n=8)
    jc, _ = cameras()
    jproj = jax_presorted_inputs(jp, jc, configs()[0])[0]
    tp = _to_port(jproj)
    got = tpairs.capacity_plan(tp, 4, 3, 2048, 0, overflow_drop="impact")
    _assert_same(jpairs.capacity_plan(jproj, 4, 3, 2048, jnp.int32(0), "impact"), got, PLAN)
    _assert_same(tpairs.capacity_plan(tp, 4, 3, 2048, 0), got, PLAN)
    with pytest.raises(ValueError, match="overflow_drop"):
        tpairs.capacity_plan(tp, 4, 3, 2048, 0, overflow_drop="depth")
