"""The frozen yardstick: counts against brute force, independence from any
layout, and the idle share as a union of intervals."""

import itertools

import pytest
import torch

from gsbench import devtrace
from gsbench.reference import raster
from gsbench.scene import synthetic
from gsbench.work import floors


def _scene(n=120, w=40, h=28, seed=3):
    g = synthetic.generator(seed, "cpu")
    arrays = synthetic.make_scene({"gaussians": n, "spread": 0.6}, g, "cpu")
    return arrays, synthetic.canonical_pose(w, h)


def _brute(arrays, pose, rc):
    """Every (pixel, Gaussian) pair, float64: the power tests a pixel needs
    (its centre in the 3-sigma ellipse's box) and the kept terms."""
    pr = raster.project(arrays, pose, rc)
    tests = kept = 0
    for i in torch.nonzero(pr.emit).squeeze(1).tolist():
        sx, sy = pr.screen[i].tolist()
        ex, ey = pr.extent[i].tolist()
        a, b, c = pr.conic[i].tolist()
        op = float(pr.opacity[i])
        for py, px in itertools.product(range(pose["height"]), range(pose["width"])):
            dx, dy = px + 0.5 - sx, py + 0.5 - sy
            tests += abs(dx) <= ex and abs(dy) <= ey
            power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
            import math
            kept += (-4.5 <= power <= 0.0) and op * math.exp(power) >= 1.0 / 255.0
    return tests, kept


def test_counts_equal_brute_force():
    arrays, pose = _scene()
    rc = raster.raster_constants({})
    fr = raster.render(arrays, pose, rc)
    assert (fr.tests, fr.kept) == _brute(arrays, pose, rc)


@pytest.mark.parametrize("tile", [8, 16, 32])
def test_counts_do_not_depend_on_the_layout(tile):
    """Tiles of another size change the pairs (the layout), not the pixels'
    tests or kept terms."""
    arrays, pose = _scene(seed=5)
    base = raster.render(arrays, pose, raster.raster_constants({}))
    other = raster.render(arrays, pose, raster.raster_constants({"tile_size": tile}))
    assert (other.tests, other.kept) == (base.tests, base.kept)


def test_floors_are_the_larger_of_the_two_times():
    c = dict(live=1000, pairs=5000, tests=200000, kept=50000, pixels=10000)
    for w in (floors.frame(c), floors.step(c), floors.blend_fwd(c), floors.blend_bwd(c)):
        assert w.seconds() == max(w.ops / floors.F32_OPS_PER_S, w.bytes / floors.HBM_BYTES_PER_S)
    assert floors.step(c).seconds() > floors.frame(c).seconds() > floors.blend_fwd(c).seconds()


def _cap(device, spans=()):
    ev = [devtrace.Interval(n, s, e) for n, s, e in device]
    sp = [devtrace.Interval("gsbench.window", 0, 100)] + [devtrace.Interval(*x) for x in spans]
    return devtrace.Capture(ev, sp)


def test_overlapping_kernels_count_once():
    cap = _cap([("a", 10, 60), ("b", 20, 50), ("c", 40, 80), ("d", 90, 130)])
    busy = devtrace.busy_ns([(d.start, d.end) for d in cap.device], 0, 100)
    assert busy == 70 + 10
    assert 0 <= 1 - busy / 100 <= 1


def test_idle_never_below_zero():
    cap = _cap([("a", 0, 100), ("b", 0, 100), ("c", 50, 100)])
    assert devtrace.busy_ns([(d.start, d.end) for d in cap.device], 0, 100) == 100


def test_idle_gaps_charged_to_the_innermost_span():
    cap = _cap([("k", 10, 20), ("k", 60, 100)], spans=[("gsbench.call", 0, 50),
                                                       ("gsbench.sync", 15, 55)])
    gaps = dict(devtrace.idle_gaps(cap))
    assert gaps == pytest.approx({"gsbench.call": 10e-9, "gsbench.sync": 40e-9})
    ops = dict(devtrace.device_ops(cap))
    assert ops == pytest.approx({"k": 50e-9})
