"""The end-to-end numbers come from all requests of the window."""

import time

import torch

from gsbench.drivers import render
from gsbench import harness
from gsbench.tests import small


def test_percentile_is_nearest_rank_over_all_values():
    vals = list(range(100, 0, -1))
    assert render.percentile(vals, 0.95) == 95
    assert render.percentile(vals, 1.0) == 100
    assert render.percentile([7.0], 0.95) == 7.0
    assert render.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
                              1000], 0.95) == 19


def test_render_rate_and_tail_cover_every_frame():
    torch.set_num_threads(2)
    spec = harness.cell_spec(harness.manifest(harness.HERE.parent), "synth100k.render")
    cfg = harness.merged(harness.load_json("configs", spec["config"]), small.SYNTH["config"])
    traffic = harness.merged(harness.load_json("traffic", spec["traffic"]), small.SYNTH["traffic"])
    drv = render.Driver(cfg, traffic, 11, "cpu")
    drv.setup()
    stats = drv.window(0.5, time.perf_counter)
    assert stats["attempted"] == len(drv.latencies) == sum(drv.visits) >= 1
    assert stats["end_to_end"]["frames_per_s"] == stats["attempted"] / stats["window_s"]
    assert stats["end_to_end"]["frame_ms_p95"] == render.percentile(drv.latencies, 0.95)
    assert len(drv.sample) == min(traffic["sample_frames"], stats["attempted"])
