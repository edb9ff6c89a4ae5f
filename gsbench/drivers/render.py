"""The ``render`` driver: one viewer in a closed loop.

The configuration's scene module (``gsbench/scene/<scene.kind>.py``,
``render_inputs``) makes the Gaussians and the camera path from the seed.
The window drives ``graph.render_frame`` over the path, cycled: the next request goes out when the previous frame is in host memory
as uint8 (converted on the device, copied to pinned memory).  A frame's
latency runs from the request to that copy's end, timed with CUDA events
(recorded at the request, while the device is idle, and after the copy),
since a host clock read per frame would carry its own half millisecond.  A
frame fails if its image is not finite or
the frame overflowed the pair capacity.

Each pose's frame is copied to a pinned host buffer of its own, so the
last frame served for every pose of the path is kept as served at no cost
to the window; a sample drawn from the seed over every frame of the window
(a reservoir) is kept besides.  After the window both are compared with the
reference's frame of their pose, rendered once a pose.
"""

from __future__ import annotations

import importlib
import math
import random
import sys
import time

import torch

from gsbench import devtrace
from gsbench.drivers import port
from gsbench.reference import compare, raster


def percentile(values, q: float) -> float:
    """The nearest-rank ``q`` quantile of all ``values``."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def setup(self) -> None:
        from gaussiansplatting_tpu_torch.train import graph

        sc = self.cfg["scene"]
        scene = importlib.import_module(f"gsbench.scene.{sc['kind']}")
        self.arrays, self.poses = scene.render_inputs(self.cfg, self.traffic, self.seed,
                                                      self.device)
        self.rc = port.config(self.cfg["config"]).raster
        if "pair_capacity" in self.cfg.get("render", {}):
            self.rc = self.rc.replace(pair_capacity=int(self.cfg["render"]["pair_capacity"]))
        self.params = port.params(self.arrays)
        self.cams = [port.camera(p, self.device) for p in self.poses]
        self.host = [torch.empty((sc["height"], sc["width"], 3), dtype=torch.uint8,
                                 pin_memory=self.cuda) for _ in self.cams]
        self.flag = torch.empty((), dtype=torch.bool, pin_memory=self.cuda)
        pairs = []
        for cam in self.cams:          # every pose once: the capture and the path's work
            pairs.append(graph.render_frame(self.params, cam, self.rc)[1].num_pairs)
        port.sync(self.device)
        pairs = torch.stack(pairs)
        self.counters = {"pairs_min": int(pairs.min()), "pairs_max": int(pairs.max())}
        print(f"gsbench: pairs per frame {self.counters['pairs_min']} to "
              f"{self.counters['pairs_max']} (capacity {self.rc.pair_capacity})", file=sys.stderr)

    def _frame(self, i, spans):
        from gaussiansplatting_tpu_torch.train import graph

        with spans("gsbench.call"):
            img, aux = graph.render_frame(self.params, self.cams[i], self.rc)
        with spans("gsbench.readback"):
            u8 = torch.clamp(img * 255.0 + 0.5, 0, 255).to(torch.uint8)
            bad = aux.overflow | ~torch.isfinite(img).all()
            self.host[i].copy_(u8, non_blocking=True)
            self.flag.copy_(bad, non_blocking=True)

    def window(self, seconds: float, clock, spans=None) -> dict:
        """The measured window; ``spans`` (devtrace.Spans) records the
        host's spans in a traced run."""
        spans = spans or devtrace.Spans(False)
        keep = int(self.traffic["sample_frames"])
        rng = random.Random(self.seed)
        self.sample = []                       # [(frame index, pose index, uint8 frame)]
        lat, failed, n = [], 0, 0
        ev0 = torch.cuda.Event(enable_timing=True) if self.cuda else None
        ev1 = torch.cuda.Event(enable_timing=True) if self.cuda else None
        t0 = clock()
        while clock() - t0 < seconds:
            i = n % len(self.cams)
            if self.cuda:
                ev0.record()
            else:
                h0 = time.perf_counter()
            self._frame(i, spans)
            if self.cuda:
                ev1.record()
                with spans("gsbench.sync"):
                    ev1.synchronize()
                lat.append(ev0.elapsed_time(ev1))
            else:
                lat.append(1e3 * (time.perf_counter() - h0))
            failed += bool(self.flag)
            j = n if n < keep else rng.randrange(n + 1)
            if j < keep:
                item = (n, i, self.host[i].clone())
                if n < keep:
                    self.sample.append(item)
                else:
                    self.sample[j] = item
            n += 1
        t1 = clock()
        self.frames = n
        self.visits = [n // len(self.cams) + (i < n % len(self.cams))
                       for i in range(len(self.cams))]
        self.served = [(i, self.host[i]) for i, v in enumerate(self.visits) if v]
        self.served += [(i, f) for _, i, f in self.sample]
        self.latencies = lat
        return {"attempted": n, "failed": failed, "window_s": t1 - t0,
                "end_to_end": {"frame_ms_p95": percentile(lat, 0.95),
                               "frames_per_s": n / (t1 - t0)}}

    def release(self) -> None:
        from gaussiansplatting_tpu_torch.train import graph

        self.params = self.cams = None
        graph.clear()

    def _rc(self) -> dict:
        return raster.raster_constants(self.cfg["config"].get("raster", {}))

    def _images(self, prec=torch.float64) -> dict:
        """The reference's frame of each pose that a compared frame shows."""
        return {i: raster.render(self.arrays, self.poses[i], self._rc(), prec).image
                for i in sorted({i for i, _ in self.served})}

    def check(self) -> dict:
        self.refs = self._images()
        return compare.frame_readings([f for _, f in self.served],
                                      [self.refs[i] for i, _ in self.served])

    def control(self) -> dict:
        """The readings of the reference at the precision below the
        configuration's served in the program's place; after check()."""
        ctl = self._images(raster.control_precision(self.cfg["config"]))
        return compare.frame_readings([raster.to_uint8(ctl[i]) for i, _ in self.served],
                                      [self.refs[i] for i, _ in self.served])

    def work(self) -> dict:
        """Floors for the traced window: each pose's frame counted by the
        reference (float32) and charged once per visit."""
        from gsbench.work import floors

        frame_s = blend_s = 0.0
        pixels = self.poses[0]["width"] * self.poses[0]["height"]
        for pose, visits in zip(self.poses, self.visits):
            if not visits:
                continue
            fr = raster.render(self.arrays, pose, self._rc(), torch.float32)
            c = dict(live=fr.live, pairs=fr.pairs, tests=fr.tests, kept=fr.kept, pixels=pixels)
            frame_s += visits * floors.frame(c).seconds()
            blend_s += visits * floors.blend_fwd(c).seconds()
        return {"requests": self.frames, "floor_s": frame_s, "blend_floor_s": blend_s}
