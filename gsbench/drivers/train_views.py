"""The ``train_views`` driver: the second half of a published 3DGS run,
optimizer steps over a posed dataset's training views at SH degree 3.

The set-up first makes sure the system evaluates the configuration's SH
degree: its configuration parses, and its ``sh_eval`` at that degree agrees
with the reference's colour (reference/sh.py) on a few directions; a system
that cannot, or that falls back to a lower degree, stops here, within
seconds.  Then it makes the configuration's dataset from the seed (the
garden traced at the capture's resolution and rounded to 8 bits, every
``eval_split``-th view held out) and the state that a run holds at
``iterations.first``: ``scene.gaussians`` Gaussians on the garden's
surfaces, initialised as the trainer initialises an SfM cloud at capacity =
their count (no padding rows), the log-scales within the optimizer's clamp
(``optim.log_scale_clamp``), the SH bands above the DC drawn
N(0, ``scene.rest_sigma``^2), Adam's timestep at ``iterations.first`` (which
sets the position learning rate) and its moments zero.  It drives the first
three steps of the views' seeded order through ``trainer.train_steps``,
keeps what the check compares, and warms the window's call.

The window drives ``trainer.train_steps`` (``steps_per_call`` replays of the
captured step a call), one training view a step, the views in a permutation
drawn from the seed for each epoch (without replacement, as 3DGS draws
them), and every ``restore_every_steps`` steps starts again from the set-up's
state, so the work per step does not drift.  A step fails if its loss is not
finite, its frame overflowed the pair capacity, or it rendered below the
configured SH degree (the system's frames-by-degree counter,
``sh.degree_<d>``, read over the window).

The check compares the first three steps with the float64 reference from
the same state on the same three views: losses, the first step's clipped
gradients of the five leaves (every SH coefficient) and the parameters
after the third.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gsbench import devtrace
from gsbench.drivers import port
from gsbench.drivers.train import CHECKED_STEPS, half_batch_loss
from gsbench.reference import compare, raster
from gsbench.reference import sh as rsh
from gsbench.reference import train as rtrain
from gsbench.scene import garden


def check_sh_degree(cfg: dict) -> None:
    """Raise unless the system takes the configuration and evaluates its SH
    degree as the reference does (the colour of 64 seeded directions within
    1e-5)."""
    from gaussiansplatting_tpu_torch.core import transforms

    pcfg = port.config(cfg["config"])
    degree = pcfg.raster.sh_degree
    g = torch.Generator().manual_seed(1)
    sh = 0.3 * torch.randn((64, (degree + 1) ** 2, 3), generator=g, dtype=torch.float64)
    dirs = torch.randn((64, 3), generator=g, dtype=torch.float64)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    got = transforms.sh_eval(sh.float(), dirs.float(), degree).double()
    err = float((got - rsh.color(sh, dirs, degree)).abs().max())
    if not err < 1e-5:
        raise RuntimeError(f"gsbench: the system's SH colour at degree {degree} is "
                           f"{err:.3g} off the reference's: it does not evaluate this degree")


def view_order(seed: int, views: int, steps: int) -> list[int]:
    """``steps`` training views: a permutation of the ``views`` drawn from
    the seed per epoch, epochs back to back."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < steps:
        out += rng.permutation(views).tolist()
    return out[:steps]


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.k = int(traffic["steps_per_call"])
        self.restore_calls = max(1, int(traffic["restore_every_steps"]) // self.k)
        self.counters, self.spans = {}, {}

    def _dataset(self) -> None:
        sc = self.cfg["scene"]
        w, h = sc["width"], sc["height"]
        g = torch.Generator(device=self.device).manual_seed(self.seed % (1 << 63))
        poses = garden.ring_poses(sc["views"], np.random.default_rng(self.seed), w, h,
                                  sc.get("fov_deg", 60.0))
        train = [i for i in range(len(poses)) if i % sc["eval_split"]]
        tracer = garden.Tracer(w, h, poses[0]["fx"], poses[0]["fy"], self.device)
        # the dataset's PNGs hold 8 bits a channel
        self.gts = [torch.floor(torch.clamp(tracer(poses[i]), 0, 1) * 255.0 + 0.5) / 255.0
                    for i in train]
        tracer.close()
        self.poses = [poses[i] for i in train]
        n = int(sc["gaussians"])
        pts, cols = garden.surface_points(n, g, self.device)
        extent = garden.scene_extent(poses, self.cfg["config"]["init"]["extent_multiplier"])
        arrays = garden.initial_gaussians(pts, cols, extent, self.cfg["config"]["init"], n,
                                          capacity_factor=1.0)
        # a state the system holds in training: its Adam clamps log-scales to
        # +/-log_scale_clamp, and the median 3-NN distance of millions of
        # points lies below e^-4 (left so, the first step would lift every
        # scale to the clamp, and pairs would double after each restore)
        lim = float(self.cfg["config"]["optim"]["log_scale_clamp"])
        arrays["log_scales"].clamp_(-lim, lim)
        k = (self.cfg["config"]["raster"]["sh_degree"] + 1) ** 2
        sh = float(sc["rest_sigma"]) * torch.randn((n, k, 3), generator=g, device=self.device)
        sh[:, 0] = arrays["sh"][:, 0]
        arrays["sh"] = sh
        self.arrays = arrays

    def setup(self) -> None:
        from gaussiansplatting_tpu_torch.train import state as state_mod
        from gaussiansplatting_tpu_torch.train import trainer

        check_sh_degree(self.cfg)
        self.pcfg = port.config(self.cfg["config"])
        self._dataset()
        self.first = int(self.cfg["iterations"]["first"])
        self.total = int(self.cfg["total_iters"])
        self.cams = [port.camera(p, self.device) for p in self.poses]
        self.start = state_mod.create(port.params(self.arrays), seed=self.seed % (1 << 63))
        self.start.opt.t = self.first
        self.checked_views = view_order(self.seed, len(self.poses), CHECKED_STEPS)
        v = self.checked_views
        s1, m1 = trainer.train_steps(self.start, [self.cams[v[0]]], [self.gts[v[0]]], self.pcfg,
                                     self.total)
        s3, m3 = trainer.train_steps(s1, [self.cams[i] for i in v[1:]],
                                     [self.gts[i] for i in v[1:]], self.pcfg, self.total)
        beta1 = self.pcfg.optim.beta1
        self.checked = {
            "losses": torch.cat([m1.loss, m3.loss]),
            "grad": {f: s1.opt.m[f] / (1.0 - beta1) for f in compare.LEAVES},
            "params": {f: getattr(s3.params, f).detach() for f in compare.LEAVES},
        }
        print(f"gsbench: checked views {v}, pairs {torch.cat([m1.num_pairs, m3.num_pairs]).tolist()}"
              f" (capacity {self.pcfg.raster.pair_capacity}), overflow "
              f"{torch.cat([m1.overflow, m3.overflow]).tolist()}", file=sys.stderr)
        del s1, s3
        self.order = view_order(self.seed + 1, len(self.poses), 1 << 16)
        self.at = 0
        self._call(self.start)
        port.sync(self.device)

    def _call(self, state):
        from gaussiansplatting_tpu_torch.train import trainer

        views = [self.order[(self.at + i) % len(self.order)] for i in range(self.k)]
        self.at += self.k
        return trainer.train_steps(state, [self.cams[i] for i in views],
                                   [self.gts[i] for i in views], self.pcfg, self.total)

    def window(self, seconds: float, clock, spans=None) -> dict:
        """The measured window; ``spans`` (devtrace.Spans) records the
        host's spans in a traced run."""
        from gaussiansplatting_tpu_torch.train import graph

        spans = spans or devtrace.Spans(False)
        degree = self.pcfg.raster.sh_degree
        key = f"sh.degree_{degree}"
        losses, overflows = [], []
        calls, state = 0, self.start
        before = graph.launch_counts().get(key, 0)
        t0 = clock()
        while clock() - t0 < seconds:
            if calls % self.restore_calls == 0:
                state = self.start
            with spans("gsbench.call"):
                state, m = self._call(state)
            losses.append(m.loss)
            overflows.append(m.overflow)
            calls += 1
        with spans("gsbench.sync"):
            port.sync(self.device)
        t1 = clock()
        loss, ovf = torch.cat(losses), torch.cat(overflows)
        self.requests = calls * self.k
        at_degree = graph.launch_counts().get(key, 0) - before
        self.counters.update(steps=self.requests, steps_at_degree=at_degree)
        failed = int((~torch.isfinite(loss) | ovf.bool()).sum()) + max(0, self.requests - at_degree)
        return {"attempted": self.requests, "failed": min(failed, self.requests),
                "window_s": t1 - t0,
                "end_to_end": {"train_step_ms": 1e3 * (t1 - t0) / self.requests}}

    def release(self) -> None:
        from gaussiansplatting_tpu_torch.train import graph

        self.start = None
        graph.clear()

    def _reference(self, prec, loss_fn=None, degree=None) -> dict:
        degree = self.pcfg.raster.sh_degree if degree is None else degree
        st = rtrain.init_state(self.arrays, prec)._replace(t=self.first)
        losses, grad = [], None
        for i, v in enumerate(self.checked_views):
            out = rsh.step(st, self.poses[v], self.gts[v], self.cfg["config"], self.total, degree,
                           loss_fn)
            losses.append(out.loss)
            if i == 0:
                clip = rtrain.optim_constants(self.cfg["config"])["grad_clip"]
                grad = {f: out.grads[f].clamp(-clip, clip) for f in compare.LEAVES}
            st = out.state
        return {"losses": losses, "grad": grad, "params": st.params}

    def check(self) -> dict:
        """The readings of the program's first three steps."""
        prog = dict(self.checked, losses=[float(x) for x in self.checked["losses"]])
        self.ref = self._reference(torch.float64)
        return compare.train_readings(prog, self.ref, self.arrays)

    def control(self) -> dict:
        """The readings of the reference at the precision below the
        configuration's in the program's place; after check()."""
        prec = raster.control_precision(self.cfg["config"])
        return compare.train_readings(self._reference(prec), self.ref, self.arrays)

    def fault_half_batch(self) -> dict:
        """The readings of the reference with half of the batch left out."""
        return compare.train_readings(self._reference(torch.float64, half_batch_loss),
                                      self.ref, self.arrays)

    def fault_bands(self) -> dict:
        """The readings of the reference with the SH bands above 1 left out
        (degree 1 in the program's place)."""
        return compare.train_readings(self._reference(torch.float64, degree=1), self.ref,
                                      self.arrays)

    def work(self) -> dict:
        return {"requests": self.requests}
