"""The ``train`` driver: a trainer's loop of optimizer steps.

On a configuration of one view (``scene.kind`` "synthetic") the window drives ``trainer.train_steps`` (``steps_per_call`` replays of the
captured step per call) on the configuration's canonical view against the
traffic's seeded random ground truths, one per step, cycled.  Every
``restore_every_steps`` steps it starts again from the state the set-up
handed over, so the work per step does not drift with how far a run
trained.  The set-up builds the state from the seed, drives it through its
first three steps through the same call (three different ground truths),
keeps what the check compares, and warms the window's call; the reference
follows those three steps after the window.

On a configuration of a posed dataset with a density schedule (its
``loop`` key) the window drives the trainer's loop itself
(``drivers/train_loop.py``).

A step fails if its loss is not finite or its frame overflowed the pair
capacity (``overflow``: pairs dropped).
"""

from __future__ import annotations

import sys

import torch

from gsbench import devtrace
from gsbench.drivers import port
from gsbench.reference import compare, raster
from gsbench.reference import train as rtrain
from gsbench.scene import synthetic

CHECKED_STEPS = 3


def half_batch_loss(img, gt, lc, prec):
    """A planted fault: the loss of the top half of the rows, the mean taken
    over them (the bottom half of the batch left out)."""
    h = img.shape[0] // 2
    rep = rtrain.photometric_loss(img[:h], gt[:h], lc, prec)
    return rtrain.LossReport(2.0 * rep.grad_loss, rep.combined_mean)


def Driver(cfg: dict, traffic: dict, seed: int, device):
    """The driver for this configuration."""
    if "loop" in cfg:
        from gsbench.drivers.train_loop import LoopDriver

        return LoopDriver(cfg, traffic, seed, device)
    return StepsDriver(cfg, traffic, seed, device)


class StepsDriver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.k = int(traffic["steps_per_call"])
        self.restore_calls = max(1, int(traffic["restore_every_steps"]) // self.k)

    def setup(self) -> None:
        from gaussiansplatting_tpu_torch.train import state as state_mod
        from gaussiansplatting_tpu_torch.train import trainer

        sc = self.cfg["scene"]
        g = synthetic.generator(self.seed, self.device)
        self.arrays = synthetic.make_scene(sc, g, self.device)
        self.pose = synthetic.canonical_pose(sc["width"], sc["height"])
        n_gt = int(self.traffic["ground_truths"])
        self.gts = torch.rand((n_gt, sc["height"], sc["width"], 3), generator=g,
                              device=self.device)
        self.pcfg = port.config(self.cfg["config"])
        self.total = int(self.cfg["total_iters"])
        cam = port.camera(self.pose, self.device)
        state = state_mod.create(port.params(self.arrays), seed=self.seed % (1 << 63))
        s1, m1 = trainer.train_steps(state, [cam], [self.gts[0]], self.pcfg, self.total)
        s3, m3 = trainer.train_steps(s1, [cam] * (CHECKED_STEPS - 1),
                                     list(self.gts[1:CHECKED_STEPS]), self.pcfg, self.total)
        beta1 = self.pcfg.optim.beta1
        self.checked = {
            "pairs": torch.cat([m1.num_pairs, m3.num_pairs]).tolist(),
            "losses": torch.cat([m1.loss, m3.loss]),
            "grad": {f: s1.opt.m[f] / (1.0 - beta1) for f in compare.LEAVES},
            "params": {f: getattr(s3.params, f).detach() for f in compare.LEAVES},
        }
        print(f"gsbench: checked steps' pairs {self.checked['pairs']} "
              f"(capacity {self.pcfg.raster.pair_capacity}), overflow "
              f"{torch.cat([m1.overflow, m3.overflow]).tolist()}", file=sys.stderr)
        self.start = s3
        self.cams = [cam] * self.k
        self.call_gts = [self.gts[i % n_gt] for i in range(self.k)]
        trainer.train_steps(self.start, self.cams, self.call_gts, self.pcfg, self.total)
        port.sync(self.device)

    def window(self, seconds: float, clock, spans=None) -> dict:
        """The measured window; ``spans`` (devtrace.Spans) records the
        host's spans in a traced run."""
        from gaussiansplatting_tpu_torch.train import trainer

        spans = spans or devtrace.Spans(False)
        losses, overflows = [], []
        calls, state = 0, self.start
        t0 = clock()
        while clock() - t0 < seconds:
            if calls % self.restore_calls == 0:
                state = self.start
            with spans("gsbench.call"):
                state, m = trainer.train_steps(state, self.cams, self.call_gts, self.pcfg,
                                               self.total)
            losses.append(m.loss)
            overflows.append(m.overflow)
            calls += 1
        with spans("gsbench.sync"):
            port.sync(self.device)
        t1 = clock()
        loss, ovf = torch.cat(losses), torch.cat(overflows)
        self.requests = calls * self.k
        failed = int((~torch.isfinite(loss) | ovf.bool()).sum())
        return {"attempted": self.requests, "failed": failed, "window_s": t1 - t0,
                "end_to_end": {"train_step_ms": 1e3 * (t1 - t0) / self.requests}}

    def release(self) -> None:
        from gaussiansplatting_tpu_torch.train import graph

        self.start = None
        graph.clear()

    def _reference(self, prec, loss_fn=None) -> dict:
        st = rtrain.init_state(self.arrays, prec)
        losses, grad, pairs = [], None, []
        for i in range(CHECKED_STEPS):
            out = rtrain.step(st, self.pose, self.gts[i], self.cfg["config"], self.total, loss_fn)
            losses.append(out.loss)
            pairs.append(out.frame.pairs)
            if i == 0:
                clip = rtrain.optim_constants(self.cfg["config"])["grad_clip"]
                grad = {f: out.grads[f].clamp(-clip, clip) for f in compare.LEAVES}
                self.counts = dict(live=out.frame.live, pairs=out.frame.pairs,
                                   tests=out.frame.tests, kept=out.frame.kept,
                                   pixels=self.pose["width"] * self.pose["height"])
            st = out.state
        return {"losses": losses, "grad": grad, "params": st.params, "pairs": pairs}

    def check(self) -> dict:
        """The readings of the program's first three steps."""
        prog = dict(self.checked, losses=[float(x) for x in self.checked["losses"]])
        self.ref = self._reference(torch.float64)
        print(f"gsbench: checked steps' pairs {prog['pairs']}, the reference's "
              f"{self.ref['pairs']}", file=sys.stderr)
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

    def work(self) -> dict:
        """Floors for the traced window: every step does the work of the
        checked first step (the window restarts from the set-up's state
        every restore_every_steps steps)."""
        from gsbench.work import floors

        n = self.requests
        return {"requests": n, "floor_s": n * floors.step(self.counts).seconds(),
                "blend_floor_s": n * (floors.blend_fwd(self.counts).seconds()
                                      + floors.blend_bwd(self.counts).seconds()),
                "counts": self.counts}
